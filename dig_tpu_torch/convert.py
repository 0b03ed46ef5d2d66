"""Load parameter trees of the JAX package into the port's modules.

Parameters arrive as a flat ``{name: numpy array}`` dict, the names being
the flax tree's paths joined by ``/`` (``flax.traverse_util.flatten_dict(
params["params"], sep="/")``), so this module needs no JAX. Flax ``Dense``
kernels are ``[in, out]`` and are transposed into ``nn.Linear.weight``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.schnet_dense import SchNetDense
from .models.spherenet import _SphericalMPNN


@torch.no_grad()
def schnet_dense_from_flax(params: Dict[str, np.ndarray],
                           model: SchNetDense) -> SchNetDense:
    """Copy a flax ``SchNetDense`` tree into ``model`` so both compute the
    same function. Takes either branch's tree: ``cf_w1_l``/``cf_b1_l``/
    ``cf_w2_l``/``cf_b2_l`` (``use_pallas=True``) or ``MLP_l/Dense_{0,1}``
    (the einsum branch); both land in the interaction's filter MLP. Every
    entry must be used and every parameter of ``model`` set."""
    todo = dict(params)

    def take(name):
        if name not in todo:
            raise KeyError(f"flax tree lacks {name!r}")
        return torch.tensor(np.asarray(todo.pop(name), np.float32))

    def put(dst: torch.Tensor, src: torch.Tensor):
        if dst.shape != src.shape:
            raise ValueError(f"shape {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    def dense(lin, idx):
        put(lin.weight, take(f"Dense_{idx}/kernel").T)
        if lin.bias is not None:
            put(lin.bias, take(f"Dense_{idx}/bias"))

    put(model.embedding.weight, take("Embed_0/embedding"))
    L = len(model.interactions)
    for l, layer in enumerate(model.interactions):
        dense(layer.lin_vj, 3 * l)
        dense(layer.lin1, 3 * l + 1)
        dense(layer.lin2, 3 * l + 2)
        m1, m2 = layer.mlp.layers
        if f"cf_w1_{l}" in todo:
            put(m1.weight, take(f"cf_w1_{l}").T)
            put(m1.bias, take(f"cf_b1_{l}"))
            put(m2.weight, take(f"cf_w2_{l}").T)
            put(m2.bias, take(f"cf_b2_{l}"))
        else:
            for lin, k in ((m1, 0), (m2, 1)):
                put(lin.weight, take(f"MLP_{l}/Dense_{k}/kernel").T)
                put(lin.bias, take(f"MLP_{l}/Dense_{k}/bias"))
    dense(model.out1, 3 * L)
    dense(model.out2, 3 * L + 1)
    if todo:
        raise KeyError(f"unused flax entries: {sorted(todo)}")
    return model


@torch.no_grad()
def spherenet_from_flax(params: Dict[str, np.ndarray],
                        model: _SphericalMPNN) -> _SphericalMPNN:
    """Copy a flax ``SphereNet`` / ``DimeNetPP`` tree into ``model``.

    The fused (slot) and unfused branches share parameter names in flax,
    so one tree loads into either branch. Dense kernels are transposed,
    ``DistEmb_0/freq`` and the ``Embed`` table copied. Every entry must be
    used and every parameter of ``model`` set."""
    todo = dict(params)
    done = set()

    def take(name):
        if name not in todo:
            raise KeyError(f"flax tree lacks {name!r}")
        return torch.tensor(np.asarray(todo.pop(name), np.float32))

    def put(dst: torch.Tensor, src: torch.Tensor):
        if dst.shape != src.shape:
            raise ValueError(f"shape {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
        done.add(id(dst))

    def denses(prefix, lins):
        for i, lin in enumerate(lins):
            put(lin.weight, take(f"{prefix}Dense_{i}/kernel").T)
            if lin.bias is not None:
                put(lin.bias, take(f"{prefix}Dense_{i}/bias"))

    put(model.dist_emb.freq, take("DistEmb_0/freq"))
    put(model.init_block.embed.weight, take("InitBlock_0/Embed_0/embedding"))
    denses("InitBlock_0/", model.init_block.flax_denses())
    for i, uv in enumerate(model.update_vs):
        denses(f"UpdateV_{i}/", uv.flax_denses())
    for l, ue in enumerate(model.update_es):
        denses(f"UpdateE_{l}/", ue.flax_denses())
        for r, res in enumerate([*ue.before, *ue.after]):
            denses(f"UpdateE_{l}/ResidualLayer_{r}/", res.flax_denses())
    if todo:
        raise KeyError(f"unused flax entries: {sorted(todo)}")
    unset = [n for n, p in model.named_parameters() if id(p) not in done]
    if unset:
        raise KeyError(f"parameters not set from the flax tree: {unset}")
    return model
