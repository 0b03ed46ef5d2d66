"""Tensor parallelism over a 2-D ``(data, model)`` mesh. Port of
``dig_tpu/parallel/tp.py`` on ``torch.distributed``.

The JAX package shards every parameter whose last (feature) axis divides
by the ``model`` axis size and lets GSPMD tile the products inside the
step. The port's models run through hand-written kernels that no sharding
rule knows, so it shards *storage* by the same rule (:func:`tp_param_specs`,
same ``min_shard``): each rank of the ``model`` group keeps one column
shard of each such parameter and its optimizer state; the step all-gathers
the full parameters (in autograd) before the forward, and the gradient
reaches each shard by the gather's adjoint (a reduce-scatter, divided by
the group size: every rank of a ``model`` group computes the same
forward on the same data slab). Gradients and loss sums are then summed
over ``data`` as in :mod:`dig_tpu_torch.parallel.dp`.

That is the same function as the JAX step with 1/M of the parameters and
optimizer state a rank. It is a deliberate deviation from activation-
sharded TP: the products are not split, each rank computes them whole.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from . import comm
from .dp import dp_loss_step


def _feature_axis(model: nn.Module, name: str, p: torch.Tensor) -> int:
    """The dimension of ``p`` that is the flax tree's last axis: the output
    features of an ``nn.Linear`` weight ``[out, in]`` (flax ``[in,
    out]``), else the last."""
    owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else model
    if isinstance(owner, nn.Linear) and name.endswith("weight"):
        return 0
    return p.ndim - 1


def tp_param_specs(model: nn.Module, mesh, model_axis: str = "model",
                   min_shard: int = 4) -> Dict[str, Optional[int]]:
    """``{parameter name: dimension to shard or None}``: the feature axis
    (flax's last) of every parameter whose size there divides by the
    ``model_axis`` size with at least ``min_shard`` columns a rank; the
    rest replicated."""
    size = mesh.size(mesh.mesh_dim_names.index(model_axis))
    out = {}
    for name, p in model.named_parameters():
        ax = _feature_axis(model, name, p) if p.ndim >= 1 else None
        ok = (ax is not None and p.shape[ax] % size == 0
              and p.shape[ax] // size >= min_shard)
        out[name] = ax if ok else None
    return out


class TPSharded(nn.Module):
    """``module`` with its shardable parameters held as this rank's column
    shards (``shards``); the module keeps its replicated parameters. Its
    forward all-gathers the full parameters over the ``model`` group and
    calls ``module`` with them (``torch.func.functional_call``)."""

    def __init__(self, module: nn.Module, specs: Dict[str, Optional[int]],
                 group, size: int, rank: int):
        super().__init__()
        self.module = module
        self.axes = {n: a for n, a in specs.items() if a is not None}
        self.group, self.size = group, size
        self.shards = nn.ParameterDict()
        with torch.no_grad():
            for name, p in module.named_parameters():
                ax = self.axes.get(name)
                if ax is None:
                    continue
                self.shards[name.replace(".", "/")] = nn.Parameter(
                    p.detach().chunk(size, ax)[rank].clone())
                # the full tensor is gathered for each step
                p.requires_grad_(False)
                p.data = p.data.new_empty(0)

    def full_parameters(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name, ax in self.axes.items():
            s = self.shards[name.replace(".", "/")]
            parts = comm.all_gather(s, self.group)          # [M, ...]
            out[name] = torch.cat(list(parts.unbind(0)), dim=ax)
        return out

    def forward(self, *args, **kwargs):
        return functional_call(self.module, self.full_parameters(), args,
                               kwargs)


def tp_shard(model: nn.Module, mesh, model_axis: str = "model",
             min_shard: int = 4) -> TPSharded:
    """Column-shard ``model``'s parameters over ``model_axis``
    (:func:`tp_param_specs`); replicated over every other mesh dimension.
    Build the optimizer over the returned module's parameters."""
    specs = tp_param_specs(model, mesh, model_axis, min_shard)
    return TPSharded(model, specs, mesh.get_group(model_axis),
                     mesh.size(mesh.mesh_dim_names.index(model_axis)),
                     mesh.get_local_rank(model_axis))


def make_tp_train_step(model: TPSharded, optimizer, mesh, *,
                       data_axis: str = "data", model_axis: str = "model",
                       loss_fn: Optional[Callable] = None,
                       energy_and_force: bool = False, p: float = 100.0,
                       target_key: str = "y"):
    """2-D (DP x TP) train step ``train_step(g) -> aux`` over this rank's
    data slab ``g`` (:func:`~dig_tpu_torch.parallel.mesh.
    shard_graph_batch` along ``data_axis``). ``model`` from
    :func:`tp_shard`. The loss is the DP step's
    (:func:`~dig_tpu_torch.parallel.dp.make_dp_train_step`): a TP run
    reproduces the DP run up to summation order."""
    err = loss_fn or torch.abs
    group = mesh.get_group(data_axis)
    params = [q for q in model.parameters() if q.requires_grad]
    sharded = {id(q) for q in model.shards.values()}

    def train_step(g) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        aux = dp_loss_step(model, params, g, group, err=err,
                           energy_and_force=energy_and_force, p=p,
                           target_key=target_key)
        for q in params:
            if id(q) in sharded:
                # the reduce-scatter summed the model group's identical
                # gradients
                q.grad.div_(model.size)
        optimizer.step()
        return aux

    return train_step


def make_tp_eval_step(model: TPSharded, mesh, *, data_axis: str = "data"):
    """``eval_step(g) -> (predictions, graph_mask)`` of this rank's slab."""

    @torch.no_grad()
    def eval_step(g):
        return model(g), g.graph_mask

    return eval_step
