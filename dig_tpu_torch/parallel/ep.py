"""Expert parallelism: Switch-style top-1 MoE layer over an ``expert`` mesh
dimension. Port of ``dig_tpu/parallel/ep.py`` on ``torch.distributed``.

Each rank owns ``num_experts / P`` expert MLPs; tokens are gated top-1 and
shipped to their expert's rank with ONE all_to_all, processed, and shipped
back with a second (:func:`~dig_tpu_torch.parallel.comm.all_to_all`, whose
adjoint is the same exchange of the cotangents), with a static per-rank
capacity bound:

* dispatch buffers are ``[P, capacity, F]``; tokens beyond an expert's
  capacity are DROPPED (their output rows are 0: combine them with a
  residual path) and counted;
* position-in-buffer is a cumulative-sum rank over the one-hot
  destination matrix (sort-free).

:func:`moe_dense_reference` computes the same function without the mesh
(every expert applied to every token, one-hot gated) — the parity oracle.
Activations are ``gelu`` with the tanh approximation (``jax.nn.gelu``'s
default).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from . import comm


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def init_moe_params(generator, num_experts: int, d_in: int, d_hidden: int,
                    d_out: int, device=None) -> Dict[str, torch.Tensor]:
    """Expert MLPs (2-layer, gelu) + gating matrix, stacked on a leading
    expert axis so the expert dim shards over the mesh: normal draws at
    the JAX package's scales from ``generator`` (a ``torch.Generator`` or
    an int seed), where the JAX function takes a key."""
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator().manual_seed(int(generator)))
    s1 = (2.0 / (d_in + d_hidden)) ** 0.5
    s2 = (2.0 / (d_hidden + d_out)) ** 0.5
    n = lambda *s: torch.randn(s, generator=gen)
    p = {"w1": s1 * n(num_experts, d_in, d_hidden),
         "b1": torch.zeros(num_experts, d_hidden),
         "w2": s2 * n(num_experts, d_hidden, d_out),
         "b2": torch.zeros(num_experts, d_out),
         "wg": 0.02 * n(d_in, num_experts)}
    return {k: v.to(device) for k, v in p.items()}


def _expert_mlp(p_local, x):
    """x [E_local, C*, F_in] -> [E_local, C*, F_out] (batched over the
    local expert axis)."""
    h = _gelu(torch.einsum("ecf,efh->ech", x, p_local["w1"])
              + p_local["b1"][:, None, :])
    return (torch.einsum("ech,eho->eco", h, p_local["w2"])
            + p_local["b2"][:, None, :])


def moe_dense_reference(params, x):
    """Oracle: every expert on every token, one-hot top-1 gated, no
    capacity bound."""
    logits = x @ params["wg"]                        # [B, E]
    exp = torch.argmax(logits, dim=-1)
    gate = torch.softmax(logits, dim=-1)
    gval = torch.gather(gate, 1, exp[:, None])[:, 0]
    h = _gelu(torch.einsum("bf,efh->ebh", x, params["w1"])
              + params["b1"][:, None, :])
    y = (torch.einsum("ebh,eho->ebo", h, params["w2"])
         + params["b2"][:, None, :])                 # [E, B, O]
    sel = y[exp, torch.arange(x.shape[0], device=x.device)]
    return sel * gval[:, None]


def make_ep_moe(mesh, num_experts: int, capacity: int, *,
                axis: str = "expert") -> Callable:
    """Returns ``apply(params, x) -> (y, dropped)``.

    ``params`` this rank's experts (:func:`ep_shard_params`); ``x [b, F]``
    this rank's tokens. ``capacity``: max tokens a single expert accepts
    *from one source rank* per step. ``dropped`` is the global number of
    capacity-overflow tokens (their output rows are 0)."""
    group = mesh.get_group(axis)
    nd = mesh.size(mesh.mesh_dim_names.index(axis))
    if num_experts % nd:
        raise ValueError(f"{num_experts} experts do not divide over {nd} "
                         f"ranks")
    e_local = num_experts // nd

    def apply(params, x):
        b, Fin = x.shape
        logits = x @ params["wg"]                    # wg replicated [F, E]
        exp = torch.argmax(logits, dim=-1)           # [b] global expert id
        gate = torch.softmax(logits, dim=-1)
        gval = torch.gather(gate, 1, exp[:, None])[:, 0]

        # rank of each token within its expert's queue (sort-free)
        onehot = F.one_hot(exp, num_experts)         # [b, E]
        rank = torch.cumsum(onehot, dim=0) - 1
        pos = torch.gather(rank, 1, exp[:, None])[:, 0]
        keep = pos < capacity
        dropped = torch.sum(~keep).to(torch.int64).reshape(1)

        # dispatch buffer [E, capacity, F], destination-major
        e_idx = torch.where(keep, exp, 0)
        p_idx = torch.where(keep, pos, 0)
        val = torch.where(keep[:, None], x, 0.0)
        buf = torch.zeros((num_experts, capacity, Fin), dtype=x.dtype,
                          device=x.device)
        buf = buf.index_put((e_idx, p_idx), val, accumulate=True)
        buf = buf.reshape(nd, e_local * capacity, Fin)
        recv = comm.all_to_all(buf, group)
        # recv [P_src, e_local * capacity, F]: tokens sent TO my experts
        recv = recv.reshape(nd, e_local, capacity, Fin).transpose(0, 1)
        recv = recv.reshape(e_local, nd * capacity, Fin)
        out = _expert_mlp(params, recv)              # [e_local, P*C, O]
        O = out.shape[-1]
        out = out.reshape(e_local, nd, capacity, O).transpose(0, 1)
        out = out.reshape(nd, e_local * capacity, O)
        back = comm.all_to_all(out, group)
        back = back.reshape(num_experts, capacity, O)
        y = back[e_idx, p_idx]                       # [b, O]
        y = torch.where(keep[:, None], y, 0.0) * gval[:, None]
        comm.all_reduce_(dropped, group)
        return y, dropped[0]

    return apply


def ep_shard_params(params: Dict[str, torch.Tensor], mesh,
                    axis: str = "expert") -> Dict[str, torch.Tensor]:
    """This rank's experts (a contiguous slice of the leading expert axis)
    and the whole gating matrix, as leaf tensors that require
    gradients."""
    nd = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v)
        if k != "wg":
            per = v.shape[0] // nd
            v = v[r * per:(r + 1) * per]
        out[k] = v.detach().clone().requires_grad_()
    return out
