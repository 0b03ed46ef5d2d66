"""Graph-parallel models for :func:`dig_tpu_torch.parallel.gp.make_gp_engine`.
Port of ``dig_tpu/parallel/gp_models.py``.

Each module's contract is ``forward(x, g: GPLocalGraph, halo_fn)`` where
``x`` is the local node slab ``[C, F]`` and ``halo_fn(h) -> [H, F]``
fetches the boundary rows of any per-node array from the neighbouring
ranks (one all_to_all a call). Aggregations read the local slab for edges
whose sender is owned (``sender < C``) and the halo rows for the others
(``sender - C``), the split the JAX package keeps so the local sum does
not depend on the exchange; each layer issues its exchange before its
local sum.

The neighbour sums run through the sorted-CSR segment sum
(``ops.segment_csr``: the kernel on the card, its plain version on the
CPU), where the JAX package calls ``jax.ops.segment_sum``: the same sums
in another order. Each part's edges are laid out once
(:func:`gp_plans`): per edge set (local, halo, all) the edges in a stable
order of their receivers and the tables of the gather by sender, so a sum
is a row gather (``ops.segment.gather_rows``, whose adjoint is the CSR sum
by sender) times its per-edge factor, summed by receiver. A gradient
reaches the factor (the GCN norm, SchNet's filters) through that product.
GPPNA's max and min stay ``scatter_reduce`` (``ops.segment``), as the JAX
ones are plain XLA.

Models: GPGCN, GPGCN2 (GCNII), GPPNA and GPSchNet (flat molecular SchNet
over a partitioned atom graph: positions are exchanged once, per-layer
node features every interaction). Layers are built at construction
(``in_dim`` given), weights drawn from ``generator`` (Glorot-uniform
kernels, zero biases).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..nn.blocks import MLP, shifted_softplus
from ..nn.init import xavier_uniform
from ..ops.basis import cosine_cutoff, gaussian_rbf
from ..ops.segment import (GatherPlan, gather_rows, segment_max,
                           segment_min)
from ..ops.segment_csr import full_window, segment_sum_sorted_csr
from .gp import GPLocalGraph


def _dense(in_dim: int, out_dim: int, gen: torch.Generator,
           bias: bool = True) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    xavier_uniform(lin.weight, gen)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class EdgeSet(NamedTuple):
    """Edges of one part in a stable order of their receivers, the masked
    ones (``real`` False, receiver id -1) last. ``senders``: the rows the
    edges read (clamped into the source array), ``receivers`` their
    receivers (masked edges keep theirs, for the extrema), ``recv_ids``
    and ``rowptr`` the CSR sum's ids and row pointer over the part's
    ``C`` rows, ``count`` the real edges a receiver. ``plans`` caches the
    ``gather_rows`` plan of the senders by source size."""

    senders: torch.Tensor
    receivers: torch.Tensor
    recv_ids: torch.Tensor
    rowptr: torch.Tensor
    real: torch.Tensor
    count: torch.Tensor
    num_real: int
    plans: Dict[int, GatherPlan]


@torch.no_grad()
def edge_set(senders: torch.Tensor, receivers: torch.Tensor,
             mask: torch.Tensor, C: int, compact: bool) -> EdgeSet:
    """The :class:`EdgeSet` of the edges ``senders -> receivers`` (already
    clamped into the source array) under ``mask``; ``compact`` drops the
    masked edges."""
    if compact:
        senders, receivers = senders[mask], receivers[mask]
        mask = mask[mask]
    key = torch.where(mask, receivers, C)
    perm = torch.argsort(key, stable=True)
    key = key[perm]
    real = key < C
    rowptr = torch.searchsorted(
        key, torch.arange(C + 1, device=key.device), out_int32=True)
    return EdgeSet(senders=senders[perm], receivers=receivers[perm],
                   recv_ids=torch.where(real, key, -1).to(torch.int32),
                   rowptr=rowptr, real=real,
                   count=(rowptr[1:] - rowptr[:-1]).float(),
                   num_real=int(real.sum()), plans={})


def _send_plan(es: EdgeSet, num_src: int) -> GatherPlan:
    plan = es.plans.get(num_src)
    if plan is None:
        with torch.no_grad():
            skey = torch.where(es.real, es.senders, num_src)
            order = torch.argsort(skey, stable=True)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(order.shape[0], device=order.device)
            skey = skey[order]
            plan = GatherPlan(
                order, inv,
                torch.where(skey < num_src, skey, -1).to(torch.int32),
                torch.searchsorted(
                    skey, torch.arange(num_src + 1, device=skey.device),
                    out_int32=True))
        es.plans[num_src] = plan
    return plan


class GPPlans(NamedTuple):
    """A part's edge sets: ``local`` (owned senders, compacted), ``halo``
    (halo senders, as rows of the halo buffer, compacted) and ``full``
    (every edge slot, senders into ``[C + H)``, masked slots last)."""

    local: EdgeSet
    halo: EdgeSet
    full: EdgeSet


@torch.no_grad()
def gp_plans(g: GPLocalGraph) -> GPPlans:
    """The :class:`GPPlans` of ``g`` (on its device)."""
    C = g.num_local
    s, r, m = g.senders.long(), g.receivers.long(), g.edge_mask
    is_local = s < C
    return GPPlans(
        local=edge_set(torch.clamp(s, 0, C - 1), r, m & is_local, C, True),
        halo=edge_set(torch.clamp(s - C, min=0), r, m & ~is_local, C, True),
        full=edge_set(s, r, m, C, False))


def _plans(g: GPLocalGraph) -> GPPlans:
    return g.plans if g.plans is not None else gp_plans(g)


def edge_sum(src: torch.Tensor, es: EdgeSet,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[r] = sum over es's real edges e -> r of scale[e] * src[
    senders[e]]`` -> ``[C, F]`` (``scale`` per edge in ``es``'s order,
    ``[E]`` or ``[E, F]``; None: 1), through ``gather_rows`` and the
    sorted-CSR sum. An empty set sums to zeros, with ``src`` kept in the
    graph (so its exchange's adjoint runs on every rank)."""
    C = es.rowptr.shape[0] - 1
    if es.num_real == 0:
        return (torch.zeros((C,) + tuple(src.shape[1:]), dtype=src.dtype,
                            device=src.device) + src[:0].sum(0))
    msgs = gather_rows(src, es.senders, _send_plan(es, src.shape[0]))
    if scale is not None:
        msgs = msgs * (scale[:, None] if scale.ndim == 1 else scale)
    return segment_sum_sorted_csr(msgs, es.recv_ids, es.rowptr, C, 32,
                                  full_window(msgs.shape[0])).to(src.dtype)


def overlapped_gather(h, halo_fn, g: GPLocalGraph, scale=None):
    """Edge-message sum split into local (sender < C) and halo (sender >=
    C) edges, the exchange issued first and the local sum independent of
    it. Returns ``agg [C, F]``. ``scale``: ``(scale_local, scale_halo)``,
    per-edge factors in the order of the plans' ``local`` and ``halo``
    sets (e.g. the GCN norm of :func:`_gcn_norm`)."""
    halo = halo_fn(h)
    p = _plans(g)
    sl, sh = scale if scale is not None else (None, None)
    agg = edge_sum(h, p.local, sl)
    return agg + edge_sum(halo, p.halo, sh)


@torch.no_grad()
def _gcn_norm(g: GPLocalGraph, halo_fn):
    """GCN normalization split into (local, halo) per-edge tensors in the
    plans' orders, and the self coefficient ``1 / deg_in``. In-degree is
    complete locally (edges live on the receiver's part); out-degree is
    the precomputed global count, halo rows fetched once."""
    p = _plans(g)
    deg_in = p.full.count + 1.0
    do_own = torch.rsqrt(g.deg_out + 1.0)
    do_halo = halo_fn(do_own[:, None])[:, 0]
    di = torch.rsqrt(deg_in)
    coef_l = di[p.local.receivers] * do_own[p.local.senders]
    coef_h = di[p.halo.receivers] * do_halo[p.halo.senders]
    return (coef_l, coef_h), di * di


class GPGCN(nn.Module):
    """Partitioned multi-layer GCN (mean-normalized aggregation)."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dims = [in_dim, *features]
        self.lins = nn.ModuleList(_dense(a, b, gen)
                                  for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, g: GPLocalGraph, halo_fn):
        deg = _plans(g).full.count + 1.0
        h = x
        for li, lin in enumerate(self.lins):
            agg = overlapped_gather(h, halo_fn, g)
            h = lin((agg + h) / deg[:, None])
            if li < len(self.lins) - 1:
                h = torch.relu(h)
        return h


class GPGCN2(nn.Module):
    """Partitioned GCNII (initial residual + identity mapping)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int, alpha: float = 0.1, beta: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.alpha, self.beta = alpha, beta
        self.lin_in = _dense(in_dim, hidden, gen)
        self.convs = nn.ModuleList(_dense(hidden, hidden, gen, bias=False)
                                   for _ in range(num_layers))
        self.lin_out = _dense(hidden, out_dim, gen)

    def forward(self, x, g: GPLocalGraph, halo_fn):
        h = torch.relu(self.lin_in(x))
        h0 = h
        coef, self_coef = _gcn_norm(g, halo_fn)
        for conv in self.convs:
            agg = overlapped_gather(h, halo_fn, g, scale=coef) \
                + self_coef[:, None] * h
            z = (1 - self.alpha) * agg + self.alpha * h0
            h = torch.relu((1 - self.beta) * z + self.beta * conv(z))
        return self.lin_out(h)


class GPPNA(nn.Module):
    """Partitioned Principal Neighborhood Aggregation, in the concat form
    (halo rows gathered with the local ones before aggregating): the
    means through the sorted-CSR sum over every edge slot, max and min by
    ``scatter_reduce`` with the JAX identities (a masked slot counts as
    -1e30 / +1e30)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int, avg_deg_log: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.avg_deg_log = avg_deg_log
        dims = [in_dim] + [hidden] * num_layers
        self.lins = nn.ModuleList(_dense(13 * a, hidden, gen)
                                  for a in dims[:-1])
        self.lin_out = _dense(hidden, out_dim, gen)

    def forward(self, x, g: GPLocalGraph, halo_fn):
        C = g.num_local
        full = _plans(g).full
        cnt = torch.clamp(full.count, min=1.0)[:, None]
        amp = (torch.log(full.count + 1.0) / self.avg_deg_log)[:, None]
        att = 1.0 / torch.clamp(amp, min=1e-2)
        h = x
        for li, lin in enumerate(self.lins):
            feats = torch.cat([h, halo_fn(h)], dim=0)
            msgs = gather_rows(feats, full.senders,
                               _send_plan(full, feats.shape[0]))
            window = full_window(msgs.shape[0])
            mean = segment_sum_sorted_csr(msgs, full.recv_ids, full.rowptr,
                                          C, 32, window) / cnt
            mx = segment_max(msgs, full.receivers, C, mask=full.real)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            mn = segment_min(msgs, full.receivers, C, mask=full.real)
            mn = torch.where(torch.isfinite(mn), mn, 0.0)
            sq = segment_sum_sorted_csr(msgs * msgs, full.recv_ids,
                                        full.rowptr, C, 32, window) / cnt
            std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-10))
            parts = []
            for agg in (mean, mx, mn, std):
                parts += [agg, agg * amp, agg * att]
            h = lin(torch.cat(parts + [h], dim=-1))
            if li < len(self.lins) - 1:
                h = torch.relu(h)
        return self.lin_out(h)


class _GPSchNetLayer(nn.Module):
    def __init__(self, hidden: int, filters: int, gaussians: int,
                 gen: torch.Generator):
        super().__init__()
        self.lin_vj = _dense(hidden, filters, gen, bias=False)
        self.mlp = MLP(gaussians, [filters, filters], act=shifted_softplus,
                       generator=gen)
        self.lin1 = _dense(filters, hidden, gen)
        self.lin2 = _dense(hidden, hidden, gen)


class GPSchNet(nn.Module):
    """Flat SchNet over a partitioned atom graph.

    The input slab is ``[C, 4]``: column 0 the atomic number (as float),
    columns 1:4 the positions. Edges must connect atoms within the cutoff
    (build them with the partitioner on a host-computed radius graph).
    Returns per-node energy contributions ``[C, 1]``. Each interaction
    sums its filtered messages twice (local and halo edges) through the
    sorted-CSR sum."""

    def __init__(self, cutoff: float = 5.0, num_layers: int = 3,
                 hidden_channels: int = 64, num_filters: int = 64,
                 num_gaussians: int = 25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.cutoff, self.num_gaussians = cutoff, num_gaussians
        self.embedding = nn.Embedding(100, hidden_channels)
        with torch.no_grad():   # flax Embed init: U[0, sqrt(3))
            self.embedding.weight.uniform_(0.0, math.sqrt(3.0),
                                           generator=gen)
        self.layers = nn.ModuleList(
            _GPSchNetLayer(hidden_channels, num_filters, num_gaussians, gen)
            for _ in range(num_layers))
        self.out1 = _dense(hidden_channels, hidden_channels // 2, gen)
        self.out2 = _dense(hidden_channels // 2, 1, gen)

    def _filters(self, d):
        rbf = gaussian_rbf(d, 0.0, self.cutoff, self.num_gaussians)
        gate = cosine_cutoff(d, self.cutoff) * (d < self.cutoff).to(d.dtype)
        return rbf, gate

    def forward(self, x, g: GPLocalGraph, halo_fn):
        p = _plans(g)
        z = x[:, 0].long()
        pos = x[:, 1:4]
        # positions are exchanged once; the local edges' geometry uses
        # owned positions only
        pos_halo = halo_fn(pos)
        d_l = torch.linalg.norm(pos[p.local.senders] - pos[p.local.receivers]
                                + 1e-9, dim=-1)
        d_h = torch.linalg.norm(pos_halo[p.halo.senders]
                                - pos[p.halo.receivers] + 1e-9, dim=-1)
        rbf_l, gate_l = self._filters(d_l)
        rbf_h, gate_h = self._filters(d_h)
        node = g.node_mask[:, None]
        v = torch.where(node, self.embedding(z), 0.0)
        for layer in self.layers:
            vj = layer.lin_vj(v)
            vj_halo = halo_fn(vj)       # issued before the local sum
            agg = edge_sum(vj, p.local, layer.mlp(rbf_l) * gate_l[:, None])
            agg = agg + edge_sum(vj_halo, p.halo,
                                 layer.mlp(rbf_h) * gate_h[:, None])
            out = layer.lin2(shifted_softplus(layer.lin1(agg)))
            v = v + torch.where(node, out, 0.0)
        h = self.out2(shifted_softplus(self.out1(v)))
        return torch.where(node, h, 0.0)
