"""Segment reductions. Port of ``dig_tpu/ops/segment.py``, with the
port's repeatable readout and row gather.

Static output sizes; an optional ``mask`` over the data rows makes
masked rows contribute the identity. Indices must be in range (padding
convention: index 0 with a False mask).

``segment_sum`` is ``index_add_``. On CUDA that adds with atomics in an
order that changes from run to run, so its result is NOT bitwise
repeatable there (the JAX package's TPU scatter-add is); on the CPU it
is. The models therefore sum through the sorted-CSR kernel
(``ops.segment_csr``), whose sums are bitwise repeatable on the card at
every derivative order: ``segment_sum_sorted`` (the flat edge->node sum
with ``segment_eb > 0``), :func:`readout_sum` (the per-graph readout) and
:func:`gather_rows` (row gathers whose adjoint is such a sum). The NK
layout aggregates edges by a reshape-sum
(``ops.triplets.edges_to_nodes_nk``). :func:`spmm_bidir_csr` runs both of
its directions through the same kernel; :func:`spmm_bidir_sell` both of
its directions through SELL plans (``ops.sell``, plain PyTorch, as the JAX
one is plain XLA).

The other reductions (mean, max, min, softmax, normalize, argmin) are
plain PyTorch (``index_add_`` and ``scatter_reduce``), as the JAX ones are
plain XLA. They keep the JAX identities: a masked row holds -1e30 (max)
or +1e30 (min), a segment with no row at all -inf or +inf, and the
gradient of a max or min is split evenly among the rows that attain it
(the initial value included when it does), as JAX's scatter extrema split
theirs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .segment_csr import (_RowGather, _SegmentSumSortedCSR, full_window,
                          segment_sum_sorted_csr)
from .sell import SellPlan, sell_sum

_NEG_INF = -1e30
_POS_INF = 1e30


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor],
                fill: float) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return torch.where(m, data, fill)


class _Permute(torch.autograd.Function):
    """``x[perm]`` for a permutation ``perm`` of the rows, whose inverse is
    ``inv``. Adjoint: the same Function with the two swapped (a gather,
    so every derivative order is free of atomics)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(perm, inv)
        return x[perm]

    @staticmethod
    def backward(ctx, ct):
        perm, inv = ctx.saved_tensors
        return _Permute.apply(ct, inv, perm), None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor,
                 inv: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a permutation ``perm`` of ``x``'s rows with inverse
    ``inv``, differentiable to any order through gathers alone."""
    return _Permute.apply(x, perm, inv)


class GatherPlan(NamedTuple):
    """The tables of :func:`gather_rows` for one index tensor: ``order``
    sorts the flat indices stably, ``inv`` is its inverse, ``ids`` the
    sorted indices (int32) and ``rowptr`` their row pointer over
    ``num_rows`` rows."""

    order: torch.Tensor
    inv: torch.Tensor
    ids: torch.Tensor
    rowptr: torch.Tensor


@torch.no_grad()
def gather_plan(idx: torch.Tensor, num_rows: int) -> GatherPlan:
    """The :class:`GatherPlan` of ``idx`` (any shape, every index in
    ``[0, num_rows)``): one stable sort and one search, on the device."""
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    ids = flat[order].to(torch.int32)
    rowptr = torch.searchsorted(
        ids, torch.arange(num_rows + 1, dtype=torch.int32, device=ids.device),
        out_int32=True)
    return GatherPlan(order, inv, ids, rowptr)


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """``x[idx]`` for an index tensor of any shape (every index in
    ``[0, x.shape[0])``), differentiable to any order with a bitwise
    repeatable adjoint: the indices are stably sorted, the rows gathered in
    that order (``_RowGather``, whose adjoint is the sorted-CSR sum: the
    kernel on the card) and put back in the index order by a permutation
    (:class:`_Permute`). (The adjoint of ``index_select`` is
    ``index_add_``, which adds with atomics on the card.) ``plan``: the
    :func:`gather_plan` of ``idx`` over ``x``'s rows, built once where the
    same indices gather again (else built here)."""
    N = x.shape[0]
    if plan is None:
        plan = gather_plan(idx, N)
    rows = _RowGather.apply(x.reshape(N, -1), plan.ids, plan.rowptr, N, 32,
                            full_window(plan.ids.shape[0]), x.dtype)
    out = _Permute.apply(rows, plan.inv, plan.order)
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = sum of data rows with segment id s`` -> ``[num_segments,
    ...]`` in ``data``'s dtype."""
    data = _apply_mask(data, mask, 0.0)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: Optional[torch.Tensor] = None,
                       max_edges_per_block: int = 1024,
                       block_rows: int = 32,
                       rowptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment sum for ids sorted over the unmasked rows (masked rows and a
    masked tail allowed) through :func:`segment_sum_sorted_csr`, in
    ``data``'s dtype. On a CUDA tensor that is the kernel, or an error; on
    the CPU its plain version (where the JAX function takes
    ``jax.ops.segment_sum``: the same sum for sorted ids). Unsorted ids give
    a wrong sum on both, as in the JAX package.

    Masked rows get id -1 for the sum and are parked at ``num_segments``
    for the search that recovers ``rowptr`` ([num_segments + 1]) when it is
    not given. ``max_edges_per_block`` must cover the densest
    ``block_rows`` rows plus up to 127 alignment slack (the TPU kernel's
    window; the card path raises otherwise).
    """
    ids = segment_ids.to(torch.int32)
    if mask is not None:
        data = _apply_mask(data, mask, 0.0)
        ids_sort = torch.where(mask, ids, num_segments)
        ids = torch.where(mask, ids, -1)
    else:
        ids_sort = ids
    if rowptr is None:
        rowptr = torch.searchsorted(
            ids_sort, torch.arange(num_segments + 1, dtype=torch.int32,
                                   device=ids.device),
            side="left", out_int32=True)
    return segment_sum_sorted_csr(data, ids, rowptr, num_segments, block_rows,
                                  max_edges_per_block).to(data.dtype)


def readout_sum(data: torch.Tensor, node_graph: torch.Tensor,
                num_graphs: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Per-graph sum of the real node rows (the JAX models'
    ``segment_sum(v, node_graph, G, mask=node_mask)``) through the
    sorted-CSR sum, in ``data``'s dtype: bitwise repeatable on the card, the
    plain version on the CPU.

    The graph ids of the real rows must be non-decreasing, as every loader
    of the package lays them out (``graph.batch_np``). Padding rows may sit
    anywhere, also inside a graph's slot of a slot-aligned batch, where they
    carry the last graph's id: the row pointer comes from the running
    maximum of the masked ids, never from ``node_graph`` as it stands. The
    window holds all rows, so there is no overflow to check."""
    with torch.no_grad():
        ids = torch.where(node_mask, node_graph.long(), -1)
        key = torch.cummax(ids, dim=0).values
        rowptr = torch.searchsorted(
            key, torch.arange(num_graphs + 1, device=key.device),
            out_int32=True)
    data = _apply_mask(data, node_mask, 0.0)
    return segment_sum_sorted_csr(data, ids.to(torch.int32), rowptr,
                                  num_graphs, 32,
                                  full_window(data.shape[0])).to(data.dtype)


def flat_edges_to_nodes(data: torch.Tensor, receivers: torch.Tensor,
                        num_nodes: int, edge_mask: torch.Tensor,
                        segment_eb: int) -> torch.Tensor:
    """Edge->node sum of a flat edge list (receivers ascending over the real
    edges, as ``adjacency_to_edges`` emits them): through the sorted-CSR
    sum with ``segment_eb`` edges per block of 32 rows when ``segment_eb >
    0``, else ``index_add_`` (the JAX models' ``segment_eb`` switch)."""
    if segment_eb > 0:
        return segment_sum_sorted(data, receivers, num_nodes, mask=edge_mask,
                                  max_edges_per_block=segment_eb)
    return segment_sum(data, receivers, num_nodes, mask=edge_mask)


def _count(segment_ids: torch.Tensor, num_segments: int,
           mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0.0)
    return segment_sum(ones, segment_ids, num_segments)


def _per_row(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of each segment's (unmasked) rows; 0 for an empty segment."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    cnt = torch.clamp(_count(segment_ids, num_segments, mask, data.dtype),
                      min=1.0)
    return s / _per_row(cnt, s.ndim)


def _segment_extremum(data, segment_ids, num_segments, mask, fill, reduce):
    data = _apply_mask(data, mask, fill)
    init = -torch.inf if reduce == "amax" else torch.inf
    out = torch.full((num_segments,) + tuple(data.shape[1:]), init,
                     dtype=data.dtype, device=data.device)
    idx = _per_row(segment_ids.long(), data.ndim).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce, include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment maximum; masked rows count as -1e30, an empty segment is
    -inf."""
    return _segment_extremum(data, segment_ids, num_segments, mask,
                             _NEG_INF, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment minimum; masked rows count as +1e30, an empty segment is
    +inf."""
    return _segment_extremum(data, segment_ids, num_segments, mask,
                             _POS_INF, "amin")


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within segments: the segment's max (0 for
    a segment with no unmasked row) is subtracted, masked rows get 0, the
    denominator is floored at 1e-16."""
    mx = segment_max(logits, segment_ids, num_segments, mask)
    mx = torch.where(mx <= _NEG_INF / 2, 0.0, mx)
    ids = segment_ids.long()
    ex = torch.exp(logits - mx[ids])
    if mask is not None:
        ex = torch.where(_per_row(mask, ex.ndim), ex, 0.0)
    denom = torch.clamp(segment_sum(ex, segment_ids, num_segments),
                        min=1e-16)
    return ex / denom[ids]


def segment_normalize(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int,
                      mask: Optional[torch.Tensor] = None,
                      eps: float = 1e-16) -> torch.Tensor:
    """Each row divided by its segment's sum (plus ``eps``)."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    return data / (s[segment_ids.long()] + eps)


def segment_argmin(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 index of the first row at each segment's minimum (masked rows
    count as +1e30); 0 for an empty segment."""
    d = _apply_mask(data, mask, _POS_INF)
    ids = segment_ids.long()
    m = segment_min(d, segment_ids, num_segments)
    E = data.shape[0]
    ar = torch.arange(E, device=data.device)
    idx = torch.where(d <= m[ids], ar, E)
    out = torch.full((num_segments,), E, dtype=torch.long,
                     device=data.device)
    out = out.scatter_reduce(0, ids, idx, "amin", include_self=True)
    return torch.where(out >= E, 0, out).to(torch.int32)


class _SpmmBidirCSR(torch.autograd.Function):
    """``out[r] = sum_e coef[e] * h[senders[e]]`` over the receiver-sorted
    CSR, float32 summed, in ``h``'s dtype. Adjoint: the cotangent rows
    ``ct[recv] * coef`` (zeros on padding), permuted into sender order by
    ``rev_perm`` and summed over the sender CSR: the same kernel, no
    scatter. ``coef`` is a constant (no gradient)."""

    @staticmethod
    def forward(ctx, h, coef, senders, recv_ids, rowptr, rev_perm,
                send_ids_sorted, rowptr_rev, num_rows, eb, block_rows):
        ctx.save_for_backward(coef, recv_ids, rev_perm, send_ids_sorted,
                              rowptr_rev)
        ctx.meta = (num_rows, eb, block_rows)
        msg = h[senders.long()] * coef[:, None]
        return _SegmentSumSortedCSR.apply(msg, recv_ids, rowptr, num_rows,
                                          block_rows, eb).to(h.dtype)

    @staticmethod
    def backward(ctx, ct):
        coef, recv_ids, rev_perm, send_ids_sorted, rowptr_rev = \
            ctx.saved_tensors
        num_rows, eb, block_rows = ctx.meta
        recv = recv_ids.long()
        d_msg = ct[torch.clamp(recv, min=0)] * coef[:, None].to(ct.dtype)
        d_msg = torch.where((recv >= 0)[:, None], d_msg, 0)
        d_h = _SegmentSumSortedCSR.apply(d_msg[rev_perm.long()],
                                         send_ids_sorted, rowptr_rev,
                                         num_rows, block_rows, eb)
        return (d_h.to(ct.dtype),) + (None,) * 10


def spmm_bidir_csr(h: torch.Tensor, coef: torch.Tensor,
                   senders: torch.Tensor, recv_ids: torch.Tensor,
                   rowptr: torch.Tensor, rev_perm: torch.Tensor,
                   send_ids_sorted: torch.Tensor, rowptr_rev: torch.Tensor,
                   num_rows: int, max_edges_per_block: int = 1024,
                   block_rows: int = 32) -> torch.Tensor:
    """Normalized-adjacency SpMM through the sorted-CSR sum in both
    directions: ``out[r] = sum_e coef[e] * h[senders[e]]``, the edges
    receiver-sorted (``recv_ids`` -1 on padding, ``rowptr [num_rows +
    1]``). The caller gives the reverse tables: ``rev_perm`` sorts the
    edges by sender (padding last), ``send_ids_sorted = senders[rev_perm]``
    (-1 on padding), ``rowptr_rev`` the sender row pointer. ``coef`` is a
    constant (GCN degree norms): no gradient reaches it. On a CUDA tensor
    both directions launch the kernel or raise (``max_edges_per_block`` as
    in :func:`segment_sum_sorted`)."""
    return _SpmmBidirCSR.apply(h, coef.detach(), senders, recv_ids, rowptr,
                               rev_perm, send_ids_sorted, rowptr_rev,
                               num_rows, max_edges_per_block, block_rows)


def _check_sell_layout(coef, senders, recv_ids, plan_fwd, rev_perm,
                       plan_rev) -> None:
    """Raise unless the edges are what :func:`spmm_bidir_sell` assumes (the
    JAX function assumes it silently): the first ``plan_fwd.num_edges``
    edges in the receiver-sorted CSR order of ``plan_fwd`` and the rest
    padding (``recv_ids`` -1) with zero ``coef``; ``rev_perm`` puts the
    real edges in the sender-sorted order of ``plan_rev``. One host
    synchronisation."""
    n = plan_fwd.num_edges
    if (plan_rev.num_edges != n or recv_ids.shape[0] < n
            or rev_perm.shape != recv_ids.shape):
        raise ValueError(f"spmm_bidir_sell: {recv_ids.shape[0]} edges, plans "
                         f"of {n} and {plan_rev.num_edges}")
    recv = recv_ids.long()
    rows = plan_fwd.row_order[plan_fwd.edge_row_out]
    send_rows = plan_rev.row_order[plan_rev.edge_row_out]
    pad = recv < 0
    ok = torch.stack([
        (recv[:n] == rows).all(),
        pad[n:].all(),
        (torch.where(pad, coef, 0.0) == 0).all(),
        (senders.long()[rev_perm[:n].long()] == send_rows).all()])
    if not bool(ok.all()):
        names = ("real edges in the receiver-sorted order of plan_fwd",
                 "recv_ids -1 past plan_fwd.num_edges",
                 "zero coef on padding edges",
                 "rev_perm into the sender-sorted order of plan_rev")
        bad = [m for m, v in zip(names, ok.tolist()) if not v]
        raise ValueError(f"spmm_bidir_sell: the edges break its layout: "
                         f"{bad}")


class _SpmmBidirSell(torch.autograd.Function):
    """``out[r] = sum_e coef[e] * h[senders[e]]`` through ``plan_fwd``, float32
    summed, in ``h``'s dtype. Adjoint: the cotangent rows ``ct[recv] * coef``
    (zeros on padding), permuted into sender order by ``rev_perm`` and
    summed through ``plan_rev``. ``coef`` is a constant."""

    @staticmethod
    def forward(ctx, h, coef, senders, recv_ids, plan_fwd, rev_perm,
                plan_rev):
        ctx.save_for_backward(coef, recv_ids, rev_perm)
        ctx.plan_rev = plan_rev
        msg = h[senders.long()] * coef[:, None]
        return plan_fwd.unpermute(sell_sum(msg, plan_fwd)).to(h.dtype)

    @staticmethod
    def backward(ctx, ct):
        coef, recv_ids, rev_perm = ctx.saved_tensors
        plan_rev = ctx.plan_rev
        recv = recv_ids.long()
        d_msg = ct[torch.clamp(recv, min=0)] * coef[:, None].to(ct.dtype)
        d_msg = torch.where((recv >= 0)[:, None], d_msg, 0)
        d_h = plan_rev.unpermute(sell_sum(d_msg[rev_perm.long()], plan_rev))
        return (d_h.to(ct.dtype),) + (None,) * 6


def spmm_bidir_sell(h: torch.Tensor, coef: torch.Tensor,
                    senders: torch.Tensor, recv_ids: torch.Tensor,
                    plan_fwd: SellPlan, rev_perm: torch.Tensor,
                    plan_rev: SellPlan) -> torch.Tensor:
    """Normalized-adjacency SpMM through SELL plans in both directions:
    ``out[r] = sum_e coef[e] * h[senders[e]]``.

    The forward aggregates by receiver through ``plan_fwd``
    (:func:`~dig_tpu_torch.ops.sell.build_sell_plan` of the receiver
    rowptr); the adjoint wrt ``h`` rides ``plan_rev`` (of the sender
    rowptr) on the ``rev_perm``-sorted cotangent rows: no scatter in
    either direction. ``coef`` is a constant (GCN degree norms). Plain
    PyTorch on every device. Raises unless the edges are laid out as it
    assumes: the real edges first, in receiver-sorted CSR order, the
    padding edges after them with ``recv_ids`` -1 and zero ``coef``, and
    ``rev_perm`` sorting the real edges by sender.
    """
    coef = coef.detach()
    _check_sell_layout(coef, senders, recv_ids, plan_fwd, rev_perm, plan_rev)
    return _SpmmBidirSell.apply(h, coef, senders, recv_ids, plan_fwd,
                                rev_perm, plan_rev)
