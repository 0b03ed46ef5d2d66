"""Sorted-CSR segment sum: the flat layout's edge->node aggregation. Port of
``segment_sum_sorted_csr``, ``csr_block_overflow``,
``segment_sum_sorted_csr_chunked`` (with ``plan_chunks`` and
``choose_chunk_plan``) and ``spmm_csr`` of ``dig_tpu/ops/pallas_segment.py``.

    out[r] = sum of data[e] over e in [rowptr[r], rowptr[r+1]) with seg[e] == r

``data [E, F]`` (float32 or bf16), ``seg [E]`` int32 ascending over the real
edges (-1 marks padding), ``rowptr [num_rows + 1]`` -> ``[num_rows, F]``
float32. On a CUDA tensor the sum launches the hand-written kernels of
``csrc/segment_csr.cu`` or raises; on a CPU tensor it runs the plain
version :func:`segment_sum_sorted_csr_reference`. The card balances the
work by edges: the edge range is cut into fixed slices of
:func:`slice_edges` edges (128 at F >= 8, more below: 1,024 at F = 1); a
row of at most that many edges is summed whole by one warp in edge order,
a longer row slice by slice (``segment_csr_piece_kernel``) and its pieces
then added in slice order (``segment_csr_row_kernel``, which also sums
the short rows); that needs ``rowptr`` non-decreasing, as a row pointer
is. Every row's sum has one order, so two runs give the same bits.
``launches`` counts calls, one per sum (each runs one or two kernels).

Deliberate deviation from the TPU kernel: that kernel reads a window of
``max_edges_per_block`` edges for each block of ``block_rows`` rows and
drops the edges that do not fit (:func:`csr_block_overflow` counts them).
The card kernel walks ``rowptr`` and drops nothing. ``block_rows`` and
``max_edges_per_block`` keep their JAX meaning: the card path computes
:func:`csr_block_overflow` and raises unless it is 0, so both compute the
same sum. A window of at least ``E + 127`` edges (:func:`full_window`)
holds every block's edges whatever the row pointer, so the overflow is 0
by construction and the card path skips the check and its host
synchronisation.

The derivative is a closed pair of ``torch.autograd.Function``s. The VJP
of the sum is the row gather ``ct[seg]`` with zeros at id -1 (the JAX
``_ss_bwd``), cast to ``data``'s type; the VJP of that gather is the same
CSR sum, since the ids are sorted. So every derivative order of the
aggregation is a gather or a CSR sum: no scatter-add, and every sum the
kernel takes is bit-repeatable. Both members are exact when the ids are
sorted and ``rowptr`` is their row pointer (what ``segment_sum_sorted``
builds).

The chunked sum (:func:`segment_sum_sorted_csr_chunked`) takes the chunk
table ``meta [3, C]`` of :func:`plan_chunks` in place of ``rowptr``: each
block of ``block_rows`` rows sums the edges of its windows of
``chunk_edges`` edges whose id falls in the block, and the windows tile the
block's edges, so nothing is dropped. On a CUDA tensor it runs the kernels
of the same source, or raises: ``segment_csr_span_kernel`` finds each
row's first and last window edge (integer atomic minima and maxima, a
thread per window position), then the segment sum's own two kernels sum
each row over that span (the same bits as the segment sum);
``launches_chunked`` counts calls, one per sum. On a CPU tensor it runs
its plain version. Its VJP is the row gather of ``_ssc_bwd``
(:func:`row_gather`). :func:`spmm_csr` is ``x[col] * val`` summed per CSR
row through :func:`segment_sum_sorted_csr`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

launches = 0
launches_chunked = 0

_SHAPES = "negative size"


def reset_launch_counts() -> None:
    global launches, launches_chunked
    launches = 0
    launches_chunked = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def full_window(num_edges: int) -> int:
    """The least ``max_edges_per_block`` that holds every block's edges for
    any row pointer over ``num_edges`` edges (its 128-aligned start is at
    most 127 edges early): :func:`csr_block_overflow` is then 0."""
    return num_edges + 127


def csr_window(rowptrs, block_rows: int) -> int:
    """A ``max_edges_per_block`` sized from the data, as ``bench.py``
    ``bench_lsgraph`` sizes it: the most edges any block of ``block_rows``
    rows holds over the row pointers ``rowptrs`` (numpy), plus 128 of
    alignment slack, rounded up to 128; :func:`csr_block_overflow` is then
    0 for each."""
    need = 0
    for rp in rowptrs:
        rp = np.asarray(rp, np.int64)
        starts = np.arange(0, rp.shape[0] - 1, block_rows)
        ends = np.minimum(starts + block_rows, rp.shape[0] - 1)
        need = max(need, int((rp[ends] - rp[starts]).max(initial=0)))
    return _round_up(need + 128, 128)


def csr_block_overflow(rowptr: torch.Tensor, num_rows: int, block_rows: int,
                       max_edges_per_block: int) -> torch.Tensor:
    """Edges the TPU kernel would drop (0 == safe): per block of
    ``block_rows`` rows its window holds ``max_edges_per_block - (start %
    128)`` of the block's own edges (the window starts 128-aligned)."""
    nb = _round_up(num_rows, block_rows) // block_rows
    rp = rowptr.long()
    pad = nb * block_rows + 1 - rp.shape[0]
    if pad > 0:
        rp = torch.cat([rp, rp[-1:].expand(pad)])
    starts = rp[::block_rows][:nb]
    ends = rp[::block_rows][1:nb + 1]
    start_al = (starts // 128) * 128
    kept = torch.minimum(
        torch.clamp(start_al + max_edges_per_block - starts, min=0),
        ends - starts)
    return torch.sum((ends - starts) - kept)


def segment_sum_sorted_csr_reference(data: torch.Tensor, seg_ids: torch.Tensor,
                                     rowptr: torch.Tensor,
                                     num_rows: int) -> torch.Tensor:
    """Plain version of the kernel, with its membership rule: edge e counts
    for row r = seg[e] when 0 <= r < num_rows and rowptr[r] <= e <
    rowptr[r+1]. Sums in float32."""
    E, F = data.shape
    e = torch.arange(E, device=data.device)
    seg = seg_ids.long()
    rp = rowptr.long()
    ok = (seg >= 0) & (seg < num_rows)
    s = torch.where(ok, seg, 0)
    take = ok & (rp[s] <= e) & (e < rp[s + 1])
    out = torch.zeros((num_rows, F), dtype=torch.float32, device=data.device)
    return out.index_add_(0, s, torch.where(take[:, None], data.float(), 0.0))


def row_gather(u: torch.Tensor, seg_ids: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """``u[seg]`` with zeros where seg < 0 (ids clipped to the rows, as the
    JAX ``_ss_bwd``)."""
    safe = torch.clamp(seg_ids.long(), 0, num_rows - 1)
    return torch.where((seg_ids >= 0)[:, None], u[safe], 0.0)


def _library() -> ctypes.CDLL:
    lib = _build.load("segment_csr")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.segment_csr_fwd.argtypes = [P] * 6 + [I] * 4 + [P]
        lib.segment_csr_fwd.restype = I
        lib.segment_csr_chunked_fwd.argtypes = [P] * 7 + [I] * 7 + [P]
        lib.segment_csr_chunked_fwd.restype = I
        lib.segment_csr_slice_edges.argtypes = [I]
        lib.segment_csr_slice_edges.restype = I
        lib._argtypes_set = True
    return lib


def slice_edges(F: int) -> int:
    """Edges a slice of the card kernels at width ``F``
    (``slice_edges`` in ``csrc/segment_csr.cu``): a row whose range holds
    more is summed in pieces."""
    return _library().segment_csr_slice_edges(F)


def _pieces(E: int, F: int, device):
    """The card kernels' scratch for the pieces of long rows, float32
    ``[S, 2, F]`` and int32 ``[S, 2]`` over the ``S`` slices of ``E`` edges
    (None when no row can be long: ``E`` within one slice)."""
    L = slice_edges(F)
    if E <= L:
        return None, None
    S = -(-E // L)
    return (torch.empty((S, 2, F), dtype=torch.float32, device=device),
            torch.empty((S, 2), dtype=torch.int32, device=device))


def segment_csr_kernel(data: torch.Tensor, seg_ids: torch.Tensor,
                       rowptr: torch.Tensor, num_rows: int, block_rows: int,
                       max_edges_per_block: int) -> torch.Tensor:
    """Check CUDA inputs and launch the kernel; raises on what it does not
    take and when the TPU kernel would drop edges (``csr_block_overflow``,
    read on the host: one synchronisation, skipped when
    ``max_edges_per_block`` is at least :func:`full_window`)."""
    if data.ndim != 2:
        raise ValueError(f"segment_sum_sorted_csr: data must be [E, F], got "
                         f"shape {tuple(data.shape)}")
    E, F = data.shape
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum_sorted_csr kernel takes float32 or "
                        f"bfloat16 data, got {data.dtype}")
    for name, t, want in (("seg_ids", seg_ids, (E,)),
                          ("rowptr", rowptr, (num_rows + 1,))):
        if t.device != data.device:
            raise ValueError(f"segment_sum_sorted_csr: {name} on {t.device}, "
                             f"data on {data.device}")
        if tuple(t.shape) != want:
            raise ValueError(f"segment_sum_sorted_csr: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
    dropped = 0 if max_edges_per_block >= full_window(E) else int(
        csr_block_overflow(rowptr, num_rows, block_rows, max_edges_per_block))
    if dropped:
        raise RuntimeError(
            f"segment_sum_sorted_csr: {dropped} edges exceed "
            f"max_edges_per_block={max_edges_per_block} for block_rows="
            f"{block_rows}; the TPU kernel would drop them, so raise the cap "
            f"(segment_eb)")
    return segment_csr_launch(data.contiguous(),
                              seg_ids.to(torch.int32).contiguous(),
                              rowptr.to(torch.int32).contiguous(), num_rows)


def segment_csr_launch(data: torch.Tensor, seg: torch.Tensor,
                       rp: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The bare launch on inputs :func:`segment_csr_kernel` has checked:
    contiguous CUDA ``data [E, F]`` (float32 or bf16), int32 ``seg [E]``
    and ``rp [num_rows + 1]``."""
    global launches
    E, F = data.shape
    out = torch.empty((num_rows, F), dtype=torch.float32, device=data.device)
    piece, piece_row = _pieces(E, F, data.device)
    rc = _library().segment_csr_fwd(
        *map(_build.ptr, (data, seg, rp, piece, piece_row, out)), E, F,
        num_rows, int(data.dtype == torch.bfloat16),
        _build.stream(data.device))
    _build.check(rc, "segment_sum_sorted_csr kernel", _SHAPES)
    launches += 1
    return out


def _segment_sum(data, seg_ids, rowptr, num_rows, block_rows, eb):
    if data.is_cuda:
        return segment_csr_kernel(data, seg_ids, rowptr, num_rows, block_rows,
                                  eb)
    if data.device.type != "cpu":
        raise ValueError(f"segment_sum_sorted_csr runs on CUDA or the CPU, "
                         f"not {data.device}")
    return segment_sum_sorted_csr_reference(data, seg_ids, rowptr, num_rows)


class _SegmentSumSortedCSR(torch.autograd.Function):
    """``data [E, F] -> [num_rows, F]`` float32. Adjoint: :class:`_RowGather`."""

    @staticmethod
    def forward(ctx, data, seg_ids, rowptr, num_rows, block_rows, eb):
        ctx.save_for_backward(seg_ids, rowptr)
        ctx.meta = (num_rows, block_rows, eb, data.dtype)
        return _segment_sum(data, seg_ids, rowptr, num_rows, block_rows, eb)

    @staticmethod
    def backward(ctx, ct):
        seg_ids, rowptr = ctx.saved_tensors
        num_rows, block_rows, eb, dtype = ctx.meta
        return (_RowGather.apply(ct, seg_ids, rowptr, num_rows, block_rows,
                                 eb, dtype), None, None, None, None, None)


class _RowGather(torch.autograd.Function):
    """``u [num_rows, F] -> [E, F]`` in ``dtype``: ``u[seg]``, zeros at id
    -1. Adjoint: :class:`_SegmentSumSortedCSR`."""

    @staticmethod
    def forward(ctx, u, seg_ids, rowptr, num_rows, block_rows, eb, dtype):
        ctx.save_for_backward(seg_ids, rowptr)
        ctx.meta = (num_rows, block_rows, eb, u.dtype)
        return row_gather(u, seg_ids, num_rows).to(dtype)

    @staticmethod
    def backward(ctx, w):
        seg_ids, rowptr = ctx.saved_tensors
        num_rows, block_rows, eb, dtype = ctx.meta
        du = _SegmentSumSortedCSR.apply(w, seg_ids, rowptr, num_rows,
                                        block_rows, eb)
        return du.to(dtype), None, None, None, None, None, None


def segment_sum_sorted_csr(data: torch.Tensor, seg_ids: torch.Tensor,
                           rowptr: torch.Tensor, num_rows: int,
                           block_rows: int = 32,
                           max_edges_per_block: int = 1024) -> torch.Tensor:
    """Sorted-CSR segment sum: data [E, F], seg_ids [E] (ascending; -1 for
    padding), rowptr [num_rows + 1] -> [num_rows, F] float32.
    Differentiable to any order (see the module docstring)."""
    return _SegmentSumSortedCSR.apply(data, seg_ids, rowptr, num_rows,
                                      block_rows, max_edges_per_block)


# ---------------------------------------------------------------------------
# the chunked sum
# ---------------------------------------------------------------------------

def plan_chunks(rowptr, num_rows: int, block_rows: int,
                chunk_edges: int) -> np.ndarray:
    """Host-side chunk table for :func:`segment_sum_sorted_csr_chunked`.

    Returns int32 ``meta [3, C]``: row 0 = 128-aligned edge window starts,
    row 1 = output row-block index, row 2 = 1 on a block's first chunk.
    Every row block gets >= 1 chunk (so every output row is written), and
    the chunks tile each block's full extent: no edge is dropped.
    """
    rp = np.asarray(rowptr, np.int64)
    BN, EB = block_rows, chunk_edges
    assert EB % 128 == 0
    N_pad = _round_up(num_rows, BN)
    rp = np.pad(rp, (0, N_pad + 1 - rp.shape[0]), mode="edge")
    starts = rp[::BN][:-1]
    ends = rp[::BN][1:]
    start_al = (starts // 128) * 128
    need = ends - start_al
    n_chunks = np.maximum(1, -(-need // EB))
    blocks = np.repeat(np.arange(len(starts)), n_chunks)
    within = np.arange(len(blocks)) - np.repeat(
        np.cumsum(n_chunks) - n_chunks, n_chunks)
    return np.stack([
        (start_al[blocks] + within * EB),
        blocks,
        (within == 0).astype(np.int64),
    ]).astype(np.int32)


def choose_chunk_plan(rowptr, num_rows: int, feat_dim: int,
                      dtype=torch.float32):
    """Deterministic ``(block_rows, chunk_edges, meta, bytes)`` from rowptr
    statistics, the JAX package's choice: each candidate is modelled as
    max(DMA time, one-hot matmul time) at its nominal TPU rates (the
    constants only set the crossover, so the choice is the same on every
    machine); ``bytes`` is the modelled window traffic."""
    DMA_BPS, MM_FLOPS = 130e9, 60e12
    passes = 3 if dtype == torch.float32 else 1
    esize = 4 if dtype == torch.float32 else 2
    best = None
    for BN in (64, 128, 256, 512):
        for EB in (512, 768, 1024):
            meta = plan_chunks(rowptr, num_rows, BN, EB)
            C = meta.shape[1]
            dma = C * EB * (feat_dim * esize + 4) \
                + _round_up(num_rows, BN) * feat_dim * 4
            mm = C * 2 * BN * EB * feat_dim * passes
            t = max(dma / DMA_BPS, mm / MM_FLOPS)
            if best is None or t < best[0]:
                best = (t, BN, EB, meta, dma)
    return best[1], best[2], best[3], best[4]


def segment_sum_sorted_csr_chunked_reference(data, seg_ids, meta,
                                             num_rows: int,
                                             block_rows: int = 256,
                                             chunk_edges: int = 512):
    """Plain version of the chunked sum, with the TPU kernel's membership
    rule: edge e counts for row r = seg[e] when e lies in a window
    ``[meta[0][c], meta[0][c] + chunk_edges)`` of a chunk c of r's row
    block (``meta[1][c] == r // block_rows``) and r < num_rows. Sums in
    float32."""
    E, F = data.shape
    m = torch.as_tensor(meta, device=data.device).long()
    e = m[0][:, None] + torch.arange(chunk_edges, device=data.device)
    inb = (e >= 0) & (e < E)
    es = torch.where(inb, e, 0)
    s = seg_ids.long()[es]
    base = m[1][:, None] * block_rows
    take = inb & (s >= base) & (s < base + block_rows) & (s < num_rows)
    out = torch.zeros((num_rows, F), dtype=torch.float32, device=data.device)
    return out.index_add_(0, s[take], data[es[take]].float())


def segment_csr_chunked_launch(data, seg, meta, num_rows, block_rows,
                               chunk_edges):
    """Check CUDA inputs and launch the chunked sum: contiguous ``data
    [E, F]`` (float32 or bf16), int32 ``seg [E]`` and ``meta [3, C]`` (a
    numpy table is copied to the card); ``[num_rows, F]`` float32. One
    call runs a memset and the span pass (into an int32 ``[2, num_rows]``
    scratch), then the segment sum's kernels over the spans, on the
    stream, and counts once in ``launches_chunked``."""
    global launches_chunked
    if data.ndim != 2:
        raise ValueError(f"segment_sum_sorted_csr_chunked: data must be "
                         f"[E, F], got shape {tuple(data.shape)}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum_sorted_csr_chunked kernel takes "
                        f"float32 or bfloat16 data, got {data.dtype}")
    E, F = data.shape
    meta = torch.as_tensor(meta, dtype=torch.int32, device=data.device)
    if seg.device != data.device or tuple(seg.shape) != (E,):
        raise ValueError(f"segment_sum_sorted_csr_chunked: seg_ids "
                         f"{tuple(seg.shape)} on {seg.device}, expected "
                         f"({E},) on {data.device}")
    if meta.ndim != 2 or meta.shape[0] != 3:
        raise ValueError(f"segment_sum_sorted_csr_chunked: meta must be "
                         f"[3, C], got {tuple(meta.shape)}")
    data = data.contiguous()
    seg = seg.to(torch.int32).contiguous()
    meta = meta.contiguous()
    out = torch.empty((num_rows, F), dtype=torch.float32, device=data.device)
    span = torch.empty((2, num_rows), dtype=torch.int32, device=data.device)
    piece, piece_row = _pieces(E, F, data.device)
    rc = _library().segment_csr_chunked_fwd(
        *map(_build.ptr, (data, seg, meta, span, piece, piece_row, out)), E,
        F, num_rows, meta.shape[1], block_rows, chunk_edges,
        int(data.dtype == torch.bfloat16), _build.stream(data.device))
    _build.check(rc, "segment_sum_sorted_csr_chunked kernel", _SHAPES)
    launches_chunked += 1
    return out


class _SegmentSumChunked(torch.autograd.Function):
    """``data [E, F] -> [num_rows, F]`` float32 by the chunk table. Its
    backward is the row gather ``ct[seg]`` (zeros at id -1), cast to
    ``data``'s type: plain PyTorch, as the JAX ``_ssc_bwd`` is a plain
    gather."""

    @staticmethod
    def forward(ctx, data, seg_ids, meta, num_rows, block_rows, chunk_edges):
        ctx.save_for_backward(seg_ids)
        ctx.meta = (num_rows, data.dtype)
        if data.is_cuda:
            return segment_csr_chunked_launch(data, seg_ids, meta, num_rows,
                                              block_rows, chunk_edges)
        if data.device.type != "cpu":
            raise ValueError(f"segment_sum_sorted_csr_chunked runs on CUDA "
                             f"or the CPU, not {data.device}")
        return segment_sum_sorted_csr_chunked_reference(
            data, seg_ids, meta, num_rows, block_rows, chunk_edges)

    @staticmethod
    def backward(ctx, ct):
        (seg_ids,) = ctx.saved_tensors
        num_rows, dtype = ctx.meta
        return (row_gather(ct, seg_ids, num_rows).to(dtype), None, None,
                None, None, None)


def segment_sum_sorted_csr_chunked(data: torch.Tensor, seg_ids: torch.Tensor,
                                   meta, num_rows: int,
                                   block_rows: int = 256,
                                   chunk_edges: int = 512) -> torch.Tensor:
    """Chunked sorted-CSR segment sum: data [E, F], seg_ids [E] (ascending;
    -1 for padding), ``meta`` from :func:`plan_chunks` at the same
    ``block_rows`` and ``chunk_edges`` -> [num_rows, F] float32. Unlike
    :func:`segment_sum_sorted_csr` there is no overflow: the chunks tile
    every block's edges."""
    return _SegmentSumChunked.apply(data, seg_ids, meta, num_rows,
                                    block_rows, chunk_edges)


def spmm_csr(rowptr: torch.Tensor, col: torch.Tensor, val, x: torch.Tensor,
             num_rows: int, *, block_rows: int = 32,
             max_edges_per_block: int = 1024) -> torch.Tensor:
    """CSR sparse @ dense: ``out[i] = sum over e in row i of val[e] *
    x[col[e]]`` -> ``[num_rows, F]`` float32. The gather ``x[col]`` goes
    through ``ops.segment.gather_rows`` (its adjoint is a sorted-CSR sum,
    not ``index_add_``), the reduction through
    :func:`segment_sum_sorted_csr`. Edges past ``rowptr[-1]`` (static-shape
    padding, ``len(col) > rowptr[-1]``) get id -1 and add nothing."""
    from .segment import gather_rows
    E = col.shape[0]
    rp = rowptr.long()
    e = torch.arange(E, device=col.device)
    seg = torch.searchsorted(rp[1:], e, right=True)
    seg = torch.where((e >= rp[0]) & (e < rp[-1]), seg, -1).to(torch.int32)
    data = gather_rows(x, col)
    if val is not None:
        data = data * val[:, None]
    return segment_sum_sorted_csr(data, seg, rowptr, num_rows, block_rows,
                                  max_edges_per_block)
