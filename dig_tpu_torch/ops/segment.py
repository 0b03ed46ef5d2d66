"""Segment reductions. Port of ``segment_sum``, ``segment_sum_sorted`` and
``_apply_mask`` of ``dig_tpu/ops/segment.py``.

Static output sizes; an optional ``mask`` over the data rows makes
masked rows contribute the identity. Indices must be in range (padding
convention: index 0 with a False mask).

``segment_sum`` is ``index_add_``. On CUDA that adds with atomics in an
order that changes from run to run, so its result is NOT bitwise
repeatable there (the JAX package's TPU scatter-add is); on the CPU it
is. The NK model path aggregates edges by a reshape-sum instead
(``ops.triplets.edges_to_nodes_nk``) and uses this only for the
per-graph readout. ``segment_sum_sorted`` goes through the sorted-CSR
kernel (``ops.segment_csr``): its sums are bitwise repeatable on the card at
every derivative order.
"""
from __future__ import annotations

from typing import Optional

import torch

from .segment_csr import segment_sum_sorted_csr


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor],
                fill: float) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return torch.where(m, data, fill)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an index tensor of any shape, through
    ``index_select``: its adjoint is ``index_add_``. (The adjoint of
    advanced indexing is a sort-based accumulation that handles the
    indices repeated at one row in series, and every padding edge of a
    flat edge list points at node 0.)"""
    out = x.index_select(0, idx.reshape(-1).long())
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
