"""Segment reductions. Port of ``segment_sum`` and ``_apply_mask`` of
``dig_tpu/ops/segment.py``.

Static output sizes; an optional ``mask`` over the data rows makes
masked rows contribute the identity. Indices must be in range (padding
convention: index 0 with a False mask).

``segment_sum`` is ``index_add_``. On CUDA that adds with atomics in an
order that changes from run to run, so its result is NOT bitwise
repeatable there (the JAX package's TPU scatter-add is); on the CPU it
is. The NK model path aggregates edges by a reshape-sum instead
(``ops.triplets.edges_to_nodes_nk``) and uses this only for the
per-graph readout.
"""
from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor],
                fill: float) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return torch.where(m, data, fill)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = sum of data rows with segment id s`` -> ``[num_segments,
    ...]`` in ``data``'s dtype."""
    data = _apply_mask(data, mask, 0.0)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)
