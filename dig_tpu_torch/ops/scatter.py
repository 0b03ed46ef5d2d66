"""Gather / scatter message-passing helpers on flat padded edge lists. Port
of ``dig_tpu/ops/scatter.py``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .segment import segment_sum


def gather(node_feats: torch.Tensor, index: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """node -> edge gather; masked rows are zeroed."""
    out = node_feats[index.long()]
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (out.ndim - mask.ndim))
        out = torch.where(m, out, 0.0)
    return out


def scatter_sum_edges(edge_feats: torch.Tensor, receivers: torch.Tensor,
                      num_nodes: int,
                      edge_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """edge -> node scatter-add (``segment_sum``)."""
    return segment_sum(edge_feats, receivers, num_nodes, edge_mask)


def coalesce_mean(edge_vals: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, num_nodes: int,
                  edge_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Average duplicate edges (same ``(s, r)`` pair) in the static ``[E]``
    layout: ``(mean_vals, rep_mask)``. ``mean_vals`` is ``edge_vals`` with
    every duplicate group replaced by its mean (masked rows zeroed);
    ``rep_mask`` marks the first edge of each distinct pair in (valid
    first, sender, receiver) order (False on masked rows)."""
    E = senders.shape[0]
    dev = senders.device
    inval = (torch.zeros(E, dtype=torch.long, device=dev) if edge_mask is None
             else (~edge_mask).long())
    # lexsort by (inval, senders, receivers): three stable sorts, last key
    # first
    order = torch.arange(E, device=dev)
    for key in (receivers.long(), senders.long(), inval):
        order = order[torch.argsort(key[order], stable=True)]
    ss, sr, si = senders[order], receivers[order], inval[order]
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         (ss[1:] != ss[:-1]) | (sr[1:] != sr[:-1])
                         | (si[1:] != si[:-1])])
    run_id = torch.cumsum(new_run.long(), 0) - 1
    svals = edge_vals[order]
    per_row = lambda m, t: m.reshape(m.shape + (1,) * (t.ndim - 1))
    smask = None
    if edge_mask is not None:
        smask = edge_mask[order]
        svals = torch.where(per_row(smask, svals), svals, 0.0)
    sums = segment_sum(svals, run_id, E)
    cnts = segment_sum(torch.ones(E, dtype=edge_vals.dtype, device=dev),
                       run_id, E, mask=smask)
    means = sums / torch.clamp(per_row(cnts, sums), min=1.0)
    mean_vals = torch.zeros_like(edge_vals)
    mean_vals[order] = means[run_id]
    rep = new_run
    if edge_mask is not None:
        rep = rep & smask
        mean_vals = torch.where(per_row(edge_mask, edge_vals), mean_vals, 0.0)
    rep_mask = torch.zeros(E, dtype=torch.bool, device=dev)
    rep_mask[order] = rep
    return mean_vals, rep_mask
