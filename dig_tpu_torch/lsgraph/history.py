"""Historical embedding tables, functional. Port of
``dig_tpu/lsgraph/history.py``.

Parity with ``dig/lsgraph/method/GraphFMOB/history.py:7-67`` (pinned-CPU
``History.pull/push``) and ``dig/lsgraph/method/FM.py:11-75``
(FeatureMomentum): the tables are device tensors threaded through the
train step by the caller; pull is a gather, push returns a new table.

A push writes only the rows its mask selects (the others go to a row past
the table, which is then cut off), so a masked-out row can never land on
a real one. (The JAX push writes masked-out rows back with their stale
value; a minibatch's padding rows all carry node id 0, so there a fresh
row of node 0 can be overwritten by its stale value.) A push stores
values, not autograd graphs: the rows are detached, as the JAX train step
returns its new tables as auxiliary outputs, which carry no gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device


def write_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A new table: ``table`` with ``table[idx[i]] = rows[i]`` for each
    ``i`` that ``mask`` selects (every ``i`` without a mask); the selected
    ``idx`` must be distinct. ``rows`` is detached."""
    rows = rows.detach().to(table.dtype)
    if mask is None:
        return table.index_copy(0, idx, rows)
    N = table.shape[0]
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    return ext.index_copy_(0, torch.where(mask, idx, N), rows)[:N]


class History(NamedTuple):
    """emb: [num_nodes, dim] historical embeddings."""

    emb: torch.Tensor

    @classmethod
    def create(cls, num_embeddings: int, dim: int, dtype=torch.float32,
               device: DeviceLike = None) -> "History":
        return cls(emb=torch.zeros((num_embeddings, dim), dtype=dtype,
                                   device=resolve_device(device)))

    def pull(self, n_id: torch.Tensor) -> torch.Tensor:
        return self.emb[n_id]

    def push(self, x: torch.Tensor, n_id: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> "History":
        return History(emb=write_rows(self.emb, n_id, x, mask))


class FeatureMomentum(NamedTuple):
    """GraphFM-OB momentum history (FM.py:67-70): when a fresh boundary
    estimate x~ exists for an out-of-batch node, the stored history becomes
    gamma * x~ + (1 - gamma) * hist."""

    emb: torch.Tensor
    gamma: float

    @classmethod
    def create(cls, num_embeddings: int, dim: int, gamma: float = 0.9,
               dtype=torch.float32,
               device: DeviceLike = None) -> "FeatureMomentum":
        return cls(emb=torch.zeros((num_embeddings, dim), dtype=dtype,
                                   device=resolve_device(device)),
                   gamma=gamma)

    def pull(self, n_id: torch.Tensor) -> torch.Tensor:
        return self.emb[n_id]

    def push(self, x: torch.Tensor, n_id: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> "FeatureMomentum":
        """In-batch rows overwrite history (exact values)."""
        return FeatureMomentum(emb=write_rows(self.emb, n_id, x, mask),
                               gamma=self.gamma)

    def push_momentum(self, x_tilde: torch.Tensor, n_id: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> "FeatureMomentum":
        """Boundary rows blend with momentum (FM.py:67-70)."""
        old = self.emb[n_id]
        new = self.gamma * x_tilde.detach() + (1.0 - self.gamma) * old
        return FeatureMomentum(emb=write_rows(self.emb, n_id, new, mask),
                               gamma=self.gamma)
