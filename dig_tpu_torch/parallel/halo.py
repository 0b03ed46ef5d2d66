"""Halo exchange + partitioned aggregation over a process group. Port of
``dig_tpu/parallel/halo.py`` on ``torch.distributed``.

Each rank of the ``axis`` dimension of the mesh owns one part's contiguous
node slab (part index = its index along ``axis``); boundary features move
between ranks with collectives (:mod:`dig_tpu_torch.parallel.comm`), each
differentiable through its adjoint. The JAX functions take the ``[P, C,
F]`` array sharded over the mesh; the port's take this rank's ``[C, F]``
slab and return its ``[C, F]`` or ``[H, F]`` result.

Exchange strategies:

* :func:`halo_exchange_allgather` — all_gather all slabs then gather the
  halo rows; bandwidth O(N*F) per rank but one collective.
* :func:`halo_exchange_a2a` — precomputed per-pair send tables + one
  ``all_to_all``; moves only boundary rows, the scalable path. The send
  schedule is computed once on the host (:func:`build_exchange_plan`).
* :func:`halo_exchange_sum_ring` — whole slabs travel the ring one hop a
  step while each rank accumulates the edges whose senders live on the
  slab it holds.

:func:`partitioned_spmm` and the ring's per-hop sums are ``index_add_``
(the JAX ``jax.ops.segment_sum``); the GP models sum through the
sorted-CSR kernel instead (:mod:`dig_tpu_torch.parallel.gp_models`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import comm
from .partition import PartitionedGraph


@dataclass
class ExchangePlan:
    """Host-precomputed all-to-all schedule.

    K = max rows any part sends to any other part.
    send_slot[p, q, k]: local slot on p of the k-th row p sends to q.
    send_mask[p, q, k]: validity.
    recv_pos[p, q, k]: halo-buffer position on p for the k-th row received
      from q (same k-order as q's send to p).
    """

    send_slot: np.ndarray
    send_mask: np.ndarray
    recv_pos: np.ndarray
    halo_size: int


def build_exchange_plan(pg: PartitionedGraph) -> ExchangePlan:
    P, H = pg.halo_src_part.shape
    per_pair = [[None] * P for _ in range(P)]
    K = 1
    for q in range(P):
        for p in range(P):
            pos = np.flatnonzero(pg.halo_mask[q] & (pg.halo_src_part[q] == p))
            per_pair[p][q] = pos  # halo positions on q fed by p
            K = max(K, len(pos))
    send_slot = np.zeros((P, P, K), np.int32)
    send_mask = np.zeros((P, P, K), bool)
    recv_pos = np.zeros((P, P, K), np.int32)
    for p in range(P):
        for q in range(P):
            pos = per_pair[p][q]
            n = len(pos)
            send_slot[p, q, :n] = pg.halo_src_slot[q][pos]
            send_mask[p, q, :n] = True
            # p receives from q rows for p's halo entries sourced at q
            pos_r = per_pair[q][p]
            recv_pos[p, q, :len(pos_r)] = pos_r
    return ExchangePlan(send_slot=send_slot, send_mask=send_mask,
                        recv_pos=recv_pos, halo_size=H)


def _group(mesh, axis: str):
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def halo_exchange_allgather(x_local, halo_src_part, halo_src_slot, halo_mask,
                            group=None):
    """x_local: [C, F] this rank's slab; the halo tables its part's rows
    ``[H]``. Returns halo rows [H, F]."""
    all_x = comm.all_gather(x_local, group)                  # [P, C, F]
    h = all_x[halo_src_part.long(), halo_src_slot.long()]    # [H, F]
    return torch.where(halo_mask[:, None], h, 0.0)


def halo_exchange_a2a(x_local, send_slot, send_mask, recv_pos,
                      halo_size: int, group=None):
    """A2A halo exchange on this rank's part.

    Args (this rank's rows of the plan):
      x_local: [C, F]
      send_slot/send_mask: [P, K] what this rank sends to each peer.
      recv_pos: [P, K] halo positions for rows received from each peer.
    Returns: [H, F] halo feature rows.
    """
    sends = x_local[send_slot.long()]                        # [P, K, F]
    sends = torch.where(send_mask[:, :, None], sends, 0.0)
    recv = comm.all_to_all(sends, group)                     # [P, K, F]
    P, K = recv_pos.shape
    F = x_local.shape[-1]
    halo = torch.zeros((halo_size, F), dtype=x_local.dtype,
                       device=x_local.device)
    # rows beyond each pair's real count are zero (masked at send) and land
    # on position 0: adding zeros leaves it as it is
    return halo.index_add(0, recv_pos.reshape(P * K).long(),
                          recv.reshape(P * K, F))


def partitioned_spmm(x_local, halo_x, senders, receivers, edge_mask,
                     nodes_per_part: int, edge_weight=None):
    """Local masked segment-sum on one rank's slab: senders index [0, C+H)
    (< C local slab, >= C halo buffer)."""
    feats = torch.cat([x_local, halo_x], dim=0)              # [C+H, F]
    msgs = feats[senders.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    msgs = torch.where(edge_mask[:, None], msgs, 0.0)
    out = torch.zeros((nodes_per_part, msgs.shape[1]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add(0, receivers.long(), msgs)


def _rows(a: np.ndarray, p: int, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)[p], device=dev)


def halo_exchange_sum(x_local, pg: PartitionedGraph, mesh, axis: str = "graph",
                      plan: Optional[ExchangePlan] = None, edge_weight=None):
    """One full partitioned aggregation: this rank's ``x_local [C, F]`` ->
    its ``[C, F]`` neighbour sums (local + halo edges), the halo by one
    all-to-all over ``axis``."""
    if plan is None:
        plan = build_exchange_plan(pg)
    group, p = _group(mesh, axis)
    dev = x_local.device
    halo = halo_exchange_a2a(x_local, _rows(plan.send_slot, p, dev),
                             _rows(plan.send_mask, p, dev),
                             _rows(plan.recv_pos, p, dev), plan.halo_size,
                             group)
    return partitioned_spmm(x_local, halo, _rows(pg.senders, p, dev),
                            _rows(pg.receivers, p, dev),
                            _rows(pg.edge_mask, p, dev), pg.nodes_per_part,
                            edge_weight)


@dataclass
class RingPlan:
    """Host-precomputed ring schedule: for every (dest part p, source part
    q) the edges whose sender lives on q, as (sender slot on q, receiver
    slot on p) pairs padded to the max pair size K.

    e_slot[p, q, k]: sender's slot within q's slab.
    e_recv[p, q, k]: receiver's local slot on p.
    e_mask[p, q, k]: validity.
    """

    e_slot: np.ndarray
    e_recv: np.ndarray
    e_mask: np.ndarray


def build_ring_plan(pg: PartitionedGraph) -> RingPlan:
    P, E = pg.senders.shape
    C = pg.nodes_per_part
    pairs = [[[] for _ in range(P)] for _ in range(P)]
    for p in range(P):
        for e in range(E):
            if not pg.edge_mask[p, e]:
                continue
            s = int(pg.senders[p, e])
            r = int(pg.receivers[p, e])
            if s < C:
                q, slot = p, s
            else:
                h = s - C
                q, slot = int(pg.halo_src_part[p, h]), int(
                    pg.halo_src_slot[p, h])
            pairs[p][q].append((slot, r))
    K = max(1, max(len(pairs[p][q]) for p in range(P) for q in range(P)))
    e_slot = np.zeros((P, P, K), np.int32)
    e_recv = np.zeros((P, P, K), np.int32)
    e_mask = np.zeros((P, P, K), bool)
    for p in range(P):
        for q in range(P):
            for k, (slot, r) in enumerate(pairs[p][q]):
                e_slot[p, q, k] = slot
                e_recv[p, q, k] = r
                e_mask[p, q, k] = True
    return RingPlan(e_slot=e_slot, e_recv=e_recv, e_mask=e_mask)


def halo_exchange_sum_ring(x_local, pg: PartitionedGraph, mesh,
                           axis: str = "graph",
                           plan: Optional[RingPlan] = None,
                           edge_weight=None):
    """Ring-pipelined partitioned aggregation: whole slabs travel the ring
    one :func:`~dig_tpu_torch.parallel.comm.ppermute` hop a step while
    each rank accumulates the partial aggregation from the slab it holds
    (P - 1 hops; the JAX scan's last hop carries a slab nobody reads).

    Trade (mirror of ring attention): total bytes moved per rank are
    O(P * C * F) regardless of cut size, vs the a2a's O(boundary rows).
    Equals :func:`halo_exchange_sum`."""
    if plan is None:
        plan = build_ring_plan(pg)
    group, me = _group(mesh, axis)
    Pn = pg.num_parts
    C = pg.nodes_per_part
    dev = x_local.device
    e_slot = _rows(plan.e_slot, me, dev).long()          # [P, K]
    e_recv = _rows(plan.e_recv, me, dev).long()
    e_mask = _rows(plan.e_mask, me, dev)
    travel = x_local
    out = torch.zeros_like(x_local)
    for s in range(Pn):
        q = (me - s) % Pn                                # part we hold
        rows = torch.where(e_mask[q][:, None], travel[e_slot[q]], 0.0)
        out = out.index_add(0, e_recv[q], rows)
        if s < Pn - 1:
            travel = comm.ppermute(travel, group)
    return out
