"""Host-side graph partitioning for the large-graph path. Port of
``dig_tpu/parallel/partition.py`` (numpy, copied).

Replaces the reference's ``torch.ops.torch_sparse.partition`` (METIS) call
at ``dig/lsgraph/method/GraphFMOB/metis.py:14`` and the C++ one-hop
relabeling at ``csrc/cpu/relabel_cpu.cpp:5-102``. Two partitioners:

* the C++ one of ``dig_tpu_torch.native`` (greedy growing with
  Fiduccia–Mattheyses-style boundary refinement), which
  ``partition_graph`` takes first; it is built with g++ at first use;
* a BFS-grow greedy balanced edge-cut partitioner in numpy
  (deterministic), when the native library is unavailable.

Output contract (``PartitionedGraph``): nodes re-ordered so each part owns
a contiguous equal-size slab (padded), plus *halo* index tables describing
which remote nodes each part reads — the static-shape analog of
``relabel_one_hop``'s (out_rowptr, out_col, n_id).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class PartitionedGraph:
    """A node-partitioned graph laid out for a halo exchange.

    All shapes static; P = num_parts, C = nodes-per-part (padded),
    E_local = max local edges per part, H = max halo size per part.

    Attributes:
      perm: [N] original->new node id permutation (new id = part*C + slot).
      part_of: [N] part id per (original) node.
      senders/receivers: [P, E_local] *new* local node ids (0..C-1 receiver
        side); senders index into the local feature slab of size C + H:
        values < C are local, values >= C index the halo buffer.
      edge_mask: [P, E_local] bool.
      halo_src_part: [P, H] which part each halo node lives on.
      halo_src_slot: [P, H] its slot within that part.
      halo_mask: [P, H] bool.
      node_mask: [P, C] bool (real vs padding slots).
    """

    perm: np.ndarray
    part_of: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    edge_mask: np.ndarray
    halo_src_part: np.ndarray
    halo_src_slot: np.ndarray
    halo_mask: np.ndarray
    node_mask: np.ndarray

    @property
    def num_parts(self) -> int:
        return self.node_mask.shape[0]

    @property
    def nodes_per_part(self) -> int:
        return self.node_mask.shape[1]


def partition_graph(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int, num_parts: int,
                    seed: int = 0) -> np.ndarray:
    """Greedy BFS-grow balanced partitioner -> part_of[num_nodes].

    Grows parts one at a time from a min-degree seed, preferring frontier
    nodes with most internal neighbors (locally minimizing edge cut) —
    the classic GGGP heuristic. Deterministic. The C++ partitioner
    (``native/partition.cpp``) is taken instead when the native library
    is available.
    """
    from ..native import metis_partition
    out = metis_partition(senders, receivers, num_nodes, num_parts)
    if out is not None:
        return out
    # CSR build
    order = np.argsort(senders, kind="stable")
    col = receivers[order].astype(np.int64)
    deg = np.bincount(senders, minlength=num_nodes)
    rowptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])

    target = -(-num_nodes // num_parts)
    part_of = np.full(num_nodes, -1, np.int64)
    unassigned = num_nodes
    # score[v] = number of already-in-part neighbors; assigned nodes -inf
    for p in range(num_parts - 1):
        size = 0
        gain = np.zeros(num_nodes, np.int32)
        frontier = []
        while size < target and unassigned > 0:
            if not frontier:
                # new seed: unassigned node with min degree
                cand = np.flatnonzero(part_of == -1)
                seed_v = cand[np.argmin(deg[cand])]
                v = int(seed_v)
            else:
                # take best-gain frontier node
                best = max(frontier, key=lambda u: gain[u])
                frontier.remove(best)
                v = best
                if part_of[v] != -1:
                    continue
            part_of[v] = p
            size += 1
            unassigned -= 1
            for u in col[rowptr[v]:rowptr[v + 1]]:
                if part_of[u] == -1:
                    gain[u] += 1
                    if gain[u] == 1:
                        frontier.append(int(u))
    part_of[part_of == -1] = num_parts - 1
    return refine_partition(part_of, rowptr, col, num_parts)


def refine_partition(part_of: np.ndarray, rowptr: np.ndarray,
                     col: np.ndarray, num_parts: int,
                     max_passes: int = 4, slack: int = 1) -> np.ndarray:
    """Greedy KL/FM-style refinement: move a node to the part holding most
    of its neighbors when that strictly reduces the cut and keeps sizes
    within ceil(n/parts) + slack. Fixes the 'stranded orphan' artifacts of
    the growth phase."""
    part_of = part_of.copy()
    n = len(part_of)
    cap = -(-n // num_parts) + slack
    sizes = np.bincount(part_of, minlength=num_parts)
    for _ in range(max_passes):
        moved = 0
        for v in range(n):
            nbrs = col[rowptr[v]:rowptr[v + 1]]
            if len(nbrs) == 0:
                continue
            hist = np.bincount(part_of[nbrs], minlength=num_parts)
            cur = part_of[v]
            best = int(np.argmax(hist))
            if best != cur and hist[best] > hist[cur] and sizes[best] < cap:
                sizes[cur] -= 1
                sizes[best] += 1
                part_of[v] = best
                moved += 1
        if moved == 0:
            break
    return part_of


def build_partitions(senders: np.ndarray, receivers: np.ndarray,
                     num_nodes: int, num_parts: int,
                     part_of: Optional[np.ndarray] = None,
                     nodes_per_part: Optional[int] = None,
                     max_local_edges: Optional[int] = None,
                     max_halo: Optional[int] = None) -> PartitionedGraph:
    """Lay out a partitioned graph for a halo exchange.

    The static-shape analog of ``relabel_one_hop``
    (``csrc/cpu/relabel_cpu.cpp:5-102``): local nodes first, out-of-part
    neighbors (halo) appended after, all global->local maps precomputed
    host-side once instead of per-minibatch.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if part_of is None:
        part_of = partition_graph(senders, receivers, num_nodes, num_parts)

    P_ = num_parts
    counts = np.bincount(part_of, minlength=P_)
    C = int(nodes_per_part if nodes_per_part is not None else counts.max())
    if counts.max() > C:
        raise ValueError(f"part size {counts.max()} > nodes_per_part={C}")

    # new id: part*C + slot (stable by original id)
    slot = np.zeros(num_nodes, np.int64)
    for p in range(P_):
        idx = np.flatnonzero(part_of == p)
        slot[idx] = np.arange(len(idx))
    perm = part_of * C + slot  # original -> new

    node_mask = np.zeros((P_, C), bool)
    for p in range(P_):
        node_mask[p, :counts[p]] = True

    # group edges by receiver part
    e_part = part_of[receivers]
    E_per = np.bincount(e_part, minlength=P_)
    EL = int(max_local_edges if max_local_edges is not None else E_per.max())
    if E_per.max() > EL:
        raise ValueError(f"edges per part {E_per.max()} > cap {EL}")

    out_s = np.zeros((P_, EL), np.int32)
    out_r = np.zeros((P_, EL), np.int32)
    out_m = np.zeros((P_, EL), bool)
    halo_part = []
    halo_slot = []
    H = 0
    halo_maps = []
    for p in range(P_):
        eidx = np.flatnonzero(e_part == p)
        s, r = senders[eidx], receivers[eidx]
        r_local = slot[r]
        s_is_local = part_of[s] == p
        # halo set: unique remote senders, sorted by global id (deterministic)
        remote = np.unique(s[~s_is_local])
        hmap = {int(g): i for i, g in enumerate(remote)}
        s_local = np.where(s_is_local, slot[s],
                           np.array([C + hmap.get(int(g), 0) for g in s]))
        ne = len(eidx)
        out_s[p, :ne] = s_local
        out_r[p, :ne] = r_local
        out_m[p, :ne] = True
        halo_part.append(part_of[remote])
        halo_slot.append(slot[remote])
        halo_maps.append(remote)
        H = max(H, len(remote))
    H = int(max_halo if max_halo is not None else max(H, 1))
    hp = np.zeros((P_, H), np.int32)
    hs = np.zeros((P_, H), np.int32)
    hm = np.zeros((P_, H), bool)
    for p in range(P_):
        n = len(halo_part[p])
        if n > H:
            raise ValueError(f"halo size {n} > cap {H}")
        hp[p, :n] = halo_part[p]
        hs[p, :n] = halo_slot[p]
        hm[p, :n] = True

    return PartitionedGraph(
        perm=perm, part_of=part_of,
        senders=out_s, receivers=out_r, edge_mask=out_m,
        halo_src_part=hp, halo_src_slot=hs, halo_mask=hm,
        node_mask=node_mask,
    )


def edge_cut(part_of: np.ndarray, senders: np.ndarray,
             receivers: np.ndarray) -> int:
    """Number of edges crossing parts (quality metric)."""
    return int(np.sum(part_of[senders] != part_of[receivers]))
