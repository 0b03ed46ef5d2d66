"""Radius and kNN graphs: the flat (compacted edge list) builders and the
[N, K] neighbour-table layout, over the whole batch or per slot of a
slot-aligned batch. Port of
``radius_graph_flat``, ``knn_graph_flat``, ``adjacency_to_edges``,
``radius_overflow``, ``NKGraph``, ``radius_graph_nk``,
``radius_blocked_dropped`` and ``radius_graph_nk_blocked`` of
``dig_tpu/ops/radius.py``.

Squared distances use the JAX package's expansion ``|p|^2 + |q|^2 -
2 p.q`` with the products taken elementwise in float32 (no matmul: a TF32
matmul on the card would move pairs across the cutoff and reorder
neighbours). ``torch.topk(sorted=True)`` keeps ``jax.lax.top_k``'s order,
so the tables equal the JAX tables exactly on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class NKGraph(NamedTuple):
    """Radius graph in the [N, K] neighbour-table layout.

    Edge e = i*K + d is the d-th in-edge of receiver i (sender
    ``nbr_idx[i, d]``). ``rev_edge[i, d]`` is the id of the reverse edge
    (the graph is symmetrised).
    """
    nbr_idx: torch.Tensor    # [N, K] int32 sender node of each slot
    nbr_mask: torch.Tensor   # [N, K] bool
    rev_edge: torch.Tensor   # [N, K] int32 edge id of the reverse edge
    senders: torch.Tensor    # [N*K]
    receivers: torch.Tensor  # [N*K]
    edge_mask: torch.Tensor  # [N*K]


def _block_d2(p: torch.Tensor) -> torch.Tensor:
    """[nb, B, 3] -> [nb, B, B] squared distances, float32, clamped at 0."""
    p = p.float()
    sq = torch.sum(p * p, dim=-1)
    dot = torch.sum(p[:, :, None, :] * p[:, None, :, :], dim=-1)
    return torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, min=0.0)


def _pairwise_same_graph(pos, node_graph, node_mask):
    d2 = _block_d2(pos[None])[0]
    n = pos.shape[0]
    valid = (node_mask[:, None] & node_mask[None, :]
             & (node_graph[:, None] == node_graph[None, :]))
    valid = valid & ~torch.eye(n, dtype=torch.bool, device=pos.device)
    return d2, valid


def _rank_rows(d2: torch.Tensor) -> torch.Tensor:
    """Rank of each entry within its row, ascending, ties in column order
    (a double stable argsort, as ``jnp.argsort``)."""
    order = torch.argsort(d2, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def radius_graph_flat(pos, node_graph, node_mask, cutoff: float,
                      max_edges: int,
                      max_num_neighbors: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional radius graph of a flat padded batch: ``(senders,
    receivers, edge_mask)``, each ``[max_edges]``, every ordered in-cutoff
    pair of one graph an edge (j -> i: sender j, receiver i), in the order
    of :func:`adjacency_to_edges`. ``max_num_neighbors`` keeps each
    receiver's nearest in-neighbours."""
    d2, valid = _pairwise_same_graph(pos, node_graph, node_mask)
    adj = valid & (d2 < cutoff * cutoff)
    if max_num_neighbors is not None:
        rank = _rank_rows(torch.where(adj, d2, torch.inf))
        adj = adj & (rank < max_num_neighbors)
    return adjacency_to_edges(adj, max_edges)


def knn_graph_flat(pos, node_graph, node_mask, k: int, max_edges: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k nearest neighbours of each node (receiver side), flat batch."""
    d2, valid = _pairwise_same_graph(pos, node_graph, node_mask)
    rank = _rank_rows(torch.where(valid, d2, torch.inf))
    return adjacency_to_edges(valid & (rank < k), max_edges)


def adjacency_to_edges(adj: torch.Tensor, max_edges: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten a ``[N, N]`` (receiver, sender) adjacency into a capped edge
    list, row-major by (receiver, sender) with padding last (a stable sort
    of the flattened table), so the receivers of the real edges ascend:
    the order the sorted-CSR segment sum needs. Edges beyond ``max_edges``
    are dropped (:func:`radius_overflow` counts them); padding rows hold
    node 0."""
    n = adj.shape[0]
    flat = adj.reshape(-1)
    order = torch.argsort((~flat).to(torch.uint8), stable=True)
    take = order[:max_edges]
    edge_mask = flat[take]
    receivers = torch.where(edge_mask, take // n, 0).to(torch.int32)
    senders = torch.where(edge_mask, take % n, 0).to(torch.int32)
    return senders, receivers, edge_mask


def radius_overflow(pos, node_graph, node_mask, cutoff: float,
                    max_edges: int) -> torch.Tensor:
    """Number of real radius-graph edges the ``max_edges`` cap drops."""
    d2, valid = _pairwise_same_graph(pos, node_graph, node_mask)
    total = torch.sum(valid & (d2 < cutoff * cutoff))
    return torch.clamp(total - max_edges, min=0)


def radius_blocked_dropped(pos, node_graph, node_mask, cutoff: float,
                           block: int) -> torch.Tensor:
    """Number of real radius-graph pairs that :func:`radius_graph_nk_blocked`
    drops because they cross a block boundary (same graph, in cutoff,
    different ``block`` slots). Nonzero means the batch is not
    slot-aligned. O(N^2): an audit, not a step op."""
    N = pos.shape[0]
    d2, valid = _pairwise_same_graph(pos, node_graph, node_mask)
    blk = torch.arange(N, device=pos.device) // block
    cross = blk[:, None] != blk[None, :]
    return torch.sum(valid & cross & (d2 < cutoff * cutoff))


def _nk_tables(adj, d2, k: int):
    """Per row of a ``[nb, B, B]`` candidate table: the K nearest in-cutoff
    neighbours (``top_k``; the K axis padded when a block holds fewer than
    K candidates), ``(lidx, nbr_mask, rev_slot)``, each ``[nb, B, K]``.
    ``lidx`` is the top-k table (0 past a row's neighbours); ``nbr_mask``
    keeps only mutual edges (symmetrisation); ``rev_slot[b, i, d]`` is the
    first position of i among the kept slots of row ``lidx[b, i, d]`` (as
    ``jnp.argmax`` of the hit table)."""
    nb, B, _ = adj.shape
    dev = adj.device
    score = torch.where(adj, -d2, -torch.inf)
    kk = min(k, B)
    vals, lidx = torch.topk(score, kk, dim=-1, sorted=True)
    if kk < k:          # pad the K axis so edge ids stay e = i*k + d
        pad = k - kk
        vals = torch.cat([vals, torch.full((nb, B, pad), -torch.inf,
                                           device=dev)], dim=-1)
        lidx = torch.cat([lidx, torch.zeros((nb, B, pad), dtype=lidx.dtype,
                                            device=dev)], dim=-1)
    top = vals > -torch.inf
    lidx = torch.where(top, lidx, 0)

    # kept[b, i, m]: m survived i's top-k (a scatter, the same table as the
    # JAX one-hot comparison); keep (i, m) only if i survived m's too
    bi = torch.arange(nb, device=dev)[:, None, None]
    ar = torch.arange(B, device=dev)
    kept = torch.zeros((nb, B, B), dtype=torch.bool, device=dev)
    ii = ar[None, :, None].expand_as(lidx)
    kept[bi.expand_as(lidx)[top], ii[top], lidx[top]] = True
    nbr_mask = top & kept[bi, lidx, ar[None, :, None]]
    hit = (lidx[bi, lidx] == ar[None, :, None, None]) & nbr_mask[bi, lidx]
    return lidx, nbr_mask, _first_true(hit)


def _nk_graph(nbr_idx, nbr_mask, rev_slot, k: int) -> NKGraph:
    """The :class:`NKGraph` of ``[N, K]`` sender, mask and reverse-slot
    tables."""
    N = nbr_idx.shape[0]
    nbr_idx = nbr_idx.to(torch.int32)
    rev_edge = torch.where(nbr_mask, nbr_idx * k + rev_slot, 0).to(
        torch.int32)
    receivers = torch.repeat_interleave(
        torch.arange(N, dtype=torch.int32, device=nbr_idx.device), k)
    flat_mask = nbr_mask.reshape(-1)
    return NKGraph(nbr_idx=nbr_idx, nbr_mask=nbr_mask, rev_edge=rev_edge,
                   senders=nbr_idx.reshape(-1),
                   receivers=torch.where(flat_mask, receivers, 0),
                   edge_mask=flat_mask)


def radius_graph_nk(pos, node_graph, node_mask, cutoff: float,
                    k: int) -> NKGraph:
    """Radius graph of any flat batch as a per-node nearest-K table, over
    the ``[N, N]`` same-graph distance table: per receiver the K nearest
    in-cutoff neighbours (``top_k``), then only mutual edges survive
    (symmetrisation), then each edge learns its reverse.

    As the JAX builder, ``nbr_idx`` (and ``senders``) keep the top-k's
    sender at slots the symmetrisation masks (the consumers mask them);
    slots past a row's in-cutoff neighbours hold node 0."""
    d2, valid = _pairwise_same_graph(pos, node_graph, node_mask)
    adj = valid & (d2 < cutoff * cutoff)
    lidx, nbr_mask, rev_slot = _nk_tables(adj[None], d2[None], k)
    return _nk_graph(lidx[0], nbr_mask[0], rev_slot[0], k)


def radius_graph_nk_blocked(pos, node_mask, cutoff: float, k: int,
                            block: int,
                            node_graph: Optional[torch.Tensor] = None
                            ) -> NKGraph:
    """Radius graph for slot-aligned batches, O(G * B^2): every candidate
    pair lives inside one ``block`` of node rows. Per receiver the K
    nearest in-cutoff neighbours are kept (``top_k``), then only mutual
    edges survive (symmetrisation), then each edge learns its reverse.
    Global node and edge indices, as ``radius_graph_nk``; the senders of
    masked slots are 0, as in the JAX blocked builder."""
    N = pos.shape[0]
    if N % block:
        raise ValueError(f"{N} nodes is not a multiple of block={block}")
    dev = pos.device
    nb = N // block
    d2 = _block_d2(pos.reshape(nb, block, 3))
    m = node_mask.reshape(nb, block)
    eye = torch.eye(block, dtype=torch.bool, device=dev)
    valid = m[:, :, None] & m[:, None, :] & ~eye[None]
    if node_graph is not None:
        # only prevents wrong cross-molecule edges in a non-aligned batch
        gb = node_graph.reshape(nb, block)
        valid = valid & (gb[:, :, None] == gb[:, None, :])
    adj = valid & (d2 < cutoff * cutoff)
    lidx, nbr_mask, rev_slot = _nk_tables(adj, d2, k)
    off = (torch.arange(nb, device=dev) * block)[:, None, None]
    nbr_mask = nbr_mask.reshape(N, k)
    nbr_idx = torch.where(nbr_mask, (lidx + off).reshape(N, k), 0)
    return _nk_graph(nbr_idx, nbr_mask, rev_slot.reshape(N, k), k)


def _first_true(hit: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where none (as
    ``jnp.argmax`` of a boolean table)."""
    K = hit.shape[-1]
    ar = torch.arange(K, device=hit.device)
    return torch.where(hit, ar, K).amin(dim=-1).remainder(K)
