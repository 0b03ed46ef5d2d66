"""Dense per-graph batch view for small graphs (molecules).

Port of ``dig_tpu/graph_dense.py``: every graph occupies ``n_max`` node
slots, the radius graph is a masked dense adjacency, and several small
molecules may share a slot (``nodes['mol']``). :func:`dense_to_flat` turns
a dense batch and its adjacency into a flat ``GraphBatch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .graph import GraphBatch


@dataclasses.dataclass
class DenseGraphBatch:
    """Fixed-slot molecular batch.

    Attributes:
      z: ``[G, n_max]`` int32 atomic numbers (0 = padding slot).
      pos: ``[G, n_max, 3]`` float32 positions.
      node_mask: ``[G, n_max]`` bool.
      globals: dict of ``[G, ...]`` per-graph tensors.
      nodes: dict of extra ``[G, n_max, ...]`` per-node tensors.
    """

    z: torch.Tensor
    pos: torch.Tensor
    node_mask: torch.Tensor
    globals: Dict[str, torch.Tensor]
    nodes: Dict[str, torch.Tensor]

    @property
    def num_graphs(self) -> int:
        return self.z.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.z.shape[1]

    def replace(self, **changes) -> "DenseGraphBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "DenseGraphBatch":
        mv = lambda d: {k: v.to(device) for k, v in d.items()}
        return DenseGraphBatch(
            z=self.z.to(device), pos=self.pos.to(device),
            node_mask=self.node_mask.to(device),
            globals=mv(self.globals), nodes=mv(self.nodes))


def _batch(z, pos, mask, globals_, nodes, device) -> DenseGraphBatch:
    t = torch.from_numpy
    return DenseGraphBatch(
        z=t(z), pos=t(pos), node_mask=t(mask),
        globals={k: t(np.asarray(v)) for k, v in globals_.items()},
        nodes={k: t(np.asarray(v)) for k, v in nodes.items()},
    ).to(device)


def dense_batch_np(
    z_list, pos_list, n_max: int, num_graphs: Optional[int] = None,
    globals_list: Optional[Dict[str, list]] = None,
    nodes_list: Optional[Dict[str, list]] = None,
    device: DeviceLike = None,
) -> DenseGraphBatch:
    """Host-side batching of per-molecule (z, pos) into a DenseGraphBatch."""
    device = resolve_device(device)
    G = num_graphs if num_graphs is not None else len(z_list)
    z = np.zeros((G, n_max), np.int32)
    pos = np.zeros((G, n_max, 3), np.float32)
    mask = np.zeros((G, n_max), bool)
    for i, (zi, pi) in enumerate(zip(z_list, pos_list)):
        n = len(zi)
        if n > n_max:
            raise ValueError(f"molecule with {n} atoms > n_max={n_max}")
        z[i, :n] = np.asarray(zi)
        pos[i, :n] = np.asarray(pi)
        mask[i, :n] = True
    globals_ = {}
    if globals_list:
        for k, vals in globals_list.items():
            arr = np.zeros((G,) + np.shape(np.atleast_1d(vals[0])), np.float32)
            for i, v in enumerate(vals):
                arr[i] = v
            globals_[k] = arr
    nodes = {}
    if nodes_list:
        for k, vals in nodes_list.items():
            ex = np.asarray(vals[0])
            arr = np.zeros((G, n_max) + tuple(ex.shape[1:]), ex.dtype)
            for i, v in enumerate(vals):
                arr[i, : len(v)] = np.asarray(v)
            nodes[k] = arr
    return _batch(z, pos, mask, globals_, nodes, device)


def pack_molecules(sizes, capacity: int, max_per_slot: int):
    """First-fit-decreasing bin packing of molecule sizes into slots: each
    slot's atom counts sum to <= capacity, with at most ``max_per_slot``
    molecules."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    slots: list = []
    fill: list = []
    for i in order:
        n = sizes[i]
        for s in range(len(slots)):
            if fill[s] + n <= capacity and len(slots[s]) < max_per_slot:
                slots[s].append(i)
                fill[s] += n
                break
        else:
            slots.append([i])
            fill.append(n)
    return slots


def packed_dense_batch_np(
    mols, num_slots: int, n_max: int, max_per_slot: int = 4,
    target_key: str = "y", slots=None, device: DeviceLike = None,
) -> DenseGraphBatch:
    """Bin-pack molecule dicts ({z, pos, y}) into a DenseGraphBatch where a
    slot may hold several molecules.

    Adds ``nodes['mol']`` ([G, n_max] int32: molecule index within the
    slot), ``globals['y']`` ([G, max_per_slot, T]) and
    ``globals['mol_mask']`` ([G, max_per_slot] bool). Per-atom extras (e.g.
    ``force``) ride along as ``nodes[key]``.
    """
    device = resolve_device(device)
    sizes = [len(m["z"]) for m in mols]
    if any(s > n_max for s in sizes):
        raise ValueError("molecule larger than n_max")
    if slots is None:
        slots = pack_molecules(sizes, n_max, max_per_slot)
    if len(slots) > num_slots:
        raise ValueError(f"packing needs {len(slots)} slots > {num_slots}")
    T = np.atleast_1d(mols[0][target_key]).shape[0]
    G = num_slots
    z = np.zeros((G, n_max), np.int32)
    pos = np.zeros((G, n_max, 3), np.float32)
    mask = np.zeros((G, n_max), bool)
    mol = np.zeros((G, n_max), np.int32)
    y = np.zeros((G, max_per_slot, T), np.float32)
    mol_mask = np.zeros((G, max_per_slot), bool)
    node_keys = [k for k, v in mols[0].items()
                 if k not in ("z", "pos", target_key)
                 and np.ndim(v) >= 1 and np.shape(v)[0] == sizes[0]]
    extras = {k: np.zeros((G, n_max) + np.shape(mols[0][k])[1:],
                          np.asarray(mols[0][k]).dtype) for k in node_keys}
    for g, slot in enumerate(slots):
        at = 0
        for k, i in enumerate(slot):
            m = mols[i]
            n = len(m["z"])
            z[g, at:at + n] = m["z"]
            pos[g, at:at + n] = m["pos"]
            mask[g, at:at + n] = True
            mol[g, at:at + n] = k
            y[g, k] = np.atleast_1d(m[target_key])
            mol_mask[g, k] = True
            for kk in node_keys:
                extras[kk][g, at:at + n] = m[kk]
            at += n
    return _batch(z, pos, mask, {"y": y, "mol_mask": mol_mask},
                  {"mol": mol, **extras}, device)


def dense_pairwise(pos: torch.Tensor, node_mask: torch.Tensor,
                   eps: float = 1e-12):
    """All-pairs distances and pair validity for a dense batch.

    Returns (dist ``[G, n, n]``, pair_mask ``[G, n, n]``); the diagonal is
    excluded from pair_mask. The sqrt is guarded so grads at 0 are finite.
    """
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    n = pos.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pair_mask = node_mask[:, :, None] & node_mask[:, None, :] & ~eye[None]
    dist = torch.sqrt(torch.clamp(d2, min=eps))
    return dist, pair_mask


def radius_adjacency(pos: torch.Tensor, node_mask: torch.Tensor,
                     cutoff: float, mol_id: Optional[torch.Tensor] = None):
    """Dense radius graph: adjacency ``[G, n, n]`` with adj[g, i, j] True iff
    ||pos_i - pos_j|| < cutoff, both real, i != j (PyG ``radius_graph``
    semantics). With ``mol_id`` ([G, n], from packed batches) pairs of
    different molecules sharing a slot are excluded."""
    dist, pair_mask = dense_pairwise(pos, node_mask)
    if mol_id is not None:
        pair_mask = pair_mask & (mol_id[:, :, None] == mol_id[:, None, :])
    return dist, pair_mask & (dist < cutoff)


def dense_to_flat(batch: DenseGraphBatch, adj: torch.Tensor,
                  max_edges: int) -> GraphBatch:
    """A dense batch and its adjacency ``adj [G, n, n]`` (``adj[g, i, j]``:
    edge j -> i) as a flat ``GraphBatch`` with a static edge cap: a stable
    sort of the flattened ``~adj`` puts the real edges first in row-major
    (g, i, j) order and the first ``max_edges`` are kept (more real edges
    than the cap: the tail is dropped). Padding edges hold node 0."""
    G, n = batch.z.shape
    N_pad = G * n
    dev = batch.z.device
    flat_adj = adj.reshape(-1)
    order = torch.argsort((~flat_adj).to(torch.uint8), stable=True)
    take = order[:max_edges]
    edge_mask = flat_adj[take]
    g_idx = take // (n * n)
    rem = take % (n * n)
    i_idx, j_idx = rem // n, rem % n
    receivers = torch.where(edge_mask, g_idx * n + i_idx, 0).to(torch.int32)
    senders = torch.where(edge_mask, g_idx * n + j_idx, 0).to(torch.int32)
    n_edge = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(
        0, g_idx, edge_mask.to(torch.int32))
    nodes = {"z": batch.z.reshape(N_pad), "pos": batch.pos.reshape(N_pad, 3)}
    for k, v in batch.nodes.items():
        nodes[k] = v.reshape((N_pad,) + tuple(v.shape[2:]))
    return GraphBatch(
        nodes=nodes, edges={}, senders=senders, receivers=receivers,
        globals=dict(batch.globals),
        node_graph=torch.repeat_interleave(
            torch.arange(G, dtype=torch.int32, device=dev), n),
        node_mask=batch.node_mask.reshape(N_pad), edge_mask=edge_mask,
        graph_mask=torch.ones(G, dtype=torch.bool, device=dev),
        n_node=torch.sum(batch.node_mask, dim=1).to(torch.int32),
        n_edge=n_edge)
