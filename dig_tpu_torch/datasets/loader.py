"""Host-side minibatch loaders: molecule dicts -> GraphBatch /
DenseGraphBatch.

Port of ``MoleculeLoader`` (``dig_tpu/datasets/loader.py:18-86``), the
dense loaders (``:89-300``) and ``BucketedMoleculeLoader`` (``:303-388``).
The numpy RNG use is the same, so a seed gives bit-identical batches to
the JAX package's loaders. Batches are built on the host and moved to
``device`` (default: the CUDA card).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch, batch_np
from ..graph_dense import dense_batch_np, packed_dense_batch_np


def _epoch_order(loader) -> np.ndarray:
    order = np.arange(len(loader.data))
    if loader.shuffle:
        rng = np.random.default_rng(loader.seed + loader.epoch)
        rng.shuffle(order)
        loader.epoch += 1
    return order


class MoleculeLoader:
    """Flat padded GraphBatches over molecule dicts ({z, pos, y[, force]}).

    ``batch_size`` graphs per batch (static); ``n_node_pad`` defaults to
    ``batch_size`` x the largest molecule; ``shuffle`` reshuffles each
    epoch from ``seed + epoch``; ``drop_last`` (default: ``shuffle``)
    drops the ragged tail, otherwise it is padded with empty graphs.
    ``slot_size``: slot-aligned layout (graph gi at rows
    ``gi * slot_size``), ``n_node_pad = batch_size * slot_size``.
    """

    def __init__(self, data, batch_size: int,
                 n_node_pad: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 slot_size: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.data = list(data)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last
        self.slot_size = slot_size
        if slot_size is not None:
            if (n_node_pad is not None
                    and n_node_pad != batch_size * slot_size):
                raise ValueError(
                    f"n_node_pad={n_node_pad} conflicts with slot_size="
                    f"{slot_size} (slot layout requires n_node_pad = "
                    f"batch_size * slot_size = {batch_size * slot_size})")
            n_node_pad = batch_size * slot_size
        elif n_node_pad is None:
            n_node_pad = batch_size * max(len(m["z"]) for m in self.data)
        self.n_node_pad = n_node_pad

    def __len__(self) -> int:
        n = len(self.data)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[GraphBatch]:
        order = _epoch_order(self)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            graphs = [_molecule_graph(self.data[i]) for i in idx]
            yield batch_np(graphs, self.n_node_pad, n_edge_pad=1,
                           num_graphs=self.batch_size,
                           slot_size=self.slot_size, device=self.device)


class DenseMoleculeLoader:
    """Dense per-graph minibatches ([G, n_max, ...]), one molecule per slot."""

    def __init__(self, data, batch_size: int, n_max: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: Optional[bool] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.data = list(data)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last
        self.n_max = n_max or max(len(m["z"]) for m in self.data)

    def __len__(self):
        n = len(self.data)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        order = _epoch_order(self)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            mols = [self.data[i] for i in idx]
            globals_list = {"y": [np.atleast_1d(m["y"]) for m in mols]}
            nodes_list = {}
            if "force" in mols[0]:
                nodes_list["force"] = [m["force"] for m in mols]
            yield dense_batch_np(
                [m["z"] for m in mols], [m["pos"] for m in mols],
                self.n_max, num_graphs=self.batch_size,
                globals_list=globals_list,
                nodes_list=nodes_list or None, device=self.device)


class PackedDenseMoleculeLoader:
    """Dense minibatches where each [n_max] slot holds SEVERAL bin-packed
    molecules (cross-molecule pairs masked via ``nodes['mol']``). Batches
    consume a variable number of molecules: iterate until exhausted."""

    def __init__(self, data, num_slots: int, n_max: int = 32,
                 max_per_slot: int = 4, shuffle: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.data = list(data)
        self.num_slots = num_slots
        self.n_max = n_max
        self.max_per_slot = max_per_slot
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def _packed(self, chunk, members):
        return packed_dense_batch_np(chunk, self.num_slots, self.n_max,
                                     self.max_per_slot, slots=members,
                                     device=self.device)

    def __iter__(self):
        fills = []          # per-slot atom fill
        members = []        # per-slot list of chunk-local molecule indices
        chunk = []
        for i in _epoch_order(self):
            m = self.data[i]
            n = len(m["z"])
            for s in range(len(fills)):
                if (fills[s] + n <= self.n_max
                        and len(members[s]) < self.max_per_slot):
                    fills[s] += n
                    members[s].append(len(chunk))
                    break
            else:
                if len(fills) == self.num_slots:
                    yield self._packed(chunk, members)
                    fills, members, chunk = [], [], []
                fills.append(n)
                members.append([len(chunk)])
            chunk.append(m)
        # ragged tail dropped when shuffling (training), emitted otherwise
        if chunk and not self.shuffle:
            yield self._packed(chunk, members)


class BucketedDenseMoleculeLoader:
    """Dense minibatches bucketed by slot size: a batch is a dict
    ``{n_max: DenseGraphBatch}`` with a fixed slot count per bucket.

    Each molecule goes to the smallest bucket that fits it; several small
    molecules may share a slot (``nodes['mol']``). Batches are emitted only
    when every bucket is full; with ``shuffle`` the ragged tail is dropped,
    otherwise it is emitted padded.
    """

    def __init__(self, data, slot_counts: Dict[int, int],
                 max_per_slot: int = 2, shuffle: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.data = list(data)
        self.slot_counts = dict(sorted(slot_counts.items()))
        self.sizes = list(self.slot_counts)
        if any(len(m["z"]) > self.sizes[-1] for m in self.data):
            raise ValueError(f"molecule larger than biggest bucket "
                             f"{self.sizes[-1]}")
        self.max_per_slot = max_per_slot
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def _emit(self, state):
        out = {}
        for n_max, G in self.slot_counts.items():
            fills, members, chunk = state[n_max]
            if not chunk:
                # an eval-mode tail flush can leave a bucket empty: keep the
                # batch structure, packing one truncated template molecule
                # and masking it out
                tmpl = dict(self.data[0])
                n = min(len(tmpl["z"]), n_max)
                for k, v in list(tmpl.items()):
                    if (k != "y" and np.ndim(v) >= 1
                            and np.shape(v)[0] == len(self.data[0]["z"])):
                        tmpl[k] = np.asarray(v)[:n]
                b = packed_dense_batch_np([tmpl], G, n_max, self.max_per_slot,
                                          slots=[[0]], device=self.device)
                out[n_max] = b.replace(
                    node_mask=torch.zeros_like(b.node_mask),
                    globals={**b.globals, "mol_mask":
                             torch.zeros_like(b.globals["mol_mask"])})
                continue
            out[n_max] = packed_dense_batch_np(
                chunk, G, n_max, self.max_per_slot, slots=members,
                device=self.device)
        return out

    def _place(self, state, m) -> bool:
        n = len(m["z"])
        bucket = next(s for s in self.sizes if n <= s)
        fills, members, chunk = state[bucket]
        for s in range(len(fills)):
            if (fills[s] + n <= bucket
                    and len(members[s]) < self.max_per_slot):
                fills[s] += n
                members[s].append(len(chunk))
                chunk.append(m)
                return True
        if len(fills) < self.slot_counts[bucket]:
            fills.append(n)
            members.append([len(chunk)])
            chunk.append(m)
            return True
        return False

    def __iter__(self):
        fresh = lambda: {s: ([], [], []) for s in self.sizes}
        full = lambda st: all(len(st[s][0]) == self.slot_counts[s]
                              for s in self.sizes)
        state = fresh()                 # bucket -> (fills, members, chunk)
        pending: List[int] = []         # indices waiting on a full bucket
        for i in _epoch_order(self):
            if not self._place(state, self.data[i]):
                pending.append(i)
            while full(state):
                yield self._emit(state)
                state = fresh()
                pending = [j for j in pending
                           if not self._place(state, self.data[j])]
        if not self.shuffle:            # eval: flush everything, padded
            while pending:
                rest = [j for j in pending
                        if not self._place(state, self.data[j])]
                if len(rest) == len(pending):   # no progress: emit + reset
                    yield self._emit(state)
                    state = fresh()
                pending = rest
            if any(state[s][2] for s in self.sizes):
                yield self._emit(state)


def _molecule_graph(m):
    nodes = {"z": m["z"], "pos": m["pos"]}
    if "force" in m:
        nodes["force"] = m["force"]
    glb = {"y": np.atleast_1d(m["y"])}
    if "cell" in m:
        glb["cell"] = m["cell"]
    return {"nodes": nodes, "globals": glb,
            "senders": np.zeros(0, np.int32),
            "receivers": np.zeros(0, np.int32)}


class BucketedMoleculeLoader:
    """Slot-bucketed batches for the slot / NK models: each batch is a dict
    ``{slot_size: GraphBatch}`` with a fixed graph count per bucket.

    Each molecule goes to the smallest bucket that fits it; a batch is
    emitted once every bucket holds its count, the surplus waiting for the
    next batch. The consumer applies the model once per bucket at that
    slot size (``make_bucketed_step_fns``). ``slot_counts`` maps slot size
    to graphs per batch. With ``shuffle`` (reshuffled each epoch from
    ``seed + epoch``) the ragged tail is dropped; otherwise it is emitted,
    an under-filled bucket padded with empty graphs and an empty one
    holding one masked template molecule, so every batch has every
    bucket.
    """

    def __init__(self, data, slot_counts: Dict[int, int],
                 shuffle: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.data = list(data)
        self.slot_counts = dict(sorted(slot_counts.items()))
        self.sizes = list(self.slot_counts)
        big = max(len(m["z"]) for m in self.data)
        if big > self.sizes[-1]:
            raise ValueError(f"molecule with {big} atoms exceeds largest "
                             f"bucket {self.sizes[-1]}")
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def _batch(self, graphs, s, G):
        return batch_np(graphs, G * s, n_edge_pad=1, num_graphs=G,
                        slot_size=s, device=self.device)

    def _emit(self, state):
        out = {}
        for s, G in self.slot_counts.items():
            chunk = state[s][:G]
            if not chunk:
                # keep every bucket in every batch: one truncated template
                # molecule, masked out
                t = dict(self.data[0])
                n = min(len(t["z"]), s)
                for k, v in list(t.items()):
                    if (k != "y" and np.ndim(v) >= 1
                            and np.shape(v)[0] == len(self.data[0]["z"])):
                        t[k] = np.asarray(v)[:n]
                b = self._batch([_molecule_graph(t)], s, G)
                out[s] = b.replace(node_mask=torch.zeros_like(b.node_mask),
                                   graph_mask=torch.zeros_like(b.graph_mask))
            else:
                out[s] = self._batch([_molecule_graph(m) for m in chunk], s,
                                     G)
            state[s] = state[s][G:]
        return out

    def __iter__(self) -> Iterator[Dict[int, GraphBatch]]:
        state = {s: [] for s in self.sizes}
        for i in _epoch_order(self):
            m = self.data[i]
            s = next(t for t in self.sizes if len(m["z"]) <= t)
            state[s].append(m)
            if all(len(state[t]) >= self.slot_counts[t] for t in self.sizes):
                yield self._emit(state)
        while not self.shuffle and any(len(v) for v in state.values()):
            yield self._emit(state)
