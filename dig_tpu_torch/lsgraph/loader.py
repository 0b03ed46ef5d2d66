"""Partition-based subgraph minibatch loader. Port of
``dig_tpu/lsgraph/loader.py`` (numpy, copied).

Parity with ``dig/lsgraph/method/GraphFMOB/{metis.py,loader.py}``:
``metis_permute`` partitions + relabels the graph so each part is a
contiguous node range; ``SubgraphLoader`` yields per-partition(-group)
minibatches with the 1-hop halo appended after the in-batch nodes (the
``relabel_one_hop`` contract), padded to static caps.

Each batch node gathers its in-neighbours: the relabel walks a CSR keyed
by receiver, on the native route as on the numpy one, so both give the
same arrays, edge order included. (The JAX loader hands the native
relabel a CSR keyed by sender, so there each batch node gathers its
out-neighbours, and the order of halo nodes and edges differs from its
numpy route's.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.sell import SellPlan, build_sell_plan
from ..parallel.partition import partition_graph


def _device_key(device: DeviceLike) -> torch.device:
    """The device, with the current card's index where none is given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SubTensors(NamedTuple):
    """A :class:`SubData`'s index tables on one device: int64 node ids
    (gathers and ``index_add_``), int32 CSR tables (the sorted-CSR sum)."""
    senders: torch.Tensor          # [E_pad] int64
    receivers: torch.Tensor        # [E_pad] int64
    recv_ids: torch.Tensor         # [E_pad] int32 receivers, -1 on padding
    edge_mask: torch.Tensor        # [E_pad] bool
    n_id: torch.Tensor             # [N_pad] int64
    node_mask: torch.Tensor        # [N_pad] bool
    in_batch_mask: torch.Tensor    # [N_pad] bool
    rowptr: torch.Tensor           # [N_pad + 1] int32
    rev_perm: torch.Tensor         # [E_pad] int64
    send_ids_sorted: torch.Tensor  # [E_pad] int32
    rowptr_rev: torch.Tensor       # [N_pad + 1] int32


@dataclass(eq=False)
class SubData:
    """One padded subgraph minibatch (reference loader.py SubData).

    All arrays static-size numpy. Nodes [0, batch_size) are in-batch; halo
    rows follow; padding after ``num_nodes``. :meth:`tensors` moves the
    index tables to a device once and keeps them there, and
    :meth:`sell_plans` builds the SELL plans once on the host and keeps
    them on each device, so a training step copies nothing from the host.
    """

    senders: np.ndarray      # [E_pad] local ids
    receivers: np.ndarray    # [E_pad] local ids (receivers < batch_size)
    edge_mask: np.ndarray    # [E_pad]
    n_id: np.ndarray         # [N_pad] global node ids (0 padded)
    node_mask: np.ndarray    # [N_pad]
    batch_size: int          # in-batch node count
    in_batch_mask: np.ndarray  # [N_pad] True for real in-batch rows
    rowptr: np.ndarray       # [N_pad + 1] CSR row pointer (receivers are
    # rowptr-expanded, so this is exact; rows >= batch_size repeat E)
    # reverse-CSR tables: edge permutation sorting by SENDER + the sender
    # rowptr, so the aggregation's adjoint is a sorted sum as well
    # (ops.segment.spmm_bidir_csr / spmm_bidir_sell)
    rev_perm: np.ndarray         # [E_pad]
    send_ids_sorted: np.ndarray  # [E_pad] senders[rev_perm], -1 padding
    rowptr_rev: np.ndarray       # [N_pad + 1]
    _on: Dict = field(default_factory=dict, init=False, repr=False)

    def tensors(self, device: DeviceLike = None) -> SubTensors:
        """The index tables on ``device`` (``None``: the card), moved there
        on the first call and kept."""
        dev = _device_key(device)
        key = ("tensors", dev)
        if key not in self._on:
            def t(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)
            i32, i64 = torch.int32, torch.int64
            self._on[key] = SubTensors(
                senders=t(self.senders, i64),
                receivers=t(self.receivers, i64),
                recv_ids=t(np.where(self.edge_mask, self.receivers, -1), i32),
                edge_mask=t(self.edge_mask, torch.bool),
                n_id=t(self.n_id, i64), node_mask=t(self.node_mask,
                                                    torch.bool),
                in_batch_mask=t(self.in_batch_mask, torch.bool),
                rowptr=t(self.rowptr, i32), rev_perm=t(self.rev_perm, i64),
                send_ids_sorted=t(self.send_ids_sorted, i32),
                rowptr_rev=t(self.rowptr_rev, i32))
        return self._on[key]

    def sell_plans(self, device: DeviceLike = None
                   ) -> "tuple[SellPlan, torch.Tensor, SellPlan]":
        """``(plan of rowptr, rev_perm, plan of rowptr_rev)`` on ``device``
        (``None``: the card); the plans are built on the host once."""
        if "sell" not in self._on:
            self._on["sell"] = (build_sell_plan(self.rowptr, device="cpu"),
                                build_sell_plan(self.rowptr_rev,
                                                device="cpu"))
        dev = _device_key(device)
        key = ("sell", dev)
        if key not in self._on:
            fwd, rev = self._on["sell"]
            self._on[key] = (fwd.to(dev), self.tensors(dev).rev_perm,
                             rev.to(dev))
        return self._on[key]


def metis_permute(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, num_parts: int, seed: int = 0):
    """Partition + permutation so parts are contiguous (metis.py:14-61).
    Returns (perm new->old, ptr part boundaries, part_of)."""
    part_of = partition_graph(np.asarray(senders), np.asarray(receivers),
                              num_nodes, num_parts, seed)
    perm = np.argsort(part_of, kind="stable")   # new -> old
    counts = np.bincount(part_of, minlength=num_parts)
    ptr = np.zeros(num_parts + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return perm, ptr, part_of


class SubgraphLoader:
    """Per-partition(-group) minibatches + 1-hop halo (loader.py:15-109)."""

    def __init__(self, senders, receivers, num_nodes: int, ptr: np.ndarray,
                 perm: np.ndarray, batch_parts: int = 1,
                 shuffle: bool = False, seed: int = 0,
                 n_node_pad: Optional[int] = None,
                 n_edge_pad: Optional[int] = None):
        self.num_nodes = num_nodes
        self.ptr = ptr
        self.perm = perm  # new -> old (we relabel everything to new ids)
        inv = np.empty(num_nodes, np.int64)
        inv[perm] = np.arange(num_nodes)
        self.senders = inv[np.asarray(senders)]
        self.receivers = inv[np.asarray(receivers)]
        self.batch_parts = batch_parts
        self.num_parts = len(ptr) - 1
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        # CSR on receiver side (aggregate into in-batch receivers)
        order = np.argsort(self.receivers, kind="stable")
        self._col = self.senders[order]
        deg = np.bincount(self.receivers, minlength=num_nodes)
        self._rowptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(deg, out=self._rowptr[1:])

        self._batches = self._materialize(n_node_pad, n_edge_pad)

    def _groups(self):
        parts = np.arange(self.num_parts)
        return [parts[i:i + self.batch_parts]
                for i in range(0, self.num_parts, self.batch_parts)]

    def _materialize(self, n_node_pad, n_edge_pad) -> List[SubData]:
        from ..native import available, relabel_one_hop
        batches = []
        raw = []
        max_n = max_e = max_b = 0
        for grp in self._groups():
            idx = np.concatenate([
                np.arange(self.ptr[p], self.ptr[p + 1]) for p in grp])
            B = len(idx)
            out = None
            if available():
                # keyed by receiver: the same CSR as self._rowptr / _col
                out = relabel_one_hop(
                    self.receivers, self.senders, idx, self.num_nodes,
                    max_out_edges=len(self._col),
                    max_out_nodes=self.num_nodes)
            if out is None:
                out = self._relabel_np(idx)
            rowptr, col, n_id = out
            E = int(rowptr[-1])
            raw.append((idx, rowptr, col, n_id))
            max_n = max(max_n, len(n_id))
            max_e = max(max_e, E)
            max_b = max(max_b, B)
        n_pad = n_node_pad or int(max_n * 1.1) + 1
        e_pad = n_edge_pad or int(max_e * 1.1) + 1
        self.batch_size_cap = max_b
        for idx, rowptr, col, n_id in raw:
            B = len(idx)
            E = int(rowptr[-1])
            n = len(n_id)
            senders = np.zeros(e_pad, np.int32)
            receivers = np.zeros(e_pad, np.int32)
            em = np.zeros(e_pad, bool)
            senders[:E] = col
            # receivers: expand rowptr
            recv = np.repeat(np.arange(B), np.diff(rowptr))
            receivers[:E] = recv
            em[:E] = True
            nid = np.zeros(n_pad, np.int64)
            nid[:n] = n_id
            nm = np.zeros(n_pad, bool)
            nm[:n] = True
            ibm = np.zeros(n_pad, bool)
            ibm[:B] = True
            rp = np.full(n_pad + 1, E, np.int32)
            rp[:len(rowptr)] = np.asarray(rowptr, np.int32)
            # reverse CSR: sort real edges by sender, padding edges last
            order = np.argsort(senders[:E], kind="stable")
            rev_perm = np.concatenate(
                [order, np.arange(E, e_pad)]).astype(np.int32)
            sss = np.full(e_pad, -1, np.int32)
            sss[:E] = senders[:E][order]
            counts = np.bincount(senders[:E], minlength=n_pad)
            rpr = np.zeros(n_pad + 1, np.int32)
            rpr[1:] = np.cumsum(counts).astype(np.int32)
            batches.append(SubData(senders=senders, receivers=receivers,
                                   edge_mask=em, n_id=nid, node_mask=nm,
                                   batch_size=B, in_batch_mask=ibm,
                                   rowptr=rp, rev_perm=rev_perm,
                                   send_ids_sorted=sss, rowptr_rev=rpr))
        return batches

    def _relabel_np(self, idx: np.ndarray):
        """numpy fallback with the same contract as the C++ relabel."""
        local = {int(v): i for i, v in enumerate(idx)}
        n_id = list(idx)
        rowptr = [0]
        col = []
        for v in idx:
            for e in range(self._rowptr[v], self._rowptr[v + 1]):
                u = int(self._col[e])
                if u not in local:
                    local[u] = len(n_id)
                    n_id.append(u)
                col.append(local[u])
            rowptr.append(len(col))
        return (np.asarray(rowptr, np.int64), np.asarray(col, np.int64),
                np.asarray(n_id, np.int64))

    def __len__(self):
        return len(self._batches)

    def __iter__(self) -> Iterator[SubData]:
        order = np.arange(len(self._batches))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        for i in order:
            yield self._batches[i]


class EvalSubgraphLoader(SubgraphLoader):
    """batch_parts=1, pre-materialized, fixed order (loader.py:95-109)."""

    def __init__(self, senders, receivers, num_nodes, ptr, perm, **kw):
        kw.pop("shuffle", None)
        super().__init__(senders, receivers, num_nodes, ptr, perm,
                         batch_parts=1, shuffle=False, **kw)
