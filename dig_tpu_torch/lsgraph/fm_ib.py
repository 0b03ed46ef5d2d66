"""GraphFMIB — in-batch feature momentum over neighbor-sampled batches.
Port of ``dig_tpu/lsgraph/fm_ib.py``.

Parity with the reference's IB variant
(``examples/lsgraph/GraphFMIB/reddit_example.py:15-200``): a
NeighborSampler-style k-hop minibatch (per-layer bipartite blocks,
target nodes placed first), mean aggregation, and per-layer historical
embeddings blended at the sampling boundary —

    agg = (1 - alpha) * agg + alpha * hist[i][targets]     (:141-143)
    hist[i][targets] <- agg (detached)

followed by ``lin_l(agg) + lin_r(x_target)`` (:146). Inference is the
layer-wise full-graph pass (:153-180), which ignores the histories.

The sampler runs on the host (numpy, copied from the JAX package, so one
seed gives the same batches in both packages) and emits static-shape
:class:`NeighborBatch` es — per-layer node caps ``B * (fanout+1)^d`` and
edge caps ``cap * fanout`` with validity masks, nested so every layer's
node set is a prefix of the previous one. Histories are tables threaded
through the step by the caller (the ScalableGNN convention); a push writes
only the real rows. The aggregation is the plain ``segment_sum``
(``index_add_``), as the JAX one is XLA's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn.init import xavier_uniform
from ..ops.segment import segment_sum
from .history import write_rows


class NeighborBatch(NamedTuple):
    """One k-hop sampled minibatch. L layers; caps[d] nodes at depth d
    (depth 0 = innermost/largest set, depth L = the B target nodes).
    ``n_id[:caps[d]]`` is the depth-d node set (prefix nesting)."""
    n_id: np.ndarray                 # [caps[0]] global node ids
    node_mask: np.ndarray            # [caps[0]] valid rows
    src_idx: tuple                   # per layer: [E_l] local src (depth l)
    dst_idx: tuple                   # per layer: [E_l] local dst (depth l+1)
    edge_mask: tuple                 # per layer: [E_l]
    batch_size: int


class NeighborSampledLoader:
    """Static-shape neighbor sampler (reference
    ``torch_geometric.data.NeighborSampler`` role, reddit_example.py:63).

    ``sizes[l]`` = fanout of layer l (applied innermost-first like the
    reference); every batch ships identical shapes.
    """

    def __init__(self, senders, receivers, num_nodes: int,
                 node_idx, sizes: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        order = np.argsort(receivers, kind="stable")
        self.col = np.asarray(senders)[order]
        rp = np.zeros(num_nodes + 1, np.int64)
        np.add.at(rp, np.asarray(receivers) + 1, 1)
        self.rowptr = np.cumsum(rp)
        self.nodes = np.flatnonzero(node_idx) if node_idx.dtype == bool \
            else np.asarray(node_idx)
        self.sizes = list(sizes)
        self.L = len(self.sizes)
        self.B = batch_size
        self.N = num_nodes
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        # caps[d]: max nodes at depth d (depth L = targets)
        self.caps = [batch_size]
        for f in self.sizes:        # innermost fanout first, like reference
            self.caps.insert(0, self.caps[0] * (f + 1))

    def __iter__(self):
        ids = self.nodes.copy()
        if self.shuffle:
            self.rng.shuffle(ids)
        for lo in range(0, len(ids) - self.B + 1, self.B):
            yield self._sample(ids[lo:lo + self.B])

    def _sample(self, batch_ids):
        L, caps = self.L, self.caps
        cur = list(batch_ids)
        pos = {int(g): i for i, g in enumerate(cur)}
        src_idx, dst_idx, edge_mask = [None] * L, [None] * L, [None] * L
        # depth L (targets) down to depth 0: layer l bipartite block is
        # (src at depth l, dst at depth l+1); reference applies adjs
        # outermost-first, so sizes[0] is the innermost fanout
        for l in range(L - 1, -1, -1):
            f = self.sizes[L - 1 - l]
            n_dst = len(cur)
            cap_src, e_cap = caps[l], caps[l + 1] * f
            s_loc, d_loc = [], []
            for d in range(n_dst):
                g = int(cur[d])
                nbrs = self.col[self.rowptr[g]:self.rowptr[g + 1]]
                if len(nbrs) > f:
                    nbrs = self.rng.choice(nbrs, size=f, replace=False)
                for nb in nbrs:
                    nb = int(nb)
                    if nb not in pos:
                        if len(cur) >= cap_src:
                            continue          # cap hit: drop the sample
                        pos[nb] = len(cur)
                        cur.append(nb)
                    s_loc.append(pos[nb])
                    d_loc.append(d)
            si = np.zeros(e_cap, np.int32)
            di = np.zeros(e_cap, np.int32)
            em = np.zeros(e_cap, bool)
            k = len(s_loc)
            si[:k] = s_loc
            di[:k] = d_loc
            em[:k] = True
            src_idx[l], dst_idx[l], edge_mask[l] = si, di, em
        n_id = np.zeros(caps[0], np.int64)
        nm = np.zeros(caps[0], bool)
        n_id[:len(cur)] = cur
        nm[:len(cur)] = True
        return NeighborBatch(n_id=n_id, node_mask=nm,
                             src_idx=tuple(src_idx), dst_idx=tuple(dst_idx),
                             edge_mask=tuple(edge_mask), batch_size=self.B)


def _mean_agg(x, src, dst, em, num_dst):
    """Mean of the unmasked messages x[src] per dst row (0 where none)."""
    msg = torch.where(em[:, None], x[src], 0.0)
    ssum = segment_sum(msg, dst, num_dst)
    cnt = segment_sum(em.to(x.dtype), dst, num_dst)
    return ssum / torch.clamp(cnt, min=1.0)[:, None]


class GraphFMIB(nn.Module):
    """In-batch feature-momentum GNN (reference GNN class,
    reddit_example.py:97-180). Functional histories: ``forward`` returns
    the updated tuple. Layer i is ``lin_l[i]`` (with bias) on the
    aggregate plus ``lin_r[i]`` (without) on the targets' own rows; the
    weights are drawn from ``generator`` (:meth:`init`), the histories made
    on ``device`` (``None``: the card). :meth:`bind` takes a loader's caps
    before the first forward."""

    def __init__(self, num_nodes: int, in_channels: int, hidden: int,
                 out_channels: int, num_layers: int, alpha: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.N = num_nodes
        self.dims = ([in_channels] + [hidden] * (num_layers - 1)
                     + [out_channels])
        self.L = num_layers
        self.alpha = alpha
        self.caps = None
        self.lin_l = nn.ModuleList(
            nn.Linear(self.dims[i], self.dims[i + 1])
            for i in range(num_layers))
        self.lin_r = nn.ModuleList(
            nn.Linear(self.dims[i], self.dims[i + 1], bias=False)
            for i in range(num_layers))
        self.init(generator or torch.Generator().manual_seed(0))
        self.to(device)
        # hist[i] holds the PRE-MLP aggregated embedding of layer i, so
        # its width is layer i's input dim (layer_emb_sizes, :195-200)
        self.histories = tuple(
            torch.zeros((num_nodes, self.dims[i]), device=device)
            for i in range(num_layers))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GraphFMIB":
        """Draw every weight anew from ``generator`` (Glorot-uniform
        kernels, zero biases, as the flax ``Dense`` defaults)."""
        for lin in (*self.lin_l, *self.lin_r):
            lin.weight.copy_(xavier_uniform(torch.empty(lin.weight.shape),
                                            generator))
            if lin.bias is not None:
                lin.bias.zero_()
        return self

    def bind(self, loader: NeighborSampledLoader) -> "GraphFMIB":
        self.caps = tuple(loader.caps)
        return self

    def _tensors(self, batch: NeighborBatch,
                      device: DeviceLike = None) -> NeighborBatch:
        """``batch`` with its arrays as int64 / bool tensors on ``device``
        (``None``: the card)."""
        dev = resolve_device(device)

        def t(a):
            a = np.asarray(a)
            return torch.as_tensor(a, dtype=torch.bool if a.dtype == bool
                                   else torch.int64).to(dev)
        return NeighborBatch(
            n_id=t(batch.n_id), node_mask=t(batch.node_mask),
            src_idx=tuple(map(t, batch.src_idx)),
            dst_idx=tuple(map(t, batch.dst_idx)),
            edge_mask=tuple(map(t, batch.edge_mask)),
            batch_size=batch.batch_size)

    def forward(self, hists, x_full: torch.Tensor, batch: NeighborBatch):
        """Log-probabilities of the batch's targets ``[B, out]`` and the
        new histories."""
        if self.caps is None:
            raise RuntimeError("GraphFMIB: bind(loader) before forward")
        b = self._tensors(batch, x_full.device)
        x = x_full[b.n_id]
        new_h = list(hists)
        for i in range(self.L):
            cap_dst = self.caps[i + 1]
            x_t = x[:cap_dst]
            agg = _mean_agg(x, b.src_idx[i], b.dst_idx[i], b.edge_mask[i],
                            cap_dst)
            if self.alpha > 0:
                tid = b.n_id[:cap_dst]
                agg = (1.0 - self.alpha) * agg + self.alpha * hists[i][tid]
                new_h[i] = write_rows(hists[i], tid, agg,
                                      b.node_mask[:cap_dst])
            x = self.lin_l[i](agg) + self.lin_r[i](x_t)
            if i != self.L - 1:
                x = torch.relu(x)
        return torch.log_softmax(x[:self.caps[-1]], dim=-1), tuple(new_h)

    @torch.no_grad()
    def full_inference(self, x_full: torch.Tensor, senders, receivers,
                       edge_mask=None) -> torch.Tensor:
        """Layer-wise full-graph inference (reddit_example.py:153-180);
        histories are NOT consulted, matching the reference."""
        x = x_full
        dev = x.device
        s = torch.as_tensor(np.asarray(senders), dtype=torch.int64).to(dev)
        r = torch.as_tensor(np.asarray(receivers), dtype=torch.int64).to(dev)
        em = (torch.ones(s.shape[0], dtype=torch.bool, device=dev)
              if edge_mask is None else
              torch.as_tensor(np.asarray(edge_mask), dtype=torch.bool).to(dev))
        for i in range(self.L):
            agg = _mean_agg(x, s, r, em, self.N)
            x_new = self.lin_l[i](agg) + self.lin_r[i](x)
            x = torch.relu(x_new) if i != self.L - 1 else x_new
        return torch.log_softmax(x, dim=-1)
