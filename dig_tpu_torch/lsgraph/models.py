"""Scalable GNN models with historical embeddings. Port of
``dig_tpu/lsgraph/models.py``.

Parity with ``dig/lsgraph/method/GraphFMOB/models/{base.py,gcn.py,gcn2.py,
pna.py,pna_jk.py}``: ``ScalableGNN`` owns ``num_layers - 1`` histories;
each layer's conv runs on the (in-batch + halo) subgraph, exact in-batch
embeddings are pushed into history, and halo rows for the next layer are
pulled from history (``push_and_pull``, base.py:159-199). ``mini_inference``
runs layer-wise full-graph inference over an EvalSubgraphLoader
(base.py:200-259). The histories are tables the caller threads through
the steps: ``forward`` returns the new ones.

The GCN / GCNII aggregation ``out[r] = sum_e coef[e] * h[senders[e]]``
(:func:`_aggregate`) takes one of four routes:

* SELL plans in both directions (``ops.segment.spmm_bidir_sell``, plain
  PyTorch), the JAX route for a host-side SubData;
* on a CUDA tensor with ``segment_eb > 0``, the sorted-CSR kernel of
  ``csrc/segment_csr.cu`` in both directions (``ops.segment.spmm_bidir_csr``:
  the forward by receiver, the adjoint by sender through the reverse-CSR
  tables), the JAX ``_on_tpu()`` route;
* on the CPU with ``segment_eb > 0``, ``segment_sum_sorted`` (its plain
  version);
* ``segment_sum`` (``index_add_``).

``ScalableGNN(sell=None)`` takes SELL except on a CUDA tensor with
``segment_eb > 0``: the JAX package's order for a host-side SubData (the
loaders hand out host-side ones), save that the card prefers the kernel.
(The JAX preference for SELL rests on a TPU measurement, which says
nothing of this card, where SELL in plain PyTorch is a gather, a reduction
and a concatenation per width bucket.) ``sell=False`` gives the JAX
routes for a SubData traced under ``jit``; ``sell=True`` forces SELL.
The function is the same on every route; the sums differ in order only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn.init import xavier_uniform
from ..ops.segment import (segment_max, segment_mean, segment_min,
                           segment_sum, segment_sum_sorted, spmm_bidir_csr,
                           spmm_bidir_sell)
from .history import FeatureMomentum, History
from .loader import EvalSubgraphLoader, SubData, SubTensors


def _sub_gcn_norm(senders, receivers, edge_mask, num_rows):
    ones = torch.where(edge_mask, 1.0, 0.0)
    deg_in = segment_sum(ones, receivers, num_rows) + 1.0
    deg_out = segment_sum(ones, senders, num_rows) + 1.0
    di = torch.rsqrt(deg_in)
    do = torch.rsqrt(deg_out)
    coef = di[receivers] * do[senders]
    return torch.where(edge_mask, coef, 0.0), di * di


def _aggregate(h, coef, t: SubTensors, plans, segment_eb: int,
               segment_br: int):
    """out[r] = sum_e coef[e] * h[senders[e]] over the subgraph ``t``:
    through the SELL ``plans`` when given, else the route of the module
    docstring."""
    N = h.shape[0]
    if plans is not None:
        plan_fwd, rev_perm, plan_rev = plans
        return spmm_bidir_sell(h, coef, t.senders, t.recv_ids, plan_fwd,
                               rev_perm, plan_rev)
    if segment_eb > 0 and h.is_cuda:
        return spmm_bidir_csr(h, coef, t.senders, t.recv_ids, t.rowptr,
                              t.rev_perm, t.send_ids_sorted, t.rowptr_rev, N,
                              segment_eb, segment_br)
    msg = h[t.senders] * coef[:, None]
    if segment_eb > 0:
        return segment_sum_sorted(msg, t.receivers, N, mask=t.edge_mask,
                                  max_edges_per_block=segment_eb)
    return segment_sum(msg, t.receivers, N, mask=t.edge_mask)


class _GCNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, segment_eb: int,
                 segment_br: int):
        super().__init__()
        self.lin = nn.Linear(in_dim, out_dim)
        self.segment_eb, self.segment_br = segment_eb, segment_br

    def forward(self, x, t: SubTensors, plans):
        h = self.lin(x)
        coef, self_coef = _sub_gcn_norm(t.senders, t.receivers, t.edge_mask,
                                        x.shape[0])
        agg = _aggregate(h, coef, t, plans, self.segment_eb, self.segment_br)
        return agg + self_coef[:, None] * h


class _GCN2Layer(nn.Module):
    """GCNII layer: initial residual + identity map (reference gcn2.py)."""

    def __init__(self, dim: int, segment_eb: int, segment_br: int,
                 alpha: float = 0.1, beta: float = 0.5):
        super().__init__()
        self.lin = nn.Linear(dim, dim, bias=False)
        self.alpha, self.beta = alpha, beta
        self.segment_eb, self.segment_br = segment_eb, segment_br

    def forward(self, x, x0, t: SubTensors, plans):
        coef, self_coef = _sub_gcn_norm(t.senders, t.receivers, t.edge_mask,
                                        x.shape[0])
        agg = _aggregate(x, coef, t, plans, self.segment_eb, self.segment_br)
        agg = agg + self_coef[:, None] * x
        h = (1 - self.alpha) * agg + self.alpha * x0
        return (1 - self.beta) * h + self.beta * self.lin(h)


class _PNALayer(nn.Module):
    """Principal Neighborhood Aggregation: mean/max/min/std aggregators x
    identity/amplify/attenuate degree scalers (reference pna.py)."""

    def __init__(self, in_dim: int, out_dim: int, avg_deg_log: float):
        super().__init__()
        self.lin = nn.Linear(13 * in_dim, out_dim)
        self.avg_deg_log = avg_deg_log

    def forward(self, x, t: SubTensors):
        N = x.shape[0]
        r, em = t.receivers, t.edge_mask
        msgs = x[t.senders]
        mean = segment_mean(msgs, r, N, mask=em)
        mx = segment_max(msgs, r, N, mask=em)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        mn = segment_min(msgs, r, N, mask=em)
        mn = torch.where(torch.isfinite(mn), mn, 0.0)
        sq = segment_mean(msgs * msgs, r, N, mask=em)
        std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-10))
        deg = segment_sum(torch.where(em, 1.0, 0.0), r, N)
        amp = (torch.log(deg + 1.0) / self.avg_deg_log)[:, None]
        att = 1.0 / torch.clamp(amp, min=1e-2)
        feats = []
        for agg in (mean, mx, mn, std):
            feats += [agg, agg * amp, agg * att]
        return self.lin(torch.cat(feats + [x], dim=-1))


class _ScalableBody(nn.Module):
    """Shared body: conv layers with history pull between them.
    ``arch``: 'gcn' | 'gcn2' | 'pna' | 'pna_jk'."""

    def __init__(self, arch: str, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int, avg_deg_log: float = 1.0,
                 segment_eb: int = 0, segment_br: int = 64):
        super().__init__()
        if arch not in ("gcn", "gcn2", "pna", "pna_jk"):
            raise ValueError(f"unknown arch {arch!r}")
        self.arch, self.num_layers = arch, num_layers
        L = num_layers
        if arch == "gcn":
            self.layers = nn.ModuleList(
                _GCNLayer(in_dim if i == 0 else hidden,
                          out_dim if i == L - 1 else hidden,
                          segment_eb, segment_br) for i in range(L))
        elif arch == "gcn2":
            self.lin_in = nn.Linear(in_dim, hidden)
            self.layers = nn.ModuleList(
                _GCN2Layer(hidden, segment_eb, segment_br) for _ in range(L))
        else:
            self.layers = nn.ModuleList(
                _PNALayer(in_dim if i == 0 else hidden, hidden, avg_deg_log)
                for i in range(L))
        if arch != "gcn":
            width = hidden * L if arch == "pna_jk" else hidden
            self.lin_out = nn.Linear(width, out_dim)

    def forward(self, x, t: SubTensors, hist_values: Sequence[torch.Tensor],
                plans=None):
        push_vals = []
        x0 = None
        if self.arch == "gcn2":
            x = torch.relu(self.lin_in(x))
            x0 = x
        jk = []
        for i, layer in enumerate(self.layers):
            last = i == self.num_layers - 1
            if self.arch == "gcn":
                h = layer(x, t, plans)
            elif self.arch == "gcn2":
                h = layer(x, x0, t, plans)
            else:
                h = layer(x, t)
            if not last or self.arch != "gcn":
                h = torch.relu(h)
            jk.append(h)
            if not last:
                # exact in-batch rows; halo rows come from history
                push_vals.append(h)
                h = torch.where(t.in_batch_mask[:, None], h, hist_values[i])
            x = h
        if self.arch == "pna_jk":
            x = torch.cat(jk, dim=-1)
        if self.arch != "gcn":
            x = self.lin_out(x)
        return x, push_vals


class ScalableGNN(nn.Module):
    """Driver owning the body + histories (reference base.py:16-259).

    ``forward(histories, x_global, sub)`` runs one minibatch and returns
    ``(out, new_histories)``; the module's parameters are the body's.
    ``sell``: the aggregation route (module docstring). Weights are drawn
    from ``generator`` (:meth:`init`), the histories made on ``device``
    (``None``: the card).
    """

    def __init__(self, arch: str, num_nodes: int, in_dim: int, hidden: int,
                 out_dim: int, num_layers: int, use_momentum: bool = False,
                 gamma: float = 0.9, avg_deg: float = 10.0,
                 segment_eb: int = 0, segment_br: int = 64,
                 sell: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.body = _ScalableBody(arch, in_dim, hidden, out_dim, num_layers,
                                  avg_deg_log=float(np.log(avg_deg + 1.0)),
                                  segment_eb=segment_eb,
                                  segment_br=segment_br)
        self.num_layers = num_layers
        self.num_nodes = num_nodes
        self.hidden = hidden
        self.segment_eb = segment_eb
        self.sell = sell
        self.init(generator or torch.Generator().manual_seed(0))
        self.to(device)
        if use_momentum:
            self.histories = [FeatureMomentum.create(num_nodes, hidden,
                                                     gamma=gamma,
                                                     device=device)
                              for _ in range(num_layers - 1)]
        else:
            self.histories = [History.create(num_nodes, hidden,
                                             device=device)
                              for _ in range(num_layers - 1)]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "ScalableGNN":
        """Draw every weight anew from ``generator`` (Glorot-uniform
        kernels, zero biases, as the flax ``Dense`` defaults)."""
        for m in self.body.modules():
            if isinstance(m, nn.Linear):
                w = torch.empty(m.weight.shape)
                m.weight.copy_(xavier_uniform(w, generator))
                if m.bias is not None:
                    m.bias.zero_()
        return self

    def use_sell(self, x: torch.Tensor) -> bool:
        """Whether a forward on ``x``'s device aggregates through SELL."""
        if self.sell is not None:
            return self.sell
        return not (x.is_cuda and self.segment_eb > 0)

    def forward(self, histories, x_global: torch.Tensor, sub: SubData):
        """One minibatch forward. Returns (out, new_histories); ``out``
        rows [0, batch_size) are the in-batch predictions."""
        dev = x_global.device
        t = sub.tensors(dev)
        plans = (sub.sell_plans(dev) if self.use_sell(x_global) and
                 self.body.arch in ("gcn", "gcn2") else None)
        hv = [h.pull(t.n_id) for h in histories]
        out, push_vals = self.body(x_global[t.n_id], t, hv, plans)
        new_hist = []
        for h, v in zip(histories, push_vals):
            h = h.push(v, t.n_id, mask=t.in_batch_mask & t.node_mask)
            if isinstance(h, FeatureMomentum):
                # boundary rows get momentum-blended estimates (FM.py:67-70)
                h = h.push_momentum(v, t.n_id,
                                    mask=t.node_mask & ~t.in_batch_mask)
            new_hist.append(h)
        return out, new_hist

    @torch.no_grad()
    def mini_inference(self, x_global: torch.Tensor,
                       loader: EvalSubgraphLoader) -> torch.Tensor:
        """Layer-wise full-graph inference (base.py:200-259): run layer l
        on every batch before layer l+1, so histories are always fresh."""
        dev = x_global.device
        histories = [History.create(self.num_nodes, self.hidden, device=dev)
                     for _ in range(self.num_layers - 1)]
        out_rows = None
        for _ in range(self.num_layers):
            results = []
            for sub in loader:
                out, histories = self.forward(histories, x_global, sub)
                results.append((sub, out))
            if out_rows is None:
                out_rows = torch.zeros((self.num_nodes, out.shape[-1]),
                                       device=dev)
        for sub, out in results:
            B = sub.batch_size
            out_rows[sub.tensors(dev).n_id[:B]] = out[:B]
        return out_rows


def ScalableGCN(num_nodes, in_dim, hidden, out_dim, num_layers, **kw):
    return ScalableGNN("gcn", num_nodes, in_dim, hidden, out_dim,
                       num_layers, **kw)


def ScalableGCN2(num_nodes, in_dim, hidden, out_dim, num_layers, **kw):
    return ScalableGNN("gcn2", num_nodes, in_dim, hidden, out_dim,
                       num_layers, **kw)


def ScalablePNA(num_nodes, in_dim, hidden, out_dim, num_layers,
                jk: bool = False, **kw):
    return ScalableGNN("pna_jk" if jk else "pna", num_nodes, in_dim, hidden,
                       out_dim, num_layers, **kw)
