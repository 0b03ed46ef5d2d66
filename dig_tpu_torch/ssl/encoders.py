"""Graph encoders for SSL: GIN / GCN / ResGCN stacks on flat padded batches.
Port of ``dig_tpu/ssl/encoders.py``.

Parity with ``dig/sslgraph/utils/encoders.py``: GIN conv is
MLP((1+eps) x_i + sum_j x_j) with a 2-layer MLP (encoders.py:103-107); GCN is
sym-normalized D^-1/2 (A+I) D^-1/2 X W (PyG GCNConv semantics); the encoder
returns per-layer sum/mean-pooled graph embeddings concatenated
(encoders.py:128-134) and the final node embedding. ResGCN is the
residual GCN stack used for semi-supervised finetuning
(encoders.py:284-392). BatchNorm is masked batch statistics (padding rows
excluded).

Routes. Every sum with a gradient goes through the sorted-CSR segment sum
(the kernel of ``csrc/segment_csr.cu`` on a CUDA tensor, its plain version
on the CPU), so a step repeats bit for bit on the card and no float
``index_add_`` runs in its forward or backward there:

* the neighbour sum ``sum_j coef_ij x_j`` over ``g.receivers`` is
  ``ops.segment.spmm_bidir_csr`` on an :class:`EdgePlan`, built once per
  batch and shared by every layer: the edges in a stable receiver order of
  the masked receivers (their ``x[senders]`` rows gathered in that order),
  summed by receiver, and in the adjoint the cotangent rows summed by
  sender (the row gather's adjoint, as ``gather_rows``'). The receivers of
  a batch are not sorted (``synthetic_graph_dataset`` lists edges by
  sender, ``EdgePerturbation`` writes new edges into free slots), so the
  plan sorts them;
* the per-graph pooling is ``ops.segment.readout_sum`` (the mean divides
  by the real-node count, an integer count).

The JAX package sums the same terms with ``jax.ops.segment_sum``: the
function is the same, the order of the sums may differ. ``gcn_norm``'s
degree count has no gradient and stays ``index_add_``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..nn.init import xavier_uniform
from ..ops.segment import readout_sum, segment_sum, spmm_bidir_csr
from ..ops.segment_csr import full_window


class EdgePlan(NamedTuple):
    """A batch's edges in a stable order of their masked receivers (masked
    edges last), with the reverse tables of ``spmm_bidir_csr``: ``perm``
    the order, ``senders`` the senders in it, ``recv_ids`` the receivers
    (-1 on masked edges), ``rowptr`` their row pointer; ``rev_perm`` sorts
    those edges by sender (masked last), ``send_ids_sorted`` the senders in
    that order (-1 on masked), ``rowptr_rev`` their row pointer."""

    perm: torch.Tensor
    senders: torch.Tensor
    recv_ids: torch.Tensor
    rowptr: torch.Tensor
    rev_perm: torch.Tensor
    send_ids_sorted: torch.Tensor
    rowptr_rev: torch.Tensor


@torch.no_grad()
def edge_plan(g: GraphBatch) -> EdgePlan:
    """The :class:`EdgePlan` of ``g`` (on its device, no host sync)."""
    N = g.num_nodes
    ar = torch.arange(N + 1, device=g.receivers.device)
    key = torch.where(g.edge_mask, g.receivers.long(), N)
    perm = torch.argsort(key, stable=True)
    key = key[perm]
    real = key < N
    senders = g.senders.long()[perm]
    skey = torch.where(real, senders, N)
    rev_perm = torch.argsort(skey, stable=True)
    skey = skey[rev_perm]
    return EdgePlan(
        perm=perm, senders=senders,
        recv_ids=torch.where(real, key, -1).to(torch.int32),
        rowptr=torch.searchsorted(key, ar, out_int32=True),
        rev_perm=rev_perm,
        send_ids_sorted=torch.where(skey < N, skey, -1).to(torch.int32),
        rowptr_rev=torch.searchsorted(skey, ar, out_int32=True))


def neighbour_sum(x: torch.Tensor, plan: EdgePlan,
                  coef: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = sum over real edges j->i of coef[e] * x[j]`` (``coef`` per
    edge in the batch's edge order, a constant; None: 1 on the real
    edges), through ``spmm_bidir_csr`` on ``plan``."""
    real = plan.recv_ids >= 0
    if coef is None:
        c = real.to(x.dtype)
    else:
        c = torch.where(real, coef.detach()[plan.perm], 0.0).to(x.dtype)
    E = plan.perm.shape[0]
    return spmm_bidir_csr(x, c, plan.senders, plan.recv_ids, plan.rowptr,
                          plan.rev_perm, plan.send_ids_sorted,
                          plan.rowptr_rev, x.shape[0], full_window(E), 32)


def pool_graphs(h: torch.Tensor, g: GraphBatch, pool: str) -> torch.Tensor:
    """Per-graph sum (``pool == "sum"``) or mean of the real node rows:
    ``readout_sum``, the mean divided by the real-node count (at least
    1)."""
    s = readout_sum(h, g.node_graph, g.num_graphs, g.node_mask)
    if pool == "sum":
        return s
    cnt = torch.zeros(g.num_graphs, dtype=torch.int32, device=h.device)
    cnt.index_add_(0, g.node_graph.long(), g.node_mask.to(torch.int32))
    return s / torch.clamp(cnt, min=1).to(s.dtype)[:, None]


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers of these modules, drawn from ``generator`` in
    module order: Glorot-uniform ``Linear`` weights, zero biases, PReLU
    slopes 0.25, batch-norm scale 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            w = torch.empty(m.weight.shape)
            m.weight.copy_(xavier_uniform(w, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, PReLU):
            m.alpha.fill_(0.25)
        elif isinstance(m, MaskedBatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, GCNConv) and m.bias is not None:
            m.bias.zero_()


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


def _act(name: str):
    return PReLU() if name == "prelu" else nn.ReLU()


class MaskedBatchNorm(nn.Module):
    """BatchNorm over real (masked) rows only; padding rows would otherwise
    poison the batch statistics. Stateless (uses batch stats, as the
    reference's train-mode BN does during pretraining)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask):
        m = mask[:, None].to(x.dtype)
        cnt = torch.clamp(torch.sum(m), min=1.0)
        mean = torch.sum(x * m, 0) / cnt
        var = torch.sum(((x - mean) ** 2) * m, 0) / cnt
        y = (x - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias
        return torch.where(mask[:, None], y, 0.0)


def gcn_norm(senders, receivers, edge_mask, num_nodes, edge_weight=None,
             add_self_loops: bool = True):
    """Symmetric GCN normalization coefficients per edge (+ self-loop term).

    Returns (edge_coef [E], self_coef [N]); with self loops the aggregation
    is sum_j coef_ij x_j + self_coef_i x_i, matching PyG GCNConv.
    """
    w = edge_weight if edge_weight is not None else torch.ones(
        senders.shape[0], device=senders.device)
    w = torch.where(edge_mask, w, 0.0)
    deg = segment_sum(w, receivers, num_nodes, mask=edge_mask)
    if add_self_loops:
        deg = deg + 1.0
    dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
    coef = dinv[receivers.long()] * w * dinv[senders.long()]
    self_coef = dinv * dinv if add_self_loops else torch.zeros_like(dinv)
    return coef, self_coef


class GCNConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 add_self_loops: bool = True, normalize: bool = True):
        super().__init__()
        self.lin = nn.Linear(in_dim, out_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None
        self.add_self_loops = add_self_loops
        self.normalize = normalize

    def forward(self, x, g: GraphBatch, edge_weight=None,
                plan: Optional[EdgePlan] = None):
        plan = edge_plan(g) if plan is None else plan
        h = self.lin(x)
        N = g.num_nodes
        if self.normalize:
            coef, self_coef = gcn_norm(g.senders, g.receivers, g.edge_mask,
                                       N, edge_weight, self.add_self_loops)
        else:
            coef = (edge_weight if edge_weight is not None
                    else torch.ones(g.num_edges, device=x.device))
            coef = torch.where(g.edge_mask, coef, 0.0)
            self_coef = torch.zeros(N, device=x.device)
        agg = neighbour_sum(h, plan, coef) + self_coef[:, None] * h
        if self.bias is not None:
            agg = agg + self.bias
        return agg


class GINConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 train_eps: bool = False):
        super().__init__()
        self.lin1 = nn.Linear(in_dim, out_dim, bias=bias)
        self.lin2 = nn.Linear(out_dim, out_dim, bias=bias)
        self.eps = nn.Parameter(torch.zeros(())) if train_eps else None

    def forward(self, x, g: GraphBatch, plan: Optional[EdgePlan] = None):
        plan = edge_plan(g) if plan is None else plan
        agg = neighbour_sum(x, plan)
        h = x if self.eps is None else (1.0 + self.eps) * x
        h = self.lin1(h + agg)
        return self.lin2(torch.relu(h))


class _Stack(nn.Module):
    """GIN / GCN: n_layers convs, a shared activation, optional masked
    batch norm; per-layer pooled embeddings concatenated."""

    def __init__(self, conv, feat_dim, hidden_dim, n_layers, pool, bn, act):
        super().__init__()
        self.convs = nn.ModuleList(
            conv(feat_dim if i == 0 else hidden_dim, hidden_dim)
            for i in range(n_layers))
        self.act = _act(act)
        self.bns = (nn.ModuleList(MaskedBatchNorm(hidden_dim)
                                  for _ in range(n_layers)) if bn else None)
        self.pool = pool

    def _conv(self, conv, x, g, plan):
        return conv(x, g, plan=plan)

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        plan = edge_plan(g)
        x = g.nodes["x"]
        xs = []
        for i, conv in enumerate(self.convs):
            x = self.act(self._conv(conv, x, g, plan))
            if self.bns is not None:
                x = self.bns[i](x, g.node_mask)
            x = torch.where(g.node_mask[:, None], x, 0.0)
            xs.append(x)
        return torch.cat([pool_graphs(h, g, self.pool) for h in xs], 1), x


class GIN(_Stack):
    def __init__(self, feat_dim: int, hidden_dim: int, n_layers: int = 3,
                 pool: str = "sum", bn: bool = False, act: str = "relu"):
        super().__init__(GINConv, feat_dim, hidden_dim, n_layers, pool, bn,
                         act)


class GCN(_Stack):
    def __init__(self, feat_dim: int, hidden_dim: int, n_layers: int = 3,
                 pool: str = "sum", bn: bool = False, act: str = "relu",
                 edge_weight: bool = False):
        conv = lambda i, o: GCNConv(i, o, add_self_loops=not edge_weight,
                                    normalize=not edge_weight)
        super().__init__(conv, feat_dim, hidden_dim, n_layers, pool, bn, act)
        self.edge_weight = edge_weight

    def _conv(self, conv, x, g, plan):
        ew = g.edges.get("w") if self.edge_weight else None
        return conv(x, g, ew, plan=plan)


class ResGCN(nn.Module):
    """Residual GCN with feature/conv/fc stages (reference
    encoders.py:284-392, used by GraphSemisupervised)."""

    def __init__(self, feat_dim: int, hidden_dim: int,
                 num_conv_layers: int = 3, num_feat_layers: int = 1,
                 num_fc_layers: int = 2, pool: str = "sum"):
        super().__init__()
        self.feats = nn.ModuleList(
            nn.Linear(feat_dim if i == 0 else hidden_dim, hidden_dim)
            for i in range(num_feat_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(hidden_dim)
                                 for _ in range(num_conv_layers))
        self.convs = nn.ModuleList(GCNConv(hidden_dim, hidden_dim)
                                   for _ in range(num_conv_layers))
        self.fcs = nn.ModuleList(nn.Linear(hidden_dim, hidden_dim)
                                 for _ in range(num_fc_layers - 1))
        self.pool = pool

    def forward(self, g: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        plan = edge_plan(g)
        x = g.nodes["x"]
        for lin in self.feats:
            x = torch.relu(lin(x))
        x = torch.where(g.node_mask[:, None], x, 0.0)
        for bn, conv in zip(self.bns, self.convs):
            h = torch.relu(conv(bn(x, g.node_mask), g, plan=plan))
            x = x + torch.where(g.node_mask[:, None], h, 0.0)
        zg = pool_graphs(x, g, self.pool)
        for lin in self.fcs:
            zg = torch.relu(lin(zg))
        return zg, x


class Encoder(nn.Module):
    """Wrapper selecting GIN/GCN/ResGCN + output levels (reference
    encoders.py:14-83). Returns graph-level, node-level, or both.

    ``feat_dim`` is the input width (flax infers it at init). Weights are
    drawn from ``generator`` (:func:`init_weights`; None: seed 0), the
    module placed on ``device`` (None: the card)."""

    def __init__(self, feat_dim: int, hidden_dim: int, n_layers: int = 5,
                 pool: str = "sum", gnn: str = "gin", bn: bool = False,
                 act: str = "relu", node_level: bool = False,
                 graph_level: bool = True, edge_weight: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.feat_dim, self.hidden_dim, self.n_layers = (feat_dim, hidden_dim,
                                                         n_layers)
        self.gnn = gnn
        self.node_level, self.graph_level = node_level, graph_level
        if gnn == "gin":
            self.encoder = GIN(feat_dim, hidden_dim, n_layers, pool, bn, act)
        elif gnn == "gcn":
            self.encoder = GCN(feat_dim, hidden_dim, n_layers, pool, bn, act,
                               edge_weight)
        elif gnn == "resgcn":
            self.encoder = ResGCN(feat_dim, hidden_dim,
                                  num_conv_layers=n_layers, pool=pool)
        else:
            raise ValueError(f"unknown gnn {gnn}")
        init_weights(self, generator or torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, g: GraphBatch):
        z_g, z_n = self.encoder(g)
        if self.node_level and self.graph_level:
            return z_g, z_n
        if self.graph_level:
            return z_g
        return z_n

    @property
    def z_dim(self) -> int:
        if self.gnn == "resgcn":
            return self.hidden_dim
        return self.hidden_dim * self.n_layers
