"""Explain-friendly GNN model zoo. Port of ``dig_tpu/xgraph/models.py``.

Parity with ``dig/xgraph/models/models.py:22-947``: GCN_2l / GCN_3l /
GIN_2l / GIN_3l at graph or node level with the reference's structure
(convs -> ReLU -> readout -> 2-layer FFN for graph level; convs -> ReLU ->
linear for node level). The forward is ``model(g, edge_weight,
return_activations)``; :func:`apply` runs it with a given parameter dict
(``torch.func.functional_call``), the counterpart of flax's
``model.apply(params, ...)``.

Routes. Explainers differentiate the logits with respect to the per-edge
weight, to third order (GNN-LRP), so every neighbour sum is a closed pair
of gathers and sorted-CSR sums that carries gradients to ``x``, ``h`` and
``edge_weight`` at any order:

* an :class:`XPlan` per batch (built once and passed to every layer and
  every call on the same graph): the ssl encoders' ``EdgePlan`` (the
  edges in a stable order of their masked receivers, masked edges last,
  and the reverse tables by sender) and the sender gather's plan built
  from it;
* the edge weights are permuted into that order (``permute_rows``: its
  adjoint is the inverse permutation, a gather);
* the sender rows are gathered by ``gather_rows`` (its adjoint is the
  sorted-CSR sum by sender), multiplied by the coefficients in autograd
  and summed by receiver with ``segment_sum_sorted_csr``, whose adjoint is
  the row gather again.

On a CUDA tensor each sum is the kernel of ``csrc/segment_csr.cu`` (no
atomics, so a mask repeats bit for bit); on the CPU its plain version.
The per-graph ``sum`` and ``mean`` readouts are ``readout_sum`` through
the same kernel; ``max`` is ``segment_max`` with -1e30 on padding rows,
as the JAX package. GCN's degrees count the real in-edges from the row
pointer: sums of 1.0, exact on any route.

The layers are built for the feature width at :meth:`GNNModel.init` (flax
infers it at ``model.init(key, g)``) or :meth:`GNNModel.build`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..graph import GraphBatch
from ..nn.init import xavier_uniform
from ..ops.segment import GatherPlan, gather_rows, permute_rows, segment_max
from ..ops.segment_csr import full_window, segment_sum_sorted_csr
from ..ssl.encoders import EdgePlan, edge_plan, pool_graphs

EdgeWeight = Union[None, torch.Tensor, Sequence[torch.Tensor]]


class XPlan(NamedTuple):
    """A batch's ``EdgePlan`` (``ssl.encoders.edge_plan``: the edges in a
    stable order of their masked receivers, masked edges last, and the
    reverse tables by sender), the inverse of its order ``inv_perm`` and
    ``send_plan``, the ``gather_rows`` plan of its senders built from its
    reverse tables (a masked edge gathers a zero row)."""

    edges: EdgePlan
    inv_perm: torch.Tensor
    send_plan: GatherPlan


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


@torch.no_grad()
def xplan(g: GraphBatch) -> XPlan:
    """The :class:`XPlan` of ``g`` (on its device, no host sync)."""
    p = edge_plan(g)
    return XPlan(edges=p, inv_perm=_inverse(p.perm),
                 send_plan=GatherPlan(p.rev_perm, _inverse(p.rev_perm),
                                      p.send_ids_sorted, p.rowptr_rev))


def _neighbour_sum(x: torch.Tensor, plan: XPlan,
                   coef: Optional[torch.Tensor]) -> torch.Tensor:
    """``out[i] = sum over real edges j->i of coef[e] * x[j]`` (``coef`` in
    the plan's edge order, None: 1), differentiable in ``x`` and ``coef``
    to any order."""
    p = plan.edges
    msgs = gather_rows(x, p.senders, plan.send_plan)
    if coef is not None:
        msgs = msgs * coef[:, None].to(msgs.dtype)
    return segment_sum_sorted_csr(msgs, p.recv_ids, p.rowptr, x.shape[0], 32,
                                  full_window(msgs.shape[0])).to(x.dtype)


def _permuted(edge_weight: Optional[torch.Tensor],
              plan: XPlan) -> Optional[torch.Tensor]:
    if edge_weight is None:
        return None
    return permute_rows(edge_weight, plan.edges.perm, plan.inv_perm)


class XGCNConv(nn.Module):
    """GCN conv with a multiplicative per-edge mask applied to messages
    (the reference sets PyG ``__edge_mask__`` via __set_masks__,
    base_explainer.py:48-80)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin = nn.Linear(in_dim, out_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, g: GraphBatch, edge_weight=None,
                plan: Optional[XPlan] = None):
        plan = xplan(g) if plan is None else plan
        h = self.lin(x)
        with torch.no_grad():
            p = plan.edges
            deg = (p.rowptr[1:] - p.rowptr[:-1]).to(h.dtype) + 1.0
            dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
            recv = torch.clamp(p.recv_ids.long(), min=0)
            coef = torch.where(p.recv_ids >= 0, dinv[recv] * dinv[p.senders],
                               0.0)
        ew = _permuted(edge_weight, plan)
        if ew is not None:
            coef = coef * ew
        agg = _neighbour_sum(h, plan, coef)
        agg = agg + (dinv * dinv)[:, None] * h
        return agg + self.bias


class XGINConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(in_dim, out_dim)
        self.lin2 = nn.Linear(out_dim, out_dim)

    def forward(self, x, g: GraphBatch, edge_weight=None,
                plan: Optional[XPlan] = None):
        plan = xplan(g) if plan is None else plan
        h = x + _neighbour_sum(x, plan, _permuted(edge_weight, plan))
        return self.lin2(F.relu(self.lin1(h)))


class GNNModel(nn.Module):
    """Shared body: ``model_level`` 'graph' or 'node'; returns logits and
    (optionally) the per-layer node activations.

    The layers exist once the input width is known: :meth:`init` on a
    batch, or :meth:`build` (weights drawn from a seed: Glorot-uniform
    kernels, zero biases, flax's initialisers)."""

    def __init__(self, gnn: str = "gcn", num_layers: int = 2,
                 hidden_dim: int = 64, num_classes: int = 2,
                 model_level: str = "graph", readout: str = "mean"):
        super().__init__()
        if gnn not in ("gcn", "gin"):
            raise ValueError(f"gnn must be 'gcn' or 'gin', got {gnn!r}")
        self.gnn = gnn
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.num_classes = num_classes
        self.model_level = model_level
        self.readout = readout
        self.in_dim = None

    def build(self, in_dim: int, seed: int = 0, device=None) -> "GNNModel":
        """(Re)build the layers for ``in_dim`` input features, weights drawn
        from ``seed``, on ``device``."""
        Conv = XGCNConv if self.gnn == "gcn" else XGINConv
        H = self.hidden_dim
        self.convs = nn.ModuleList(
            [Conv(in_dim if i == 0 else H, H)
             for i in range(self.num_layers)])
        if self.model_level == "graph":
            self.head = nn.ModuleList([nn.Linear(H, H),
                                       nn.Linear(H, self.num_classes)])
        else:
            self.head = nn.ModuleList([nn.Linear(H, self.num_classes)])
        self.in_dim = in_dim
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    xavier_uniform(m.weight, gen)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, XGCNConv):
                    m.bias.zero_()
        return self.to(resolve_device(device))

    def init(self, g: GraphBatch, seed: int = 0) -> "GNNModel":
        """Layers for ``g``'s feature width, weights from ``seed``, on
        ``g``'s device (flax's ``model.init(PRNGKey(seed), g)``)."""
        x = g.nodes["x"]
        return self.build(x.shape[-1], seed, x.device)

    def head_logits(self, x: torch.Tensor, g: GraphBatch) -> torch.Tensor:
        """The readout and the FFN (graph level) or the linear (node level)
        over the last layer's activations ``x``."""
        if self.model_level != "graph":
            return self.head[0](x)
        if self.readout == "max":
            big = torch.where(g.node_mask[:, None], x, -1e30)
            pooled = segment_max(big, g.node_graph, g.num_graphs)
        else:
            pooled = pool_graphs(x, g, "sum" if self.readout == "sum"
                                 else "mean")
        return self.head[1](F.relu(self.head[0](pooled)))

    def forward(self, g: GraphBatch, edge_weight: EdgeWeight = None,
                return_activations: bool = False,
                plan: Optional[XPlan] = None):
        """``edge_weight``: None, one ``[E]`` tensor shared by all layers, or
        a list/tuple of per-layer ``[E]`` tensors (needed by walk-level
        decompositions like GNN-LRP). ``plan``: ``g``'s :func:`xplan`,
        built here when not given."""
        if self.in_dim is None:
            raise RuntimeError("GNNModel has no layers yet: call init(g, "
                               "seed) or build(in_dim)")
        plan = xplan(g) if plan is None else plan
        x = g.nodes["x"]
        if edge_weight is None or isinstance(edge_weight, (list, tuple)):
            ew_per_layer = edge_weight
        else:
            ew_per_layer = [edge_weight] * self.num_layers
        acts = [x]
        for li, conv in enumerate(self.convs):
            ew = None if ew_per_layer is None else ew_per_layer[li]
            x = F.relu(conv(x, g, ew, plan))
            x = torch.where(g.node_mask[:, None], x, 0.0)
            acts.append(x)
        logits = self.head_logits(x, g)
        if return_activations:
            return logits, acts
        return logits


def apply(model: GNNModel, params, g: GraphBatch,
          edge_weight: EdgeWeight = None, return_activations: bool = False,
          plan: Optional[XPlan] = None):
    """``model``'s forward with the parameter dict ``params`` (names as
    ``model.named_parameters()``; None: the model's own)."""
    args = (g, edge_weight, return_activations, plan)
    if params is None:
        return model(*args)
    return torch.func.functional_call(model, params, args)


class _Head(nn.Module):
    def __init__(self, model: GNNModel):
        super().__init__()
        self.m = model

    def forward(self, x, g):
        return self.m.head_logits(x, g)


def apply_head(model: GNNModel, params, x: torch.Tensor,
               g: GraphBatch) -> torch.Tensor:
    """``model.head_logits(x, g)`` with the parameter dict ``params``
    (None: the model's own)."""
    if params is None:
        return model.head_logits(x, g)
    return torch.func.functional_call(
        _Head(model), {f"m.{k}": v for k, v in params.items()}, (x, g))


def GCN_2l(model_level="graph", dim_hidden=64, num_classes=2, **kw):
    return GNNModel(gnn="gcn", num_layers=2, hidden_dim=dim_hidden,
                    num_classes=num_classes, model_level=model_level, **kw)


def GCN_3l(model_level="graph", dim_hidden=64, num_classes=2, **kw):
    return GNNModel(gnn="gcn", num_layers=3, hidden_dim=dim_hidden,
                    num_classes=num_classes, model_level=model_level, **kw)


def GIN_2l(model_level="graph", dim_hidden=64, num_classes=2, **kw):
    return GNNModel(gnn="gin", num_layers=2, hidden_dim=dim_hidden,
                    num_classes=num_classes, model_level=model_level, **kw)


def GIN_3l(model_level="graph", dim_hidden=64, num_classes=2, **kw):
    return GNNModel(gnn="gin", num_layers=3, hidden_dim=dim_hidden,
                    num_classes=num_classes, model_level=model_level, **kw)
