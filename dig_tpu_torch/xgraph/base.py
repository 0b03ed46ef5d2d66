"""ExplainerBase — shared mask/eval machinery for all explainers. Port of
``dig_tpu/xgraph/base.py``.

Parity with ``dig/xgraph/method/base_explainer.py:25-498``: apply soft/hard
edge masks to the model (as multiplicative edge weights — the functional
equivalent of PyG's ``__set_masks__``), k-hop subgraph extraction for
node-level tasks, sparsity control, and ``eval_related_pred`` producing the
origin/masked/maskout/zero probabilities XCollector consumes.

Deliberate deviation: where the JAX package ``vmap``s one model over many
edge weightings, masks or graphs, the port runs the model once on their
disjoint union (:func:`disjoint_union`: copies of one graph, or graphs of
the same pads, each with its own rows, edges and graph slots). The graphs
share no edge, so each copy's logits, and each copy's gradient, are those
of a run on it alone. The kernel's ``autograd.Function`` launches through
ctypes and has no ``vmap`` rule.

An explainer keeps the :func:`~dig_tpu_torch.xgraph.models.xplan` of the
graphs it meets (and of their unions), so the sorts behind the neighbour
sums run once per graph, not once per forward.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph import GraphBatch
from .models import apply, xplan


def to_numpy(t) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def k_hop_subgraph(node_idx: int, num_hops: int, senders, receivers,
                   edge_mask, num_nodes: int):
    """Nodes/edges within num_hops of node_idx (host-side numpy; reference
    base_explainer.py:82-106 wraps PyG's k_hop_subgraph)."""
    senders = to_numpy(senders)
    receivers = to_numpy(receivers)
    em = to_numpy(edge_mask)
    node_set = {int(node_idx)}
    for _ in range(num_hops):
        sel = em & np.isin(receivers, list(node_set))
        node_set |= set(senders[sel].tolist())
    nodes = np.array(sorted(node_set))
    sub_edge = em & np.isin(senders, nodes) & np.isin(receivers, nodes)
    return nodes, sub_edge


def disjoint_union(graphs: Sequence[GraphBatch]) -> GraphBatch:
    """One batch holding ``graphs`` (the same pads and keys) side by side:
    graph ``b``'s node rows at ``b * N``, edges at ``b * E``, graph slots
    at ``b * G``; its padding stays its own."""
    g0 = graphs[0]
    N, G = g0.num_nodes, g0.num_graphs
    dev = g0.node_mask.device
    B = len(graphs)
    cat = lambda xs: torch.cat(list(xs), 0)
    offs = torch.arange(B, device=dev)

    def shifted(name, off):
        t = torch.stack([getattr(g, name).long() for g in graphs])
        return (t + off[:, None]).reshape(-1).to(getattr(g0, name).dtype)

    return GraphBatch(
        nodes={k: cat(g.nodes[k] for g in graphs) for k in g0.nodes},
        edges={k: cat(g.edges[k] for g in graphs) for k in g0.edges},
        senders=shifted("senders", offs * N),
        receivers=shifted("receivers", offs * N),
        globals={k: cat(g.globals[k] for g in graphs) for k in g0.globals},
        node_graph=shifted("node_graph", offs * G),
        node_mask=cat(g.node_mask for g in graphs),
        edge_mask=cat(g.edge_mask for g in graphs),
        graph_mask=cat(g.graph_mask for g in graphs),
        n_node=cat(g.n_node for g in graphs),
        n_edge=cat(g.n_edge for g in graphs))


class _Plans:
    """The plans (and unions of copies) of the last few graphs seen, by
    identity; each entry holds its graph, so an id is not reused while
    the entry lives."""

    def __init__(self, size: int = 16):
        self.size = size
        self.entries: Dict[tuple, tuple] = {}

    def get(self, key, g, build):
        hit = self.entries.get(key)
        if hit is not None and hit[0] is g:
            return hit[1]
        if len(self.entries) >= self.size:
            self.entries.pop(next(iter(self.entries)))
        val = build()
        self.entries[key] = (g, val)
        return val


class ExplainerBase:
    """Explainers hold a model and its parameters (``params``: a dict of
    tensors by parameter name, or None for the model's own weights) and
    explain single (batched-as-one) graphs. They run on the model's
    device: graphs are moved there."""

    def __init__(self, model, params=None, epochs: int = 0, lr: float = 0.0,
                 explain_graph: bool = True):
        self.model = model
        self.params = params
        self.epochs = epochs
        self.lr = lr
        self.explain_graph = explain_graph
        self.num_hops = getattr(model, "num_layers", 2)
        self._plans = _Plans()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def on_device(self, g: GraphBatch) -> GraphBatch:
        """``g`` on the model's device (moved once; the same object after
        that, so its plans are found again)."""
        dev = self.device
        if g.node_mask.device == dev:
            return g
        return self._plans.get(("dev", id(g)), g, lambda: g.to(dev))

    def plan(self, g: GraphBatch):
        """``g``'s :func:`xplan`, built once."""
        return self._plans.get(("plan", id(g)), g, lambda: xplan(g))

    def copies(self, g: GraphBatch, K: int):
        """``(union, plan)``: ``K`` copies of ``g`` side by side and the
        union's plan, built once."""
        def build():
            u = disjoint_union([g] * K)
            return u, xplan(u)
        return self._plans.get(("copies", id(g), K), g, build)

    def forward(self, g: GraphBatch, edge_weight=None, **kw):
        g = self.on_device(g)
        return apply(self.model, self.params, g, edge_weight,
                     plan=self.plan(g), **kw)

    def forward_many(self, g: GraphBatch, edge_weights: torch.Tensor,
                     x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[K, rows, C]`` of ``g`` under each of the ``K`` edge
        weightings ``[K, E]`` (and node features ``x [K, N, F]`` when
        given): one run on ``K`` copies of ``g``."""
        K = edge_weights.shape[0]
        u, plan = self.copies(self.on_device(g), K)
        if x is not None:
            u = u.replace_nodes(x=x.reshape((-1,) + tuple(x.shape[2:])))
        out = apply(self.model, self.params, u, edge_weights.reshape(-1),
                    plan=plan)
        return out.reshape((K, -1) + tuple(out.shape[1:]))

    def predict_proba(self, g: GraphBatch, edge_weight=None):
        with torch.no_grad():
            return torch.softmax(self.forward(g, edge_weight), dim=-1)

    # -- mask utilities ---------------------------------------------------
    @staticmethod
    def control_sparsity(mask, sparsity: float = 0.7):
        """Top (1 - sparsity) edges -> +inf, rest -> -inf (reference
        metrics.py:19-57); sigmoid then yields a hard 0/1 weight."""
        mask = np.asarray(mask, np.float32)
        order = np.argsort(-mask)
        split = int((1 - sparsity) * len(mask))
        out = np.full_like(mask, -np.inf)
        out[order[:split]] = np.inf
        return out

    def eval_related_pred(self, g: GraphBatch, edge_masks: List[np.ndarray],
                          node_idx: Optional[int] = None,
                          domain: Optional[np.ndarray] = None) -> List[Dict]:
        """For each class's hard edge mask produce origin / masked /
        maskout / zero probabilities (base_explainer.py:259-302).

        ``domain`` (bool [E], optional) restricts the evaluation to a
        subgraph — edges outside it are absent from origin, masked AND
        maskout alike. This is the reference's node-task protocol: it
        extracts the k-hop subgraph around the explained node first
        (base_explainer.py:82-106), so only neighborhood edges are ever
        explanation candidates."""
        results = []
        E = g.num_edges
        row = 0 if node_idx is None else node_idx
        dev = self.device
        # one run over the union: [n_masks * 4, E] edge weightings
        ms = [torch.sigmoid(torch.as_tensor(np.asarray(m, np.float32),
                                            device=dev))
              for m in edge_masks]
        ones = torch.ones(E, device=dev)
        weights = torch.stack(
            [ones] + [w for m in ms for w in (m, 1.0 - m)]
            + [torch.zeros(E, device=dev)])
        if domain is not None:
            weights = weights * torch.as_tensor(
                np.asarray(domain, np.float32), device=dev)[None, :]
        with torch.no_grad():
            probs = to_numpy(torch.softmax(self.forward_many(g, weights),
                                           dim=-1))
        ori, zero = probs[0], probs[-1]
        for ex_label, mask in enumerate(edge_masks):
            masked = probs[1 + 2 * ex_label]
            maskout = probs[2 + 2 * ex_label]
            mask_np = np.asarray(mask)
            if domain is not None:
                dom = np.asarray(domain, bool)
                finite_frac = (float(np.mean(mask_np[dom] > 0))
                               if dom.any() else 0.0)
            else:
                finite_frac = (float(np.mean(mask_np > 0))
                               if len(mask_np) else 0.0)
            results.append({
                "origin": float(ori[row, ex_label]),
                "masked": float(masked[row, ex_label]),
                "maskout": float(maskout[row, ex_label]),
                "zero": float(zero[row, ex_label]),
                "sparsity": 1.0 - finite_frac,
            })
        return results
