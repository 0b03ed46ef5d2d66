"""Adaptive (centrality-weighted) augmentation utilities for GCA / pGRACE.
Port of ``dig_tpu/ssl/adaptive.py``.

Parity with ``dig/sslgraph/utils/adaptive.py``: PageRank via power iteration
(:34), degree- and eigenvector-centrality drop weights (:123, :162), and the
GCA weighted edge/feature dropping rules. All masked, with no host
synchronisation. The degrees are integer counts (the row pointers of the
batch's :class:`~dig_tpu_torch.ssl.encoders.EdgePlan`); the power
iterations' neighbour sums go through ``encoders.neighbour_sum`` (the
sorted-CSR sum: the kernel on the card, bitwise repeatable), where the JAX
functions take ``segment_sum``: the same sums in another order.
"""
from __future__ import annotations

import torch

from ..graph import GraphBatch
from .encoders import edge_plan, neighbour_sum
from .views import _View, _on, _uniform


def _in_degree(plan) -> torch.Tensor:
    return torch.diff(plan.rowptr).to(torch.float32)


def degree_centrality(g: GraphBatch) -> torch.Tensor:
    return _in_degree(edge_plan(g))


def compute_pr(g: GraphBatch, damp: float = 0.85, k: int = 10):
    """PageRank by k power iterations (reference adaptive.py:34-55)."""
    plan = edge_plan(g)
    deg_out = torch.diff(plan.rowptr_rev).to(torch.float32)
    coef = 1.0 / torch.clamp(deg_out[g.senders.long()], min=1.0)
    base = torch.where(g.node_mask, 1.0, 0.0)
    x = base
    for _ in range(k):
        agg = neighbour_sum(x[:, None], plan, coef)[:, 0]
        x = (1 - damp) * base + damp * agg
    return x


def eigenvector_centrality(g: GraphBatch, k: int = 50):
    """EVC by power iteration on the (masked) adjacency
    (reference adaptive.py:58-74 uses networkx; same fixed point)."""
    plan = edge_plan(g)
    x = torch.where(g.node_mask, 1.0, 0.0)
    for _ in range(k):
        y = neighbour_sum(x[:, None], plan)[:, 0]
        y = y + x  # self-damping keeps disconnected nodes finite
        x = y / torch.clamp(torch.linalg.vector_norm(y), min=1e-12)
    return torch.abs(x)


def _norm_weights(s, mask):
    """(s_max - s) / (s_max - s_mean) over real entries
    (reference adaptive.py:123-135)."""
    s_max = torch.max(torch.where(mask, s, -torch.inf))
    s_mean = torch.sum(torch.where(mask, s, 0.0)) / torch.clamp(
        torch.sum(mask), min=1)
    return (s_max - s) / torch.clamp(s_max - s_mean, min=1e-12)


def degree_drop_weights(g: GraphBatch):
    s = torch.log(torch.clamp(degree_centrality(g), min=1.0))
    return _norm_weights(s[g.receivers.long()], g.edge_mask)


def pr_drop_weights(g: GraphBatch, aggr: str = "sink", k: int = 10):
    s = torch.log(torch.clamp(compute_pr(g, k=k), min=1e-12))
    snd, rcv = g.senders.long(), g.receivers.long()
    if aggr == "sink":
        s_edge = s[rcv]
    elif aggr == "source":
        s_edge = s[snd]
    else:
        s_edge = 0.5 * (s[snd] + s[rcv])
    return _norm_weights(s_edge, g.edge_mask)


def evc_drop_weights(g: GraphBatch):
    s = torch.log(torch.clamp(eigenvector_centrality(g), min=1e-12))
    return _norm_weights(s[g.receivers.long()], g.edge_mask)


def feature_drop_weights(g: GraphBatch, node_c, dense: bool = False):
    """Per-feature-column drop weights from node centrality
    (reference adaptive.py:139-158)."""
    x = g.nodes["x"]
    x = torch.abs(x) if dense else (x != 0).to(torch.float32)
    x = torch.where(g.node_mask[:, None], x, 0.0)
    w = x.T @ torch.log(torch.clamp(node_c, min=1e-12))
    return _norm_weights(w, torch.ones_like(w, dtype=torch.bool))


def _drop_edges(g, w, p, threshold, u):
    mean = torch.sum(torch.where(g.edge_mask, w, 0.0)) / torch.clamp(
        torch.sum(g.edge_mask), min=1)
    prob = torch.clamp(p * w / torch.clamp(mean, min=1e-12), max=threshold)
    return g.replace(edge_mask=g.edge_mask & (_on(u, g) >= prob))


def _drop_features(g, w, p, threshold, u):
    prob = torch.clamp(p * w / torch.clamp(torch.mean(w), min=1e-12),
                       max=threshold)
    x = torch.where(_on(u, g) < prob[None, :], 0.0, g.nodes["x"])
    return g.replace_nodes(x=x)


def drop_edge_weighted(gen: torch.Generator, g: GraphBatch, drop_weights,
                       p: float, threshold: float = 0.7) -> GraphBatch:
    """Drop edge e w.p. min(p * w_e / mean(w), threshold) (GCA rule); the
    uniforms drawn from ``gen``."""
    return _drop_edges(g, drop_weights, p, threshold,
                       _uniform(gen, tuple(drop_weights.shape)))


def drop_feature_weighted(gen: torch.Generator, g: GraphBatch, feat_weights,
                          p: float, threshold: float = 0.7) -> GraphBatch:
    return _drop_features(g, feat_weights, p, threshold, _uniform(
        gen, (g.num_nodes,) + tuple(feat_weights.shape)))


def _centrality(measure: str, g: GraphBatch):
    if measure == "degree":
        return degree_centrality(g)
    if measure == "pr":
        return compute_pr(g)
    if measure == "evc":
        return eigenvector_centrality(g)
    raise ValueError(measure)


class AdaEdgePerturbation(_View):
    """Adaptive edge dropping (reference structure.py:58-108). Noise: ``u
    [E]`` uniform."""

    def __init__(self, centrality_measure: str = "degree", prob: float = 0.3,
                 threshold: float = 0.7):
        if centrality_measure not in ("degree", "pr", "evc"):
            raise ValueError(centrality_measure)
        self.centrality_measure = centrality_measure
        self.prob = prob
        self.threshold = threshold

    def draw(self, gen, g):
        return {"u": _uniform(gen, (g.num_edges,))}

    def apply(self, g, noise):
        w = {"degree": degree_drop_weights, "pr": pr_drop_weights,
             "evc": evc_drop_weights}[self.centrality_measure](g)
        return _drop_edges(g, w, self.prob, self.threshold, noise["u"])


class AdaNodeAttrMask(_View):
    """Adaptive feature masking (reference feature.py:98-164). Noise: ``u
    x.shape`` uniform."""

    def __init__(self, centrality_measure: str = "degree", prob: float = 0.3,
                 threshold: float = 0.7, dense: bool = False):
        if centrality_measure not in ("degree", "pr", "evc"):
            raise ValueError(centrality_measure)
        self.centrality_measure = centrality_measure
        self.prob = prob
        self.threshold = threshold
        self.dense = dense

    def draw(self, gen, g):
        return {"u": _uniform(gen, tuple(g.nodes["x"].shape))}

    def apply(self, g, noise):
        c = torch.clamp(_centrality(self.centrality_measure, g), min=1e-12)
        w = feature_drop_weights(g, c, self.dense)
        return _drop_features(g, w, self.prob, self.threshold, noise["u"])
