"""Shapley-value approximations for coalition scoring. Port of
``dig_tpu/xgraph/shapley.py``.

Parity with ``dig/xgraph/method/shapley.py``: ``l_shapley`` (:100),
``mc_shapley`` (:148), ``mc_l_shapley`` (:182), ``NC_mc_l_shapley`` (:240),
``gnn_score`` (graph_build via zero-filling or split), and the batched
marginal-contribution evaluation (``MarginalSubgraphDataset`` :44 — here
one masked forward over the disjoint union of the masked copies, where the
JAX package ``vmap``s the forward over the masks). The mask draws are the
JAX package's numpy streams, call for call.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph import GraphBatch
from .base import disjoint_union, to_numpy
from .models import apply, xplan


def graph_build_zero_filling(g: GraphBatch, node_mask_sub: np.ndarray):
    """Zero out excluded node features (reference shapley.py:85-90)."""
    x = g.nodes["x"]
    keep = torch.as_tensor(np.asarray(node_mask_sub), device=x.device)
    return g.replace_nodes(x=x * keep.to(x.dtype)[:, None])


def graph_build_split(g: GraphBatch, node_mask_sub: np.ndarray):
    """Drop edges incident to excluded nodes (reference shapley.py:93-98)."""
    keep = torch.as_tensor(np.asarray(node_mask_sub),
                           device=g.edge_mask.device).bool()
    em = g.edge_mask & keep[g.senders.long()] & keep[g.receivers.long()]
    return g.replace(edge_mask=em)


_GRAPH_BUILDS = {"zero_filling": graph_build_zero_filling,
             "split": graph_build_split}


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_value_func(model, params, target_class: int,
                    node_idx: Optional[int] = None, probs_fn=None):
    """GnnNetsGC2valueFunc / GnnNetsNC2valueFunc (shapley.py:12-41):
    coalition mask [N] -> prob of target class.

    ``probs_fn``: optional (params, g) -> probs (default: the softmax of
    the model under ``params``)."""
    if probs_fn is None:
        def probs_fn(params, g):
            with torch.no_grad():
                return torch.softmax(apply(model, params, g), dim=-1)

    def vf(g: GraphBatch):
        row = 0 if node_idx is None else node_idx
        return probs_fn(params, g.to(_model_device(model)))[row, target_class]

    return vf


def make_batched_value_func(model, params, target_class: int,
                            node_idx: Optional[int] = None,
                            subgraph_building_method="zero_filling",
                            batch_fn=None):
    """Batched coalition scoring: ONE forward over the disjoint union of
    the masked copies of the graph — the reference's
    ``MarginalSubgraphDataset`` batching
    (``dig/xgraph/method/shapley.py:44-98``).

    Returns ``vf_batch(g, masks: list[np [N]]) -> np [B]``. Masks are
    padded to power-of-two buckets (min 64), as the JAX package pads them,
    so the unions (and their plans) of zero-filling repeat and are kept.
    ``batch_fn`` lets the explainer share the inner (and its unions)
    across labels/targets.
    """
    zero = subgraph_building_method == "zero_filling"

    if batch_fn is None:
        batch_fn = make_batched_probs_fn(model, zero)

    def vf_batch(g, masks_np):
        B = len(masks_np)
        if B == 0:
            return np.zeros(0, np.float32)
        N = masks_np[0].shape[-1]
        Bp = max(64, 1 << (B - 1).bit_length())
        masks = np.zeros((Bp, N), np.float32)
        masks[:B] = np.stack(masks_np)
        row = 0 if node_idx is None else node_idx
        vals = batch_fn(params, g, torch.as_tensor(masks), row, target_class)
        return to_numpy(vals)[:B]

    return vf_batch


def make_batched_probs_fn(model, zero_filling: bool):
    """The shareable inner of :func:`make_batched_value_func`:
    ``batch_fn(params, g, masks [K, N], row, cls) -> [K]``, the target
    probability of each masked copy, from one run over the ``K`` copies.
    It keeps the last union of copies of a graph (with its plan); split
    masks change the edges, so their plan is built each call."""
    cache = {}

    def batch_fn(params, g, masks, row, cls):
        dev = _model_device(model)
        K, N = masks.shape
        key = (id(g), K)
        hit = cache.get(key)
        if hit is None or hit[0] is not g:
            cache.clear()
            u = disjoint_union([g.to(dev)] * K)
            hit = cache[key] = (g, u, xplan(u))
        _, u, plan = hit
        masks = masks.to(dev)
        if zero_filling:
            u = u.replace_nodes(x=u.nodes["x"] * masks.reshape(K * N)[:, None])
        else:
            keep = masks.reshape(K * N).bool()
            u = u.replace(edge_mask=u.edge_mask & keep[u.senders.long()]
                          & keep[u.receivers.long()])
            plan = xplan(u)
        with torch.no_grad():
            probs = torch.softmax(apply(model, params, u, plan=plan), dim=-1)
        return probs.reshape((K, -1) + tuple(probs.shape[1:]))[:, row, cls]

    return batch_fn


def _local_region(coalition, g, local_radius):
    from .base import k_hop_subgraph
    local_nodes = set()
    s, r, em = (to_numpy(t) for t in (g.senders, g.receivers, g.edge_mask))
    for v in coalition:
        nodes, _ = k_hop_subgraph(v, local_radius - 1, s, r, em,
                                  g.num_nodes)
        local_nodes |= set(nodes.tolist())
    return sorted(local_nodes)


def _masks_for(coalition, g, method, local_radius, sample_num, node_idx,
               seed):
    """(exclude, include, weights|None) mask stacks for one coalition —
    shared by the sequential scorers and :func:`score_coalitions`."""
    N = g.num_nodes
    coalition = list(coalition)
    rng = np.random.default_rng(seed)
    if method == "mc_shapley":
        node_mask = to_numpy(g.node_mask)
        real = np.flatnonzero(node_mask)
        others = np.asarray([n for n in real if n not in set(coalition)],
                            np.int64)
        ex_masks, inc_masks = [], []
        for _ in range(sample_num):
            perm = rng.permutation(others)
            split = rng.integers(0, len(others) + 1)
            ex = np.zeros(N, np.float32)
            ex[perm[:split]] = 1.0
            inc = ex.copy()
            inc[coalition] = 1.0
            ex_masks.append(ex)
            inc_masks.append(inc)
        return ex_masks, inc_masks, None
    local_region = _local_region(coalition, g, local_radius)
    others = np.asarray([n for n in local_region
                         if n not in set(coalition)], np.int64)
    if method == "l_shapley":
        import itertools
        import math
        ex_masks, inc_masks, weights = [], [], []
        n = len(local_region)
        for r in range(len(others) + 1):
            w = (math.factorial(r) * math.factorial(n - r - 1)
                 / math.factorial(n)) if n > 0 else 1.0
            for subset in itertools.combinations(others, r):
                ex = np.ones(N, np.float32)
                ex[local_region] = 0.0
                ex[list(subset)] = 1.0
                inc = ex.copy()
                inc[coalition] = 1.0
                ex_masks.append(ex)
                inc_masks.append(inc)
                weights.append(w)
        return ex_masks, inc_masks, np.asarray(weights, np.float32)
    # mc_l_shapley / nc_mc_l_shapley
    ex_masks, inc_masks = [], []
    for _ in range(sample_num):
        perm = rng.permutation(others)
        split = rng.integers(0, len(others) + 1)
        ex = np.ones(N, np.float32)
        ex[local_region] = 0.0
        ex[perm[:split]] = 1.0
        if method == "nc_mc_l_shapley":
            ex[node_idx] = 1.0
        inc = ex.copy()
        inc[coalition] = 1.0
        ex_masks.append(ex)
        inc_masks.append(inc)
    return ex_masks, inc_masks, None


def score_coalitions(coalitions, g, vf_batch, method="mc_l_shapley", *,
                     local_radius: int = 4, sample_num: int = 100,
                     node_idx: Optional[int] = None, seed: int = 0):
    """Score MANY coalitions with one batched forward. Numerically
    identical to calling the sequential scorers per coalition (each
    coalition draws from a fresh ``default_rng(seed)``, matching them)."""
    N = g.num_nodes
    masks: List[np.ndarray] = []
    combine = []
    for coalition in coalitions:
        if method == "gnn_score":
            m = np.zeros(N, np.float32)
            m[list(coalition)] = 1.0
            combine.append((len(masks), 1, None, True))
            masks.append(m)
            continue
        ex, inc, w = _masks_for(coalition, g, method, local_radius,
                                sample_num, node_idx, seed)
        combine.append((len(masks), len(ex), w, False))
        masks.extend(ex)
        masks.extend(inc)
    vals = vf_batch(g, masks)
    out = []
    for start, cnt, w, single in combine:
        if single:
            out.append(float(vals[start]))
        else:
            marg = vals[start + cnt:start + 2 * cnt] - vals[start:start + cnt]
            out.append(float((marg * w).sum() if w is not None
                             else marg.mean()))
    return np.asarray(out, np.float32)


def _marginal_contributions(g, exclude_masks, include_masks, value_func,
                            subgraph_building_method="zero_filling"):
    build = _GRAPH_BUILDS[subgraph_building_method]
    scores = []
    for ex, inc in zip(exclude_masks, include_masks):
        v_ex = float(value_func(build(g, ex)))
        v_inc = float(value_func(build(g, inc)))
        scores.append(v_inc - v_ex)
    return np.asarray(scores)


def l_shapley(coalition: Sequence[int], g: GraphBatch, local_radius: int,
              value_func, subgraph_building_method="zero_filling") -> float:
    """Local-neighborhood Shapley (reference shapley.py:100-145)."""
    ex, inc, w = _masks_for(coalition, g, "l_shapley", local_radius,
                            0, None, 0)
    margins = _marginal_contributions(g, ex, inc, value_func,
                                      subgraph_building_method)
    return float(np.sum(w * margins))


def mc_shapley(coalition: Sequence[int], g: GraphBatch,
               value_func, subgraph_building_method="zero_filling",
               sample_num: int = 100, seed: int = 0) -> float:
    """Monte-Carlo Shapley over all nodes (reference shapley.py:148-179)."""
    ex, inc, _ = _masks_for(coalition, g, "mc_shapley", 0, sample_num,
                            None, seed)
    margins = _marginal_contributions(g, ex, inc, value_func,
                                      subgraph_building_method)
    return float(margins.mean())


def mc_l_shapley(coalition: Sequence[int], g: GraphBatch, local_radius: int,
                 value_func, subgraph_building_method="zero_filling",
                 sample_num: int = 100, seed: int = 0) -> float:
    """Monte-Carlo local Shapley (reference shapley.py:182-224) — the
    default SubgraphX payoff."""
    ex, inc, _ = _masks_for(coalition, g, "mc_l_shapley", local_radius,
                            sample_num, None, seed)
    margins = _marginal_contributions(g, ex, inc, value_func,
                                      subgraph_building_method)
    return float(margins.mean())


def NC_mc_l_shapley(coalition: Sequence[int], g: GraphBatch,
                    local_radius: int, value_func, node_idx: int,
                    subgraph_building_method="zero_filling",
                    sample_num: int = 100, seed: int = 0) -> float:
    """Node-classification variant: the target node always stays included
    (reference shapley.py:240-291)."""
    ex, inc, _ = _masks_for(coalition, g, "nc_mc_l_shapley", local_radius,
                            sample_num, node_idx, seed)
    margins = _marginal_contributions(g, ex, inc, value_func,
                                      subgraph_building_method)
    return float(margins.mean())


def gnn_score(coalition: Sequence[int], g: GraphBatch, value_func,
              subgraph_building_method="zero_filling") -> float:
    """Raw model score of the coalition subgraph (shapley.py:227-237)."""
    N = g.num_nodes
    mask = np.zeros(N, np.float32)
    mask[list(coalition)] = 1.0
    build = _GRAPH_BUILDS[subgraph_building_method]
    return float(value_func(build(g, mask)))
