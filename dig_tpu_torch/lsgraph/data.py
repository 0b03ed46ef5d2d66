"""Large-graph data. Port of ``dig_tpu/lsgraph/data.py``.

``get_data`` loads a cached large-graph dataset (Reddit / Yelp / Flickr /
ogbn-* as CSR-ready arrays; no download); ``synthetic_large_graph`` builds
an SBM-style labelled community graph from a seed, bit for bit the graph
the JAX package builds from the same seed (the same numpy draws in the
same order). Both return numpy arrays, as the JAX functions do.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def get_data(root: str, name: str) -> Dict[str, np.ndarray]:
    """Load a cached large-graph dataset: ``{root}/{name}.npz`` with keys
    senders, receivers, x, y, train_mask, val_mask, test_mask."""
    path = os.path.join(root, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found (no egress; cache the dataset there or use "
            "synthetic_large_graph)")
    raw = np.load(path)
    return {k: raw[k] for k in raw.files}


def synthetic_large_graph(num_nodes: int = 2000, num_classes: int = 4,
                          feat_dim: int = 16, avg_deg: int = 10,
                          homophily: float = 0.8, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """SBM-ish labeled graph: intra-class edges preferred, features =
    class signal + noise; ``num_nodes * avg_deg // 2`` undirected edges
    stored in both directions (senders, receivers int64)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_nodes)
    E = num_nodes * avg_deg // 2
    src = rng.integers(0, num_nodes, 2 * E)
    dst = np.empty_like(src)
    same = rng.random(2 * E) < homophily
    # destination: same class when homophilous, else random; one draw per
    # edge in edge order, as the JAX package draws them
    class_members = [np.flatnonzero(y == c) for c in range(num_classes)]
    for i in range(len(src)):
        if same[i]:
            dst[i] = rng.choice(class_members[y[src[i]]])
        else:
            dst[i] = rng.integers(0, num_nodes)
    keep = src != dst
    src, dst = src[keep][:E], dst[keep][:E]
    senders = np.concatenate([src, dst]).astype(np.int64)
    receivers = np.concatenate([dst, src]).astype(np.int64)

    x = 0.5 * rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
    x[np.arange(num_nodes), y % feat_dim] += 1.0

    order = rng.permutation(num_nodes)
    n_train = num_nodes // 2
    n_val = num_nodes // 4
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[order[:n_train]] = True
    val_mask[order[n_train:n_train + n_val]] = True
    test_mask[order[n_train + n_val:]] = True
    return {"senders": senders, "receivers": receivers, "x": x,
            "y": y.astype(np.int64), "train_mask": train_mask,
            "val_mask": val_mask, "test_mask": test_mask}
