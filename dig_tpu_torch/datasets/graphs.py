"""Graph-classification datasets + loader (SSL / xgraph substrate). Port of
``dig_tpu/datasets/graphs.py``, which is framework-free: copied, over the
port's ``graph.batch_np``.

Replaces PyG ``TUDataset``/``Planetoid`` usage in the reference
(``dig/sslgraph/dataset/TUDataset.py:10-222``, ``datasets.py:10-102``).
Reads the standard TU file format from a local cache when present (this
environment has no egress); otherwise tests use
:func:`synthetic_graph_dataset`. Includes the reference's degree-feature
expansion for datasets without node attributes
(``feat_expansion.py`` / ``TUDatasetExt`` feature modes).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..graph import batch_np


def degree_onehot(graphs: List[Dict], max_degree: Optional[int] = None):
    """One-hot degree as node features (reference
    ``FeatExpandApp``: datasets without attributes get degree features)."""
    degs = []
    for g in graphs:
        n = g["num_nodes"]
        d = np.bincount(np.asarray(g["receivers"]), minlength=n)
        degs.append(d)
    md = max_degree if max_degree is not None else max(
        (int(d.max()) if len(d) else 0) for d in degs)
    for g, d in zip(graphs, degs):
        x = np.zeros((g["num_nodes"], md + 1), np.float32)
        x[np.arange(g["num_nodes"]), np.minimum(d, md)] = 1.0
        g["x"] = x
    return graphs


def load_tu_dataset(root: str, name: str) -> List[Dict]:
    """Parse the TU graph-kernel format (DS_A.txt, DS_graph_indicator.txt,
    DS_graph_labels.txt, optional DS_node_labels/DS_node_attributes) from a
    local cache directory ``root/name/(raw/)``."""
    for base in (os.path.join(root, name, "raw"), os.path.join(root, name)):
        if os.path.exists(os.path.join(base, f"{name}_A.txt")):
            break
    else:
        raise FileNotFoundError(
            f"TU dataset {name} not found under {root} (no egress; place "
            "the raw files there or use synthetic_graph_dataset)")

    A = np.loadtxt(os.path.join(base, f"{name}_A.txt"),
                   delimiter=",").astype(np.int64) - 1
    indicator = np.loadtxt(
        os.path.join(base, f"{name}_graph_indicator.txt")).astype(np.int64) - 1
    y = np.loadtxt(os.path.join(base, f"{name}_graph_labels.txt"))
    y = y.astype(np.int64)
    # remap labels to 0..C-1
    _, y = np.unique(y, return_inverse=True)

    node_labels = None
    nl_path = os.path.join(base, f"{name}_node_labels.txt")
    if os.path.exists(nl_path):
        node_labels = np.loadtxt(nl_path, delimiter=",").astype(np.int64)
        if node_labels.ndim > 1:
            node_labels = node_labels[:, 0]
    node_attrs = None
    na_path = os.path.join(base, f"{name}_node_attributes.txt")
    if os.path.exists(na_path):
        node_attrs = np.loadtxt(na_path, delimiter=",").astype(np.float32)
        if node_attrs.ndim == 1:
            node_attrs = node_attrs[:, None]

    num_graphs = int(indicator.max()) + 1
    starts = np.zeros(num_graphs + 1, np.int64)
    np.add.at(starts, indicator + 1, 1)
    starts = np.cumsum(starts)

    graphs = []
    src_graph = indicator[A[:, 0]]
    order = np.argsort(src_graph, kind="stable")
    A = A[order]
    src_graph = src_graph[order]
    eptr = np.searchsorted(src_graph, np.arange(num_graphs + 1))
    for gi in range(num_graphs):
        lo, hi = starts[gi], starts[gi + 1]
        n = hi - lo
        e = A[eptr[gi]:eptr[gi + 1]] - lo
        g = {"num_nodes": int(n),
             "senders": e[:, 0].astype(np.int32),
             "receivers": e[:, 1].astype(np.int32),
             "y": int(y[gi])}
        if node_attrs is not None:
            g["x"] = node_attrs[lo:hi]
        elif node_labels is not None:
            nl = node_labels[lo:hi]
            k = int(node_labels.max()) + 1
            x = np.zeros((n, k), np.float32)
            x[np.arange(n), nl] = 1.0
            g["x"] = x
        graphs.append(g)
    if "x" not in graphs[0]:
        graphs = degree_onehot(graphs)
    return graphs


def synthetic_graph_dataset(num: int = 100, seed: int = 0,
                            min_nodes: int = 8, max_nodes: int = 16,
                            feat_dim: int = 8, num_classes: int = 2):
    """Learnably-labeled random graphs: class = density quantile, features
    correlated with class (for offline SSL / explainer tests)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(num):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        cls = int(rng.integers(num_classes))
        p = 0.15 + 0.5 * cls / max(num_classes - 1, 1)
        adj = rng.random((n, n)) < p
        adj = np.triu(adj, 1)
        s, r = np.nonzero(adj | adj.T)
        x = rng.normal(size=(n, feat_dim)).astype(np.float32) * 0.1
        x[:, cls % feat_dim] += 1.0
        graphs.append({"num_nodes": n, "senders": s.astype(np.int32),
                       "receivers": r.astype(np.int32), "x": x, "y": cls})
    return graphs


class GraphClsLoader:
    """Batches graph dicts (num_nodes, senders, receivers, x, y) into
    GraphBatches with static pads. The batches are on the host (CPU
    tensors); the caller moves them with ``GraphBatch.to(device)``."""

    def __init__(self, graphs: Sequence[Dict], batch_size: int,
                 n_node_pad: Optional[int] = None,
                 n_edge_pad: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: Optional[bool] = None):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last
        max_n = max(g["num_nodes"] for g in self.graphs)
        max_e = max(len(g["senders"]) for g in self.graphs)
        self.n_node_pad = n_node_pad or batch_size * max_n
        self.n_edge_pad = n_edge_pad or max(batch_size * max_e, 1)

    def __len__(self):
        n = len(self.graphs)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        order = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = []
            for i in idx:
                g = self.graphs[i]
                batch.append({
                    "nodes": {"x": g["x"]},
                    "n_node": g["num_nodes"],
                    "senders": g["senders"],
                    "receivers": g["receivers"],
                    "globals": {"y": np.asarray(g["y"])},
                })
            yield batch_np(batch, self.n_node_pad, self.n_edge_pad,
                           num_graphs=self.batch_size, device="cpu")
