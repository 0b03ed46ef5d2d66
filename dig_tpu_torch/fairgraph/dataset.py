"""Fair-graph datasets. Port of ``dig_tpu/fairgraph/dataset.py``, which is
numpy only: copied, so both packages draw the same arrays.

Parity with ``dig/fairgraph/dataset/fairgraph_dataset.py:11-267``
(POKEC-z/n, NBA from DIG_storage csvs): loads the same csv/edge-list layout
from a local cache; ``synthetic_fair_graph`` generates an offline benchmark
with a controllable sensitive-attribute correlation.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def load_fair_dataset(root: str, name: str = "POKEC",
                      sens_attr: str = "region",
                      predict_attr: str = "I_am_working_in_field",
                      variant: str = "z") -> Dict[str, np.ndarray]:
    """Read the reference's csv + edge-list cache layout:
    {root}/{base}.csv (features incl. sens/label columns) and
    {root}/{base}_relationship.txt (edge list of user ids)."""
    base = {"POKEC": f"region_job{'_2' if variant == 'n' else ''}",
            "NBA": "nba"}.get(name, name)
    csv_path = os.path.join(root, f"{base}.csv")
    rel_path = os.path.join(root, f"{base}_relationship.txt")
    if not (os.path.exists(csv_path) and os.path.exists(rel_path)):
        raise FileNotFoundError(
            f"{csv_path} / {rel_path} not found (nothing is downloaded; "
            "cache them or use synthetic_fair_graph)")
    import csv as _csv
    with open(csv_path) as f:
        reader = _csv.DictReader(f)
        rows = list(reader)
    ids = {row["user_id"]: i for i, row in enumerate(rows)}
    feat_keys = [k for k in rows[0]
                 if k not in ("user_id", sens_attr, predict_attr)]
    x = np.array([[float(r[k] or 0) for k in feat_keys] for r in rows],
                 np.float32)
    sens = np.array([float(r[sens_attr] or 0) for r in rows], np.float32)
    y = np.array([float(r[predict_attr] or 0) for r in rows], np.float32)
    edges = []
    with open(rel_path) as f:
        for line in f:
            a, b = line.split()
            if a in ids and b in ids:
                edges.append((ids[a], ids[b]))
    n = len(rows)
    adj = np.zeros((n, n), np.float32)
    for a, b in edges:
        adj[a, b] = adj[b, a] = 1.0
    return {"adj": adj, "x": x, "y": (y > 0).astype(np.float32),
            "sens": (sens > 0).astype(np.float32)}


def synthetic_fair_graph(n: int = 200, feat_dim: int = 16,
                         avg_deg: int = 8, bias: float = 0.7,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """Homophilous-by-sensitive-attribute graph with label partially
    correlated to the sensitive attribute (the unfairness Graphair should
    reduce)."""
    rng = np.random.default_rng(seed)
    sens = (rng.random(n) < 0.5).astype(np.float32)
    y = np.where(rng.random(n) < bias, sens,
                 (rng.random(n) < 0.5)).astype(np.float32)
    x = rng.normal(size=(n, feat_dim)).astype(np.float32) * 0.5
    x[:, 0] += y
    x[:, 1] += sens
    adj = np.zeros((n, n), np.float32)
    E = n * avg_deg // 2
    cnt = 0
    while cnt < E:
        a, b = rng.integers(0, n, 2)
        if a == b:
            continue
        p = 0.8 if sens[a] == sens[b] else 0.2
        if rng.random() < p:
            adj[a, b] = adj[b, a] = 1.0
            cnt += 1
    idx = rng.permutation(n)
    return {"adj": adj, "x": x, "y": y, "sens": sens,
            "idx_train": idx[:n // 2], "idx_val": idx[n // 2:3 * n // 4],
            "idx_test": idx[3 * n // 4:],
            "idx_sens_train": idx[:n // 2]}
