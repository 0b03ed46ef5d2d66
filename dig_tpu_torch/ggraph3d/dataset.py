"""QM9-3D generation dataset: per-step placement supervision. Port of
``dig_tpu/ggraph3d/dataset.py`` (numpy, the same arrays and the same
shuffling stream); ``collate_steps`` returns a CPU ``GraphBatch`` and a
dict of numpy arrays, moved to the card by the trainer.

Parity with ``dig/ggraph3D/dataset/ggraph3D_dataset.py:18-301`` (QM93DGEN +
custom collate producing focus/c1/c2 indices and (d, theta, phi) targets
per placement step). Step construction here: atoms ordered by BFS over the
covalent-bond graph; for the k-th atom, focus = its BFS parent, c1 =
focus's nearest placed neighbor, c2 = c1's nearest placed neighbor —
geometry targets computed from the true coordinates.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph import GraphBatch, batch_np

COVALENT_RADII = {1: 0.31, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57}


def _bond_graph(z, pos, tol: float = 0.45):
    n = len(z)
    adj = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            d = np.linalg.norm(pos[i] - pos[j])
            rc = (COVALENT_RADII.get(int(z[i]), 0.77)
                  + COVALENT_RADII.get(int(z[j]), 0.77))
            if d < rc + tol:
                adj[i].append(j)
                adj[j].append(i)
    return adj


def steps_from_molecule(z: np.ndarray, pos: np.ndarray,
                        atom_list: Sequence[int]) -> List[Dict]:
    """Decompose a molecule into placement steps (the reference's collate
    builds the same (focus, c1, c2, d, theta, phi) supervision)."""
    z = np.asarray(z)
    pos = np.asarray(pos, np.float64)
    n = len(z)
    z_to_idx = {int(a): k for k, a in enumerate(atom_list)}
    adj = _bond_graph(z, pos)
    # BFS order from atom 0
    order = []
    parent = {0: 0}
    seen = {0}
    queue = [0]
    while queue:
        v = queue.pop(0)
        order.append(v)
        for u in sorted(adj[v]):
            if u not in seen:
                seen.add(u)
                parent[u] = v
                queue.append(u)
    for v in range(n):  # disconnected safety
        if v not in seen:
            order.append(v)
            parent[v] = order[0]
            seen.add(v)

    steps = []
    for k in range(1, n):
        new = order[k]
        placed = order[:k]
        f = parent[new]
        if f not in placed:
            f = placed[-1]
        d = np.linalg.norm(pos[new] - pos[f])
        others = [p for p in placed if p != f]
        if others:
            c1 = min(others, key=lambda j: np.linalg.norm(pos[j] - pos[f]))
            v1 = pos[c1] - pos[f]
            vn = pos[new] - pos[f]
            cosang = v1 @ vn / max(np.linalg.norm(v1) * np.linalg.norm(vn),
                                   1e-9)
            theta = float(np.arccos(np.clip(cosang, -1, 1)))
            has_angle = True
        else:
            c1 = f
            theta = 0.0
            has_angle = False
        rest = [p for p in placed if p not in (f, c1)]
        if rest and has_angle:
            c2 = min(rest, key=lambda j: np.linalg.norm(pos[j] - pos[c1]))
            b1 = pos[c1] - pos[f]
            p1 = np.cross(b1, pos[c2] - pos[c1])
            p2 = np.cross(b1, pos[new] - pos[f])
            if np.linalg.norm(p1) > 1e-9 and np.linalg.norm(p2) > 1e-9:
                cosphi = p1 @ p2 / (np.linalg.norm(p1) * np.linalg.norm(p2))
                sign = np.sign(np.cross(p1, p2) @ b1)
                phi = float(np.arccos(np.clip(cosphi, -1, 1)) * (sign or 1))
                has_torsion = True
            else:
                c2, phi, has_torsion = c1, 0.0, False
        else:
            c2, phi, has_torsion = c1, 0.0, False
        steps.append({
            "placed": [int(p) for p in placed],
            "z_placed": z[placed].astype(np.int32),
            "pos_placed": pos[placed].astype(np.float32),
            "focus_local": placed.index(f),
            "c1_local": placed.index(c1),
            "c2_local": placed.index(c2),
            "new_atom_type": z_to_idx.get(int(z[new]), 0),
            "new_dist": float(d),
            "new_angle": theta,
            "new_torsion": phi,
            "has_angle": has_angle,
            "has_torsion": has_torsion,
        })
    return steps


def collate_steps(steps: List[Dict], n_node_pad: int,
                  num_steps: int) -> Tuple[GraphBatch, Dict]:
    """Batch placement steps: each step is its own partial molecule in one
    flat GraphBatch; step dict holds flat node indices + targets."""
    graphs = []
    focus, c1, c2 = [], [], []
    ntype, nd, na, nt = [], [], [], []
    ha, ht, sm = [], [], []
    focus_label = []
    off = 0
    per_pad = n_node_pad // num_steps
    for s in steps[:num_steps]:
        k = len(s["z_placed"])
        graphs.append({
            "nodes": {"z": s["z_placed"], "pos": s["pos_placed"]},
            "senders": np.zeros(0, np.int32),
            "receivers": np.zeros(0, np.int32),
            "globals": {},
        })
        focus.append(off + s["focus_local"])
        c1.append(off + s["c1_local"])
        c2.append(off + s["c2_local"])
        ntype.append(s["new_atom_type"])
        nd.append(s["new_dist"])
        na.append(s["new_angle"])
        nt.append(s["new_torsion"])
        ha.append(s["has_angle"])
        ht.append(s["has_torsion"])
        sm.append(True)
        fl = np.zeros(k)
        fl[s["focus_local"]] = 1.0
        focus_label.append(fl)
        off += k
    while len(graphs) < num_steps:
        graphs.append({
            "nodes": {"z": np.zeros(1, np.int32),
                      "pos": np.zeros((1, 3), np.float32)},
            "senders": np.zeros(0, np.int32),
            "receivers": np.zeros(0, np.int32),
            "globals": {},
        })
        focus.append(off); c1.append(off); c2.append(off)
        ntype.append(0); nd.append(1.0); na.append(0.0); nt.append(0.0)
        ha.append(False); ht.append(False); sm.append(False)
        focus_label.append(np.zeros(1))
        off += 1
    g = batch_np(graphs, n_node_pad, 1, num_graphs=num_steps,
                 device="cpu")
    fl = np.zeros(n_node_pad, np.float32)
    fl[:off] = np.concatenate(focus_label)
    step = {
        "focus": np.asarray(focus, np.int32),
        "c1": np.asarray(c1, np.int32),
        "c2": np.asarray(c2, np.int32),
        "new_atom_type": np.asarray(ntype, np.int32),
        "new_dist": np.asarray(nd, np.float32),
        "new_angle": np.asarray(na, np.float32),
        "new_torsion": np.asarray(nt, np.float32),
        "has_angle": np.asarray(ha, bool),
        "has_torsion": np.asarray(ht, bool),
        "step_mask": np.asarray(sm, bool),
        "focus_label": fl,
    }
    return g, step


class QM93DGEN:
    """Step-supervision dataset over 3D molecules (reference
    ggraph3D_dataset.py:18-301). Falls back to synthetic molecules when the
    gdb9 cache is absent."""

    ATOM_LIST = [6, 7, 8, 9]

    def __init__(self, mols: Optional[List[Dict]] = None,
                 num_steps_per_batch: int = 16,
                 n_node_pad: Optional[int] = None):
        if mols is None:
            from ..datasets.synthetic import synthetic_molecules
            mols = synthetic_molecules(64, seed=0, min_atoms=4, max_atoms=9,
                                       box=3.0)
            for m in mols:
                m["z"] = np.random.default_rng(0).choice(
                    self.ATOM_LIST, len(m["z"])).astype(np.int32)
        self.steps: List[Dict] = []
        for m in mols:
            self.steps += steps_from_molecule(m["z"], m["pos"],
                                              self.ATOM_LIST)
        self.num_steps = num_steps_per_batch
        max_nodes = max(len(s["z_placed"]) for s in self.steps)
        self.n_node_pad = n_node_pad or num_steps_per_batch * max_nodes

    def loader(self, shuffle: bool = True, seed: int = 0):
        steps = list(self.steps)
        rng = np.random.default_rng(seed)

        class _It:
            def __iter__(_self):
                order = np.arange(len(steps))
                if shuffle:
                    rng.shuffle(order)
                for b in range(len(steps) // self.num_steps):
                    sel = [steps[i] for i in
                           order[b * self.num_steps:(b + 1) * self.num_steps]]
                    yield collate_steps(sel, self.n_node_pad,
                                        self.num_steps)

            def __len__(_self):
                return len(steps) // self.num_steps

        return _It()
