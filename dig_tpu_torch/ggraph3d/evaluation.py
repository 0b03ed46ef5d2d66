"""3D generation evaluation. Port of ``dig_tpu/ggraph3d/evaluation.py``
(numpy over the port's ``chem``).

Parity with ``dig/ggraph3D/evaluation/metric.py:7-133`` +
``utils/{eval_validity_utils.py,eval_bond_mmd_utils.py}``: chemical
validity via bond perception from interatomic distances (covalent-radius
tables standing in for the reference's per-pair bond-length lookup) +
valence check, and MMD between generated and reference bond-length
distributions. Property optimization scoring uses the chem-kernel
descriptors (the reference calls PySCF quantum chemistry — documented
substitution; PySCF is not in this environment).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..chem import Mol, check_valency
from .dataset import _bond_graph


def mols_from_xyz(samples: Sequence[Dict]) -> List[Mol]:
    """(z, pos) -> Mol via distance-based bond perception."""
    out = []
    for s in samples:
        z, pos = np.asarray(s["z"]), np.asarray(s["pos"])
        mol = Mol()
        for zi in z:
            mol.add_atom(int(zi))
        adj = _bond_graph(z, pos)
        for i, nbrs in enumerate(adj):
            for j in nbrs:
                if j > i:
                    mol.add_bond(i, j, 1.0)
        out.append(mol)
    return out


def bond_stats(samples: Sequence[Dict]) -> Dict[tuple, np.ndarray]:
    """Bond-length samples per (z_i, z_j) pair."""
    stats: Dict[tuple, list] = {}
    for s in samples:
        z, pos = np.asarray(s["z"]), np.asarray(s["pos"])
        adj = _bond_graph(z, pos)
        for i, nbrs in enumerate(adj):
            for j in nbrs:
                if j > i:
                    key = tuple(sorted((int(z[i]), int(z[j]))))
                    stats.setdefault(key, []).append(
                        float(np.linalg.norm(pos[i] - pos[j])))
    return {k: np.asarray(v) for k, v in stats.items()}


def compute_mmd(x: np.ndarray, y: np.ndarray,
                sigmas=(0.1, 0.2, 0.5, 1.0)) -> float:
    """Gaussian-kernel MMD^2 between 1-D samples (reference
    eval_bond_mmd_utils.py:1-96)."""
    x = np.asarray(x, np.float64)[:, None]
    y = np.asarray(y, np.float64)[:, None]

    def k(a, b):
        d2 = (a - b.T) ** 2
        return sum(np.exp(-d2 / (2 * s * s)) for s in sigmas) / len(sigmas)

    if len(x) == 0 or len(y) == 0:
        return float("nan")
    return float(k(x, x).mean() + k(y, y).mean() - 2 * k(x, y).mean())


class RandGenEvaluator3D:
    """validity + bond MMD (reference metric.py:16-80)."""

    def eval_validity(self, input_dict: Dict) -> Dict[str, float]:
        mols = mols_from_xyz(input_dict["mol_dicts"])
        n_valid = 0
        for m in mols:
            if m.num_atoms == 0 or not check_valency(m):
                continue
            # connectivity: one fragment
            seen = {0}
            stack = [0]
            while stack:
                v = stack.pop()
                for u in m.neighbors(v):
                    if u not in seen:
                        seen.add(u)
                        stack.append(u)
            if len(seen) == m.num_atoms:
                n_valid += 1
        ratio = 100.0 * n_valid / max(len(mols), 1)
        print(f"Valid Ratio: {ratio:.2f}%")
        return {"valid_ratio": ratio}

    def eval_bond_mmd(self, input_dict: Dict) -> Dict[tuple, float]:
        gen = bond_stats(input_dict["mol_dicts"])
        ref = bond_stats(input_dict["ref_dicts"])
        out = {}
        for key in sorted(set(gen) & set(ref)):
            out[key] = compute_mmd(gen[key], ref[key])
            print(f"bond {key}: MMD {out[key]:.4f}")
        return out


class PropOptEvaluator3D:
    """Property-targeted evaluation (reference metric.py:81-133 scores HOMO
    /LUMO gaps with PySCF; here chem-kernel descriptor proxies keep the
    pipeline runnable offline)."""

    def __init__(self, prop_name: str = "gap", good_threshold: float = 4.5):
        self.prop_name = prop_name
        self.good_threshold = good_threshold

    def eval(self, input_dict: Dict) -> Dict[str, float]:
        from ..chem import penalized_logp
        mols = mols_from_xyz(input_dict["mol_dicts"])
        scores = [penalized_logp(m) for m in mols if m.num_atoms > 0]
        if not scores:
            return {"mean": float("nan"), "best": float("nan"),
                    "good_per": 0.0, "proxy": True}
        return {"mean": float(np.mean(scores)),
                "best": float(np.max(scores)),
                "good_per": 100.0 * float(np.mean(
                    np.asarray(scores) > self.good_threshold)),
                # descriptor proxy, NOT a PySCF quantum property — values
                # are not comparable to the reference's (metric.py:81-133)
                "proxy": True}
