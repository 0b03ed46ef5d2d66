"""Molecular descriptors: logP, penalized logP, SA / QED proxies.

The reference computes these with RDKit (``dig/ggraph/utils/environment.py:77``
``calculate_min_plogp``, ``sascorer.py``, QED in ``PropOptEvaluator``). When
RDKit is importable the exact functions are used; otherwise these
self-contained approximations keep the optimization/evaluation *pipelines*
fully functional:

* ``crippen_logp`` — Wildman–Crippen-style additive atom contributions with
  a coarse atom typing (element, aromaticity, heteroatom neighbors).
* ``penalized_logp`` — logP - SA - long-cycle penalty with the same
  normalization constants as the reference (environment.py:77-120).
* ``sa_score_proxy`` — size/branching/ring-complexity proxy of the Ertl SA
  score.
* ``qed_proxy`` — desirability-weighted property combination (MW, logP,
  rings, polar atoms) standing in for RDKit's QED.
"""
from __future__ import annotations

import math
from typing import List, Set, Tuple

import numpy as np

from .mol import Mol

try:  # pragma: no cover - exact path when rdkit exists
    from rdkit import Chem  # noqa: F401
    _HAVE_RDKIT = True
except ImportError:
    _HAVE_RDKIT = False

# Coarse Crippen-style atom contributions (element, aromatic) -> logP.
_CRIPPEN = {
    (6, False): 0.1441,   # aliphatic C
    (6, True): 0.2955,    # aromatic C
    (7, False): -0.6000,
    (7, True): -0.3239,
    (8, False): -0.3367,
    (8, True): 0.1552,
    (9, False): 0.4202,
    (15, False): 0.8612,
    (16, False): 0.6482,
    (16, True): 0.6237,
    (17, False): 0.6895,
    (35, False): 0.8456,
    (53, False): 0.8857,
    (1, False): 0.1230,
    (5, False): -0.3187,
}


def _ring_info(mol: Mol) -> List[List[int]]:
    """Smallest cycles via BFS per edge (approximate SSSR)."""
    n = mol.num_atoms
    adj = [[] for _ in range(n)]
    for (a, b) in mol.bonds:
        adj[a].append(b)
        adj[b].append(a)
    cycles: List[List[int]] = []
    seen_cycles: Set[frozenset] = set()
    for (a, b) in mol.bonds:
        # shortest path a->b avoiding edge (a,b)
        prev = {a: -1}
        queue = [a]
        found = False
        while queue and not found:
            nxt = []
            for v in queue:
                for u in adj[v]:
                    if (v == a and u == b) or (v == b and u == a):
                        continue
                    if u not in prev:
                        prev[u] = v
                        if u == b:
                            found = True
                            break
                        nxt.append(u)
                if found:
                    break
            queue = nxt
        if found:
            path = [b]
            while path[-1] != a:
                path.append(prev[path[-1]])
            key = frozenset(path)
            if key not in seen_cycles:
                seen_cycles.add(key)
                cycles.append(path)
    return cycles


def _aromatic_flags(mol: Mol) -> List[bool]:
    flags = [a.aromatic for a in mol.atoms]
    # post-kekulization: mark atoms in alternating rings as aromatic-ish
    for cyc in _ring_info(mol):
        if len(cyc) in (5, 6):
            orders = []
            for i in range(len(cyc)):
                o = mol.get_bond(cyc[i], cyc[(i + 1) % len(cyc)])
                orders.append(o)
            if orders.count(2.0) >= len(cyc) // 2 - 1:
                for v in cyc:
                    flags[v] = True
    return flags


def num_long_cycles(mol: Mol, max_len: int = 6) -> int:
    """Number of rings longer than ``max_len`` (the cycle term of
    penalized logP, environment.py:94-103)."""
    return sum(1 for c in _ring_info(mol) if len(c) > max_len)


def largest_cycle_len(mol: Mol) -> int:
    cycles = _ring_info(mol)
    return max((len(c) for c in cycles), default=0)


def implicit_h_count(mol: Mol, i: int) -> int:
    from .mol import DEFAULT_VALENCE
    atom = mol.atoms[i]
    if atom.n_explicit_h is not None:
        return atom.n_explicit_h
    allowed = DEFAULT_VALENCE.get(atom.z, (0,))
    val = mol.explicit_valence(i)
    for cap in sorted(allowed):
        if val <= cap:
            return int(cap - val + atom.charge * (1 if atom.z in (7,) else -1)
                       ) if False else int(cap - val)
    return 0


def crippen_logp(mol: Mol) -> float:
    if _HAVE_RDKIT:  # pragma: no cover
        from rdkit.Chem import Crippen
        from .smiles import mol_to_smiles
        m = Chem.MolFromSmiles(mol_to_smiles(mol))
        if m is not None:
            return float(Crippen.MolLogP(m))
    flags = _aromatic_flags(mol)
    total = 0.0
    for i, atom in enumerate(mol.atoms):
        total += _CRIPPEN.get((atom.z, flags[i]),
                              _CRIPPEN.get((atom.z, False), 0.0))
        total += 0.1230 * implicit_h_count(mol, i)
    return total


def sa_score_proxy(mol: Mol) -> float:
    """Ertl-SA-like score in [1, 10] (lower = easier to synthesize):
    penalties for size, branching, ring complexity, heteroatom fraction."""
    if _HAVE_RDKIT:  # pragma: no cover
        try:
            from rdkit.Chem import RDConfig
            import sys, os
            sys.path.append(os.path.join(RDConfig.RDContribDir, "SA_Score"))
            import sascorer
            from .smiles import mol_to_smiles
            m = Chem.MolFromSmiles(mol_to_smiles(mol))
            if m is not None:
                return float(sascorer.calculateScore(m))
        except Exception:
            pass
    n = max(mol.num_atoms, 1)
    size_pen = max(0.0, math.log(n / 25.0)) if n > 25 else 0.0
    deg = [len(mol.neighbors(i)) for i in range(n)]
    branch_pen = sum(max(0, d - 3) for d in deg) / n
    cycles = _ring_info(mol)
    ring_pen = 0.3 * len(cycles) + sum(
        0.5 for c in cycles if len(c) > 6 or len(c) < 5)
    hetero = sum(1 for a in mol.atoms if a.z not in (1, 6)) / n
    raw = 1.0 + 2.0 * branch_pen + ring_pen + size_pen + 2.0 * hetero
    return float(min(max(raw, 1.0), 10.0))


def penalized_logp(mol: Mol) -> float:
    """logP - SA - #long-cycles, normalized by the ZINC250k statistics used
    by the reference (environment.py:77-120: logP_m=2.4570953396190123,
    logP_s=1.434324401111988, SA_m=-3.0525811293166134,
    SA_s=0.8335207024513095, cycle_m=-0.0485696876403053,
    cycle_s=0.2860212110245455)."""
    log_p = crippen_logp(mol)
    sa = -sa_score_proxy(mol)
    cycle = -num_long_cycles(mol)
    log_p_n = (log_p - 2.4570953396190123) / 1.434324401111988
    sa_n = (sa - (-3.0525811293166134)) / 0.8335207024513095
    cyc_n = (cycle - (-0.0485696876403053)) / 0.2860212110245455
    return float(log_p_n + sa_n + cyc_n)


def _desirability(x, a, b):
    """Smooth bump: 1 inside [a, b], decaying outside."""
    if x < a:
        return math.exp(-((a - x) ** 2) / (2 * ((b - a) / 4 + 1e-9) ** 2))
    if x > b:
        return math.exp(-((x - b) ** 2) / (2 * ((b - a) / 4 + 1e-9) ** 2))
    return 1.0


_MW = {1: 1.008, 5: 10.81, 6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998,
       14: 28.085, 15: 30.974, 16: 32.06, 17: 35.45, 35: 79.904, 53: 126.9}


def qed_proxy(mol: Mol) -> float:
    """QED-style drug-likeness in [0, 1]."""
    if _HAVE_RDKIT:  # pragma: no cover
        from rdkit.Chem import QED
        from .smiles import mol_to_smiles
        m = Chem.MolFromSmiles(mol_to_smiles(mol))
        if m is not None:
            return float(QED.qed(m))
    mw = sum(_MW.get(a.z, 30.0) for a in mol.atoms) + sum(
        _MW[1] * implicit_h_count(mol, i) for i in range(mol.num_atoms))
    logp = crippen_logp(mol)
    n_rings = len(_ring_info(mol))
    hbd = sum(1 for i, a in enumerate(mol.atoms)
              if a.z in (7, 8) and implicit_h_count(mol, i) > 0)
    hba = sum(1 for a in mol.atoms if a.z in (7, 8))
    d = [
        _desirability(mw, 160, 480),
        _desirability(logp, -0.4, 5.6),
        _desirability(n_rings, 1, 4),
        _desirability(hbd, 0, 5),
        _desirability(hba, 0, 10),
    ]
    return float(np.exp(np.mean(np.log(np.maximum(d, 1e-9)))))
