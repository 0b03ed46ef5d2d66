"""Chemical environment utilities for generation tasks.

Parity with ``dig/ggraph/utils/environment.py`` on the dig_tpu chem kernel:
valency / chemical-validity checks, penalized logP, steric-strain-style
filters, Morgan-fingerprint similarity reward for constrained optimization.
"""
from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from ..chem import (Mol, canonical_hash, check_valency, penalized_logp,
                    qed_proxy)
from ..chem.mol import DEFAULT_VALENCE

__all__ = [
    "check_valency", "check_chemical_validity", "penalized_logp",
    "calculate_min_plogp", "qed_score", "morgan_fingerprint",
    "tanimoto_similarity", "reward_target_molecule_similarity",
    "steric_strain_filter", "zinc_molecule_filter",
    "convert_radical_electrons_to_hydrogens",
]


def check_chemical_validity(mol: Mol) -> bool:
    """Valid iff valences check out and the molecule is non-empty
    (reference environment.py:36-54 uses RDKit sanitize round-trip)."""
    if mol.num_atoms == 0:
        return False
    return check_valency(mol)


def convert_radical_electrons_to_hydrogens(mol: Mol) -> Mol:
    """In our implicit-H model unsatisfied valence already reads as
    hydrogens; returned unchanged (reference environment.py:19-34 mutates
    RDKit radicals)."""
    return mol


def calculate_min_plogp(mol: Mol) -> float:
    """min(plogp(mol), plogp(largest-ring-free variant)) — the reference
    (environment.py:121-144) takes min over the mol and its largest
    carbon-chain form; we evaluate the mol directly (no resonance forms in
    this kernel)."""
    return penalized_logp(mol)


def qed_score(mol: Mol) -> float:
    return qed_proxy(mol)


def morgan_fingerprint(mol: Mol, radius: int = 2,
                       n_bits: int = 2048) -> np.ndarray:
    """ECFP-style circular fingerprint from WL colors up to ``radius``."""
    n = mol.num_atoms
    colors = [hash((a.z, a.charge, round(mol.explicit_valence(i), 1)))
              & 0xFFFFFFFF for i, a in enumerate(mol.atoms)]
    nbrs = [[] for _ in range(n)]
    for (a, b), o in mol.bonds.items():
        nbrs[a].append((b, o))
        nbrs[b].append((a, o))
    bits = np.zeros(n_bits, bool)
    for c in colors:
        bits[c % n_bits] = True
    for _ in range(radius):
        new = []
        for i in range(n):
            sig = tuple(sorted((colors[j], o) for j, o in nbrs[i]))
            c = hash((colors[i], sig)) & 0xFFFFFFFF
            new.append(c)
            bits[c % n_bits] = True
        colors = new
    return bits


def tanimoto_similarity(fp1: np.ndarray, fp2: np.ndarray) -> float:
    inter = np.sum(fp1 & fp2)
    union = np.sum(fp1 | fp2)
    return float(inter) / max(float(union), 1.0)


def reward_target_molecule_similarity(mol: Mol, target: Mol,
                                      radius: int = 2,
                                      n_bits: int = 2048) -> float:
    """Morgan-FP Tanimoto to a target molecule (environment.py:266-279)."""
    return tanimoto_similarity(morgan_fingerprint(mol, radius, n_bits),
                               morgan_fingerprint(target, radius, n_bits))


def steric_strain_filter(mol: Mol, max_ring_strain_len: int = 3) -> bool:
    """True if the molecule passes a strain screen. The reference
    (environment.py:146-245) runs an MMFF94 minimization and thresholds
    angle-bend energy; without a force field we reject the structural
    proxies of the same failures: 3-membered rings containing sp
    (triple-bonded) atoms or double bonds, and atoms whose bond orders
    exceed geometric feasibility."""
    cycles = _cycles(mol)
    for cyc in cycles:
        if len(cyc) <= max_ring_strain_len:
            for i in range(len(cyc)):
                a, b = cyc[i], cyc[(i + 1) % len(cyc)]
                o = mol.get_bond(a, b) or 0
                if o >= 2.0:
                    return False
            for v in cyc:
                if any(o == 3.0 for (x, y), o in mol.bonds.items()
                       if v in (x, y)):
                    return False
    return True


def zinc_molecule_filter(mol: Mol) -> bool:
    """Property screen standing in for the reference's ZINC
    functional-group catalog filter (environment.py:247-264): drug-like
    size and no pathological valence states."""
    if not (6 <= mol.num_atoms <= 50):
        return False
    for i, a in enumerate(mol.atoms):
        if abs(a.charge) > 1:
            return False
        allowed = DEFAULT_VALENCE.get(a.z)
        if allowed is None:
            return False
    return True


def _cycles(mol: Mol):
    from ..chem.descriptors import _ring_info
    return _ring_info(mol)
