"""Minimal self-contained chemistry kernel (a copy of ``dig_tpu.chem``,
which imports no framework; numpy and the stdlib only).

The reference leans on RDKit for everything molecular (valency checks,
SMILES round-trips, canonicalization, descriptors — e.g.
``dig/ggraph/utils/environment.py``). RDKit is not available in this
environment, so the package ships its own small chem kernel:

* :mod:`mol` — molecular graph type, valence rules, ``check_valency``,
  dense one-hot (x, adj) <-> Mol conversion, Morgan-style canonical hash
  (uniqueness/novelty metrics).
* :mod:`smiles` — SMILES parser + writer for the organic subset incl.
  aromatic-ring kekulization (enough for QM9/ZINC-class molecules).
* :mod:`descriptors` — logP (Wildman–Crippen-style coarse atom typing),
  ring/cycle statistics, penalized logP, synthetic-accessibility proxy, QED
  proxy. When real RDKit is importable it is used instead (exact parity).

All functions accept/return :class:`Mol`; anything RDKit-specific in the
reference maps onto this surface.
"""
from .mol import (Mol, Atom, check_valency, mol_from_dense, mol_to_dense,
                  canonical_hash, valence_of, DEFAULT_VALENCE)
from .smiles import mol_from_smiles, mol_to_smiles
from .descriptors import (crippen_logp, penalized_logp, qed_proxy,
                          sa_score_proxy, num_long_cycles)

RDKIT_AVAILABLE = False
try:  # pragma: no cover
    import rdkit  # noqa: F401
    RDKIT_AVAILABLE = True
except ImportError:
    pass

__all__ = [
    "Mol", "Atom", "check_valency", "mol_from_dense", "mol_to_dense",
    "canonical_hash", "valence_of", "DEFAULT_VALENCE",
    "mol_from_smiles", "mol_to_smiles",
    "crippen_logp", "penalized_logp", "qed_proxy", "sa_score_proxy",
    "num_long_cycles", "RDKIT_AVAILABLE",
]
