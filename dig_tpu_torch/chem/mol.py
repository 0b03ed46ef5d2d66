"""Molecular graph type + valence rules + dense-tensor conversion.

Replaces the RDKit surface the reference uses in its generation stack:
``check_valency`` (``dig/ggraph/utils/environment.py:56``),
``RWMol.AddAtom/AddBond/RemoveBond`` (``GraphDF/model/graphflow.py:58-229``),
and mol->canonical-SMILES uniqueness hashing
(``dig/ggraph/evaluation/metric.py:16-48``). Canonicalization here is a
Morgan/WL color-refinement hash — same equivalence classes as canonical
SMILES for the purposes of uniqueness/novelty counting.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SYMBOL = {1: "H", 5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 14: "Si",
          15: "P", 16: "S", 17: "Cl", 35: "Br", 53: "I"}
NUMBER = {v: k for k, v in SYMBOL.items()}

# Allowed total bond-order valences per element (neutral atoms), mirroring
# RDKit's default periodic-table valence lists.
DEFAULT_VALENCE: Dict[int, Tuple[int, ...]] = {
    1: (1,), 5: (3,), 6: (4,), 7: (3,), 8: (2,), 9: (1,),
    14: (4,), 15: (3, 5), 16: (2, 4, 6), 17: (1,), 35: (1,), 53: (1, 3, 5),
}


def valence_of(z: int) -> int:
    return max(DEFAULT_VALENCE.get(z, (8,)))


@dataclass
class Atom:
    z: int
    charge: int = 0
    n_explicit_h: Optional[int] = None  # None = implicit (fill valence)
    aromatic: bool = False


@dataclass
class Mol:
    """Editable molecular graph: atoms + integer-order bonds (1, 2, 3;
    1.5 for aromatic before kekulization)."""

    atoms: List[Atom] = field(default_factory=list)
    bonds: Dict[Tuple[int, int], float] = field(default_factory=dict)

    # -- construction ----------------------------------------------------
    def add_atom(self, z: int, charge: int = 0,
                 aromatic: bool = False) -> int:
        self.atoms.append(Atom(z=z, charge=charge, aromatic=aromatic))
        return len(self.atoms) - 1

    def add_bond(self, i: int, j: int, order: float = 1.0) -> None:
        if i == j:
            raise ValueError("self-bond")
        self.bonds[(min(i, j), max(i, j))] = float(order)

    def remove_bond(self, i: int, j: int) -> None:
        self.bonds.pop((min(i, j), max(i, j)), None)

    def get_bond(self, i: int, j: int) -> Optional[float]:
        return self.bonds.get((min(i, j), max(i, j)))

    def copy(self) -> "Mol":
        return Mol(atoms=[Atom(a.z, a.charge, a.n_explicit_h, a.aromatic)
                          for a in self.atoms],
                   bonds=dict(self.bonds))

    # -- queries ---------------------------------------------------------
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def GetNumAtoms(self) -> int:  # RDKit-compatible alias
        return self.num_atoms

    def neighbors(self, i: int) -> List[int]:
        out = []
        for (a, b) in self.bonds:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return out

    def explicit_valence(self, i: int) -> float:
        return sum(o for (a, b), o in self.bonds.items() if a == i or b == i)

    def adjacency(self) -> np.ndarray:
        n = self.num_atoms
        A = np.zeros((n, n), np.float32)
        for (a, b), o in self.bonds.items():
            A[a, b] = A[b, a] = o
        return A


def check_valency(mol: Mol) -> bool:
    """True iff every atom's total bond order fits an allowed valence
    (+ charge adjustment), the semantics of the reference's RDKit
    ``SanitizeMol(..., SANITIZE_PROPERTIES)`` probe
    (``environment.py:56-75``)."""
    for i, atom in enumerate(mol.atoms):
        allowed = DEFAULT_VALENCE.get(atom.z, (8,))
        cap = max(allowed) + (atom.charge if atom.z in (7, 15) else
                              -abs(atom.charge) if atom.charge else 0)
        if mol.explicit_valence(i) > cap:
            return False
    return True


# -- dense one-hot tensor conversion (GraphDF/AF/EBM layout) --------------

def mol_to_dense(mol: Mol, atom_list: Sequence[int], max_size: int,
                 order: Optional[Sequence[int]] = None):
    """Mol -> (x [max_size, n_types+?], adj [4, max_size, max_size]) in the
    reference's dense one-hot layout (``PygDataset.py:16-376``): bond
    channels 0/1/2 = single/double/triple, channel 3 = virtual (no bond);
    adj has self-loops set on all 4 channels for real atoms... channel 3
    carries the complement. Atom ordering per ``order`` (e.g. BFS)."""
    n_types = len(atom_list)
    z_to_idx = {z: k for k, z in enumerate(atom_list)}
    n = mol.num_atoms
    if n > max_size:
        raise ValueError(f"{n} atoms > max_size {max_size}")
    perm = list(order) if order is not None else list(range(n))
    inv = {old: new for new, old in enumerate(perm)}

    x = np.zeros((max_size, n_types), np.float32)
    adj = np.zeros((4, max_size, max_size), np.float32)
    adj[3] = 1.0 - np.eye(max_size)
    for old_i, atom in enumerate(mol.atoms):
        i = inv[old_i]
        x[i, z_to_idx[atom.z]] = 1.0
    for (a, b), o_ in mol.bonds.items():
        i, j = inv[a], inv[b]
        ch = int(round(o_)) - 1
        ch = min(max(ch, 0), 2)
        adj[ch, i, j] = adj[ch, j, i] = 1.0
        adj[3, i, j] = adj[3, j, i] = 0.0
    # Self-loops on every channel for REAL atoms: the autoregressive
    # samplers build prefixes with adj[:, i, i] = 1 as atom i is added
    # (methods.py, mirroring reference graphflow.py:108), so training
    # tensors must look the same or the reverse flow is conditioned out
    # of distribution — measured round 5, this mismatch (training diag 0)
    # made first-try validity erratic across training runs (0.08-0.65 at
    # matched NLL). The reference's PygDataset adds np.eye over ALL rows
    # AFTER the ch-3 complement (PygDataset.py:246), giving its virtual
    # channel a 2.0 diagonal and self-loops on padding rows — we match
    # the GENERATION convention (1.0, real atoms only) instead.
    for old_i in range(n):
        adj[:, inv[old_i], inv[old_i]] = 1.0
    return x, adj


def mol_from_dense(x: np.ndarray, adj: np.ndarray,
                   atom_list: Sequence[int]) -> Mol:
    """(x, adj) one-hot tensors -> Mol; rows with all-zero x are padding."""
    x = np.asarray(x)
    adj = np.asarray(adj)
    mol = Mol()
    idx_map = {}
    for i in range(x.shape[0]):
        if x[i].sum() > 0:
            idx_map[i] = mol.add_atom(int(atom_list[int(np.argmax(x[i]))]))
    for ch, order in ((0, 1.0), (1, 2.0), (2, 3.0)):
        ii, jj = np.nonzero(np.triu(adj[ch], 1))
        for a, b in zip(ii, jj):
            if int(a) in idx_map and int(b) in idx_map:
                mol.add_bond(idx_map[int(a)], idx_map[int(b)], order)
    return mol


def bfs_order(mol: Mol, start: int = 0) -> List[int]:
    """BFS atom ordering (the reference canonicalizes training tensors by
    BFS over the RDKit mol, ``PygDataset.py``)."""
    n = mol.num_atoms
    seen = [False] * n
    order: List[int] = []
    for root in list(range(start, n)) + list(range(0, start)):
        if seen[root]:
            continue
        queue = [root]
        seen[root] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            for u in sorted(mol.neighbors(v)):
                if not seen[u]:
                    seen[u] = True
                    queue.append(u)
    return order


# -- canonical hashing ----------------------------------------------------

def canonical_hash(mol: Mol, iters: int = 6) -> str:
    """Morgan/WL color-refinement canonical hash. Two molecules with the
    same hash are isomorphic for all practical purposes (used for
    uniqueness & novelty counting, replacing canonical-SMILES equality in
    ``RandGenEvaluator``, ``dig/ggraph/evaluation/metric.py:16-48``)."""
    n = mol.num_atoms
    if n == 0:
        return "empty"
    colors = [hash((a.z, a.charge)) & 0xFFFFFFFF for a in mol.atoms]
    nbrs: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for (a, b), o in mol.bonds.items():
        nbrs[a].append((b, o))
        nbrs[b].append((a, o))
    for _ in range(iters):
        new = []
        for i in range(n):
            sig = sorted((colors[j], o) for j, o in nbrs[i])
            new.append(hash((colors[i], tuple(sig))) & 0xFFFFFFFF)
        if sorted(new) == sorted(colors):
            colors = new
            break
        colors = new
    payload = ",".join(map(str, sorted(colors)))
    payload += "|" + ",".join(
        map(str, sorted([tuple(sorted((colors[a], colors[b]))) + (o,)
                         for (a, b), o in mol.bonds.items()])))
    return hashlib.sha1(payload.encode()).hexdigest()
