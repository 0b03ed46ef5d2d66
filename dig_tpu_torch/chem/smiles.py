"""SMILES parser + writer (organic subset, with kekulization).

Replaces the reference's RDKit ``Chem.MolFromSmiles``/``MolToSmiles`` at the
data edge (``dig/ggraph/dataset/PygDataset.py`` builds training tensors from
SMILES columns). Supports: organic-subset atoms (B C N O P S F Cl Br I, H),
bracket atoms with charge/explicit H/isotope, bonds ``- = # :``, branches,
ring closures (digits + %nn), aromatic lowercase forms with ring
kekulization (backtracking perfect matching), and '.'-separated fragments
(largest kept, as the reference does for ZINC).

Not supported (raises): stereo beyond ignoring ``/ \\ @``, wildcards.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .mol import Atom, Mol, NUMBER, SYMBOL, DEFAULT_VALENCE

_ORGANIC = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I"]
_AROMATIC = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16}


class SmilesError(ValueError):
    pass


def _parse_bracket(tok: str) -> Atom:
    """Parse the inside of [...]: [13CH3+], [nH], [O-], [NH4+]."""
    i = 0
    while i < len(tok) and tok[i].isdigit():  # isotope: ignored
        i += 1
    aromatic = False
    if i < len(tok) and tok[i:i + 2] in ("Cl", "Br", "Si"):
        sym = tok[i:i + 2]
        i += 2
    elif i < len(tok) and tok[i].isupper():
        sym = tok[i]
        i += 1
        if i < len(tok) and tok[i].islower() and tok[i] not in "hH+-" and \
                sym + tok[i] in NUMBER:
            sym += tok[i]
            i += 1
    elif i < len(tok) and tok[i] in _AROMATIC:
        sym = tok[i].upper()
        aromatic = True
        i += 1
    else:
        raise SmilesError(f"bad bracket atom [{tok}]")
    if sym == "H":
        z = 1
    else:
        z = NUMBER.get(sym)
        if z is None:
            raise SmilesError(f"unknown element {sym}")
    n_h = 0
    charge = 0
    while i < len(tok):
        c = tok[i]
        if c == "H":
            i += 1
            n_h = 1
            if i < len(tok) and tok[i].isdigit():
                n_h = int(tok[i])
                i += 1
        elif c in "+-":
            sign = 1 if c == "+" else -1
            i += 1
            if i < len(tok) and tok[i].isdigit():
                charge = sign * int(tok[i])
                i += 1
            else:
                charge = sign
                while i < len(tok) and tok[i] == c:
                    charge += sign
                    i += 1
        elif c == "@":
            i += 1  # ignore chirality
        else:
            raise SmilesError(f"bad bracket char {c} in [{tok}]")
    return Atom(z=z, charge=charge, n_explicit_h=n_h, aromatic=aromatic)


def mol_from_smiles(s: str, kekulize: bool = True,
                    largest_fragment: bool = True) -> Mol:
    frags = s.split(".")
    mols = [_parse_fragment(f) for f in frags if f]
    if not mols:
        raise SmilesError("empty SMILES")
    mol = max(mols, key=lambda m: m.num_atoms) if largest_fragment else mols[0]
    if kekulize:
        _kekulize(mol)
    return mol


def _parse_fragment(s: str) -> Mol:
    mol = Mol()
    stack: List[int] = []
    prev: Optional[int] = None
    pending_bond: Optional[float] = None
    pending_aromatic_bond = False
    ring: Dict[int, Tuple[int, Optional[float], bool]] = {}
    i = 0
    n = len(s)

    def attach(idx: int):
        nonlocal prev, pending_bond, pending_aromatic_bond
        if prev is not None:
            if pending_bond is not None:
                order = pending_bond
            elif (pending_aromatic_bond or
                  (mol.atoms[prev].aromatic and mol.atoms[idx].aromatic)):
                order = 1.5
            else:
                order = 1.0
            mol.add_bond(prev, idx, order)
        prev = idx
        pending_bond = None
        pending_aromatic_bond = False

    while i < n:
        c = s[i]
        if c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            prev = stack.pop()
            i += 1
        elif c in "-=#":
            pending_bond = {"-": 1.0, "=": 2.0, "#": 3.0}[c]
            i += 1
        elif c == ":":
            pending_aromatic_bond = True
            i += 1
        elif c in "/\\":
            i += 1  # stereo bonds -> single
        elif c == "[":
            j = s.index("]", i)
            atom = _parse_bracket(s[i + 1:j])
            idx = len(mol.atoms)
            mol.atoms.append(atom)
            attach(idx)
            i = j + 1
        elif c.isdigit() or c == "%":
            if c == "%":
                num = int(s[i + 1:i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if num in ring:
                other, bond0, arom0 = ring.pop(num)
                if pending_bond is not None:
                    order = pending_bond
                elif bond0 is not None:
                    order = bond0
                elif (arom0 or pending_aromatic_bond or
                      (mol.atoms[other].aromatic and
                       mol.atoms[prev].aromatic)):
                    order = 1.5
                else:
                    order = 1.0
                mol.add_bond(other, prev, order)
                pending_bond = None
                pending_aromatic_bond = False
            else:
                ring[num] = (prev, pending_bond, pending_aromatic_bond)
                pending_bond = None
                pending_aromatic_bond = False
        else:
            sym = None
            for cand in _ORGANIC:
                if s.startswith(cand, i):
                    sym = cand
                    break
            if sym is not None:
                idx = mol.add_atom(NUMBER[sym])
                attach(idx)
                i += len(sym)
            elif c in _AROMATIC:
                idx = mol.add_atom(_AROMATIC[c], aromatic=True)
                attach(idx)
                i += 1
            elif c == "H":
                idx = mol.add_atom(1)
                attach(idx)
                i += 1
            else:
                raise SmilesError(f"unexpected char {c!r} at {i} in {s!r}")
    if ring:
        raise SmilesError(f"unclosed ring bonds {sorted(ring)} in {s!r}")
    return mol


def _kekulize(mol: Mol) -> None:
    """Assign alternating single/double bonds to aromatic systems via
    backtracking perfect matching over atoms that need a double bond."""
    arom_bonds = [(a, b) for (a, b), o in mol.bonds.items() if o == 1.5]
    if not arom_bonds:
        return
    arom_atoms = sorted({a for ab in arom_bonds for a in ab})

    def needs_double(i: int) -> bool:
        atom = mol.atoms[i]
        # exocyclic double bond already present?
        exo = any(o == 2.0 for (a, b), o in mol.bonds.items()
                  if (a == i or b == i))
        if exo:
            return False
        if atom.z == 6:
            return atom.charge == 0
        if atom.z == 7:
            if atom.n_explicit_h:
                return False
            if atom.charge == -1:
                return False
            if atom.charge == 1:
                return True
            # pyridine-type N (2 ring bonds) needs a double; pyrrole-type
            # (3 connections) does not
            return len(mol.neighbors(i)) <= 2
        if atom.z == 15:
            return len(mol.neighbors(i)) <= 2
        if atom.z in (8, 16):
            return atom.charge == 1
        if atom.z == 5:
            return False
        return False

    need = {i for i in arom_atoms if needs_double(i)}
    adj = {i: [] for i in arom_atoms}
    for a, b in arom_bonds:
        adj[a].append(b)
        adj[b].append(a)

    matched: Dict[int, int] = {}

    def backtrack(todo: List[int]) -> bool:
        while todo and (todo[-1] in matched or todo[-1] not in need):
            todo = todo[:-1]
        if not todo:
            return True
        v = todo[-1]
        for u in adj[v]:
            if u in need and u not in matched:
                matched[v] = u
                matched[u] = v
                if backtrack(todo[:-1]):
                    return True
                del matched[v]
                del matched[u]
        return False

    if not backtrack(sorted(need, key=lambda i: len(adj[i]))):
        raise SmilesError("kekulization failed")
    for a, b in arom_bonds:
        if matched.get(a) == b:
            mol.bonds[(min(a, b), max(a, b))] = 2.0
        else:
            mol.bonds[(min(a, b), max(a, b))] = 1.0
    for i in arom_atoms:
        mol.atoms[i].aromatic = False


_BOND_CHAR = {1.0: "", 2.0: "=", 3.0: "#"}


def mol_to_smiles(mol: Mol) -> str:
    """Write (kekulized) SMILES via DFS with ring-closure digits. Not
    canonical across implementations, but stable for round-trips."""
    n = mol.num_atoms
    if n == 0:
        return ""
    visited = [False] * n
    ring_bonds: Dict[Tuple[int, int], int] = {}
    counter = [0]

    # find ring bonds (DFS back edges)
    parent = [-1] * n
    state = [0] * n
    for root in range(n):
        if state[root]:
            continue
        stack = [(root, -1)]
        while stack:
            v, p = stack.pop()
            if state[v]:
                continue
            state[v] = 1
            parent[v] = p
            for u in sorted(mol.neighbors(v), reverse=True):
                if u == p:
                    continue
                if state[u]:
                    key = (min(u, v), max(u, v))
                    if key not in ring_bonds:
                        counter[0] += 1
                        ring_bonds[key] = counter[0]
                else:
                    stack.append((u, v))

    def atom_str(i: int) -> str:
        a = mol.atoms[i]
        sym = SYMBOL.get(a.z, f"[#{a.z}]")
        plain = (a.charge == 0 and a.n_explicit_h is None
                 and sym in ("B", "C", "N", "O", "P", "S", "F", "Cl", "Br",
                             "I"))
        if plain:
            return sym
        h = ""
        if a.n_explicit_h:
            h = "H" if a.n_explicit_h == 1 else f"H{a.n_explicit_h}"
        if a.charge > 0:
            ch = "+" if a.charge == 1 else f"+{a.charge}"
        elif a.charge < 0:
            ch = "-" if a.charge == -1 else f"-{-a.charge}"
        else:
            ch = ""
        return f"[{sym}{h}{ch}]"

    out: List[str] = []

    def dfs(v: int, p: int):
        visited[v] = True
        out.append(atom_str(v))
        for (a, b), num in ring_bonds.items():
            if v in (a, b):
                o = mol.bonds[(a, b)]
                other = b if a == v else a
                if not visited[other] or (visited[other] and True):
                    out.append(_BOND_CHAR.get(o, "") + (
                        str(num) if num < 10 else f"%{num:02d}"))
        children = [u for u in sorted(mol.neighbors(v))
                    if u != p and not visited[u]
                    and (min(u, v), max(u, v)) not in ring_bonds]
        for k, u in enumerate(children):
            o = mol.bonds[(min(u, v), max(u, v))]
            bond_s = _BOND_CHAR.get(o, "")
            if k < len(children) - 1:
                out.append("(")
                out.append(bond_s)
                dfs(u, v)
                out.append(")")
            else:
                out.append(bond_s)
                dfs(u, v)

    roots = [i for i in range(n)]
    first = True
    for r in roots:
        if not visited[r]:
            if not first:
                out.append(".")
            dfs(r, -1)
            first = False
    return "".join(out)
