"""JTMPN candidate scoring for junction-tree assembly (port of
``dig_tpu.ggraph.jtmpn``).

The hardest part of JTVAE (reference
``dig/ggraph/method/JTVAE/fast_jtnn/jtmpn.py`` + the candidate
enumeration in ``chemutils.py::enum_assemble``): when decoding, adjacent
tree clusters must be merged by *identifying shared atoms* (junctions),
and among the many chemically-feasible merges a learned message-passing
network scores the right one. Round 1 shipped greedy first-feasible
stitching; this module adds the real mechanism:

* :func:`merge_at` / :func:`merge_bond` — attach a fragment by
  identifying one shared atom (ring-chain junction) or a shared bond
  (fused/bond junction), the two junction types our tree decomposition
  produces.
* :func:`enumerate_candidates` — all valency-feasible merges, deduped by
  canonical hash, capped (static shapes downstream).
* :class:`JTMPNScorer` — a bond-channel MPN over the dense candidate
  tensors scoring each candidate (the JTMPN role); trained with
  cross-entropy against the true attachment extracted from training
  molecules (:func:`build_assembly_fixtures`).
* :func:`assemble_scored` — sequential decoding-time assembly picking
  the best-scoring feasible candidate at each junction.

Enumeration/merging is host-side chemistry (like the reference's RDKit
loop), copied; scoring is one batched forward over the padded candidate
tensors. ``train_assembler`` returns the trained scorer module, which
carries its weights: ``assembly_accuracy`` / ``assemble_scored`` take it
where the JAX package takes ``(scorer, params)``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..chem import Mol, check_valency
from ..chem.mol import canonical_hash
from ..device import DeviceLike, resolve_device
from .models.layers import default_generator, linear

ATOM_LIST = (6, 7, 8, 9, 15, 16, 17, 35, 53, 1)
MAX_CAND_ATOMS = 24
MAX_CANDS = 16


def merge_at(mol: Mol, frag: Mol, mol_atom: int,
             frag_atom: int) -> Optional[Mol]:
    """Merge ``frag`` into ``mol`` identifying ``frag_atom`` with
    ``mol_atom`` (single-atom junction). None if infeasible."""
    if mol.atoms[mol_atom].z != frag.atoms[frag_atom].z:
        return None
    trial = mol.copy()
    mapping = {frag_atom: mol_atom}
    for i, at in enumerate(frag.atoms):
        if i != frag_atom:
            mapping[i] = trial.add_atom(at.z, at.charge)
    for (x, y), o in frag.bonds.items():
        a, b = mapping[x], mapping[y]
        if trial.get_bond(a, b) is None:
            trial.add_bond(a, b, o)
    return trial if check_valency(trial) else None


def merge_bond(mol: Mol, frag: Mol, mol_pair: Tuple[int, int],
               frag_pair: Tuple[int, int]) -> Optional[Mol]:
    """Merge identifying the bonded pair ``frag_pair`` with ``mol_pair``
    (bond junction: fused rings / ring-bond clusters)."""
    (a1, a2), (f1, f2) = mol_pair, frag_pair
    if (mol.atoms[a1].z != frag.atoms[f1].z
            or mol.atoms[a2].z != frag.atoms[f2].z):
        return None
    ob_m = mol.get_bond(a1, a2)
    ob_f = frag.get_bond(f1, f2)
    if ob_m is None or ob_f is None or ob_m != ob_f:
        return None
    trial = mol.copy()
    mapping = {f1: a1, f2: a2}
    for i, at in enumerate(frag.atoms):
        if i not in mapping:
            mapping[i] = trial.add_atom(at.z, at.charge)
    for (x, y), o in frag.bonds.items():
        a, b = mapping[x], mapping[y]
        if trial.get_bond(a, b) is None:
            trial.add_bond(a, b, o)
    return trial if check_valency(trial) else None


def enumerate_candidates(mol: Mol, frag: Mol,
                         max_cands: int = MAX_CANDS) -> List[Mol]:
    """All feasible merges of ``frag`` onto ``mol`` (atom and bond
    junctions), deduplicated by canonical hash."""
    cands: List[Mol] = []
    seen = set()

    def push(m: Optional[Mol]):
        if m is None or m.num_atoms > MAX_CAND_ATOMS:
            return
        h = canonical_hash(m)
        if h not in seen:
            seen.add(h)
            cands.append(m)

    for a in range(mol.num_atoms):
        for fa in range(frag.num_atoms):
            if len(cands) >= max_cands:
                return cands
            push(merge_at(mol, frag, a, fa))
    for (a1, a2) in list(mol.bonds):
        for (f1, f2) in list(frag.bonds):
            for fp in ((f1, f2), (f2, f1)):
                if len(cands) >= max_cands:
                    return cands
                push(merge_bond(mol, frag, (a1, a2), fp))
    return cands


def featurize(mols: Sequence[Mol], max_atoms: int = MAX_CAND_ATOMS):
    """Dense candidate tensors: x [K, A, F], adj [K, 4, A, A], amask
    [K, A]. Features: element one-hot + degree/4 + charge."""
    z_idx = {z: i for i, z in enumerate(ATOM_LIST)}
    F = len(ATOM_LIST) + 2
    K = len(mols)
    x = np.zeros((K, max_atoms, F), np.float32)
    adj = np.zeros((K, 4, max_atoms, max_atoms), np.float32)
    amask = np.zeros((K, max_atoms), np.float32)
    for k, m in enumerate(mols):
        n = min(m.num_atoms, max_atoms)
        for i in range(n):
            at = m.atoms[i]
            x[k, i, z_idx.get(at.z, len(ATOM_LIST) - 1)] = 1.0
            x[k, i, -2] = len(m.neighbors(i)) / 4.0
            x[k, i, -1] = at.charge
            amask[k, i] = 1.0
        for (a, b), o in m.bonds.items():
            if a < max_atoms and b < max_atoms:
                ch = min(int(o) - 1, 2)
                adj[k, ch, a, b] = adj[k, ch, b, a] = 1.0
        adj[k, 3, :n, :n] = 1.0 - np.eye(n)[: n, : n]
    return torch.from_numpy(x), torch.from_numpy(adj), torch.from_numpy(amask)


class JTMPNScorer(nn.Module):
    """Bond-channel MPN -> pooled embedding -> scalar score per candidate
    (the JTMPN of ``fast_jtnn/jtmpn.py``, as dense batched matmuls).
    flax infers the input width; here it is ``in_features`` (featurize's
    ``len(ATOM_LIST) + 2``). flax's default ``Dense`` init (lecun_normal)."""

    def __init__(self, hidden: int = 64, depth: int = 3,
                 in_features: int = len(ATOM_LIST) + 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.lin0 = linear(in_features, hidden, gen, init="lecun")
        self.msgs = nn.ModuleList(linear(3 * hidden, hidden, gen,
                                         init="lecun") for _ in range(depth))
        self.pool = linear(hidden, hidden, gen, init="lecun")
        self.out = linear(hidden, 1, gen, init="lecun")

    def forward(self, x, adj, amask):
        # x [K, A, F], adj [K, 4, A, A] (3 bond channels + virtual)
        h = torch.relu(self.lin0(x))
        for lin in self.msgs:
            msgs = [torch.einsum("kab,kbf->kaf", adj[:, c], h)
                    for c in range(3)]
            h = torch.relu(h + lin(torch.cat(msgs, dim=-1)))
            h = h * amask[..., None]
        pooled = h.sum(dim=1) / amask.sum(dim=1, keepdim=True).clamp_min(1.0)
        return self.out(torch.relu(self.pool(pooled)))[:, 0]      # [K]


def _scores(scorer, feats) -> np.ndarray:
    dev = next(scorer.parameters()).device
    return scorer(*(f.to(dev) for f in feats)).cpu().numpy()


def scorer_loss(scorer, x, adj, amask, label: int) -> torch.Tensor:
    """Cross-entropy of one junction's candidates against the true one."""
    return -F.log_softmax(scorer(x, adj, amask), dim=0)[label]


def build_assembly_fixtures(mols: Sequence[Mol], max_cands: int = MAX_CANDS
                            ) -> List[Dict]:
    """Training fixtures: for every junction of every molecule's tree,
    the enumerated candidates plus the index of the true attachment
    (matched by canonical hash against the real partial substructure)."""
    from .jtvae import _fragment, tree_decomp

    fixtures = []
    for mol in mols:
        try:
            tree = tree_decomp(mol)
        except Exception:
            continue
        if not tree.edges:
            continue
        # BFS over the tree from clique 0
        adj: Dict[int, List[int]] = {}
        for (i, j) in tree.edges:
            adj.setdefault(i, []).append(j)
            adj.setdefault(j, []).append(i)
        order = [0]
        seen = {0}
        qi = 0
        while qi < len(order):
            u = order[qi]
            qi += 1
            for v in adj.get(u, []):
                if v not in seen:
                    seen.add(v)
                    order.append(v)
        atoms_so_far = set(tree.cliques[order[0]])
        partial = _fragment(mol, sorted(atoms_so_far))
        for u in order[1:]:
            frag = _fragment(mol, tree.cliques[u])
            cands = enumerate_candidates(partial, frag, max_cands)
            new_atoms = atoms_so_far | set(tree.cliques[u])
            true_partial = _fragment(mol, sorted(new_atoms))
            th = canonical_hash(true_partial)
            label = next((k for k, c in enumerate(cands)
                          if canonical_hash(c) == th), None)
            if label is not None and len(cands) > 1:
                fixtures.append({"cands": cands, "label": label})
            atoms_so_far = new_atoms
            partial = true_partial
    return fixtures


def train_assembler(fixtures: Sequence[Dict], hidden: int = 64,
                    depth: int = 3, lr: float = 1e-3, epochs: int = 30,
                    seed: int = 0, verbose: bool = False,
                    device: DeviceLike = None):
    """Cross-entropy over candidates per junction (the reference's assm
    loss, ``jtnn_vae.py`` assm component), Adam. Returns the trained
    scorer."""
    dev = resolve_device(device)
    scorer = JTMPNScorer(hidden=hidden, depth=depth,
                         generator=torch.Generator().manual_seed(seed)).to(dev)
    feats = [tuple(t.to(dev) for t in featurize(f["cands"]))
             for f in fixtures]
    labels = [f["label"] for f in fixtures]
    opt = torch.optim.Adam(scorer.parameters(), lr)
    rng = np.random.default_rng(seed)
    for ep in range(epochs):
        order = rng.permutation(len(fixtures))
        losses = []
        for i in order:
            opt.zero_grad(set_to_none=True)
            loss = scorer_loss(scorer, *feats[i], labels[i])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if verbose:
            tot = float(torch.stack(losses).sum())
            print(f"assembler epoch {ep}: loss {tot / len(fixtures):.4f}")
    return scorer


@torch.no_grad()
def assembly_accuracy(scorer, fixtures: Sequence[Dict]) -> float:
    """Fraction of junctions where the scorer ranks the true candidate
    first (vs. 'greedy' = always candidate 0, the enumeration order the
    round-1 stitcher followed)."""
    hit = 0
    for f in fixtures:
        s = _scores(scorer, featurize(f["cands"]))
        hit += int(np.argmax(s) == f["label"])
    return hit / max(len(fixtures), 1)


def greedy_accuracy(fixtures: Sequence[Dict]) -> float:
    return sum(1 for f in fixtures if f["label"] == 0) / \
        max(len(fixtures), 1)


@torch.no_grad()
def assemble_scored(fragments: List[Mol], scorer=None) -> Optional[Mol]:
    """Sequential assembly: at each junction keep the best-scoring
    feasible merge (falls back to first-feasible when no scorer)."""
    if not fragments:
        return None
    mol = fragments[0].copy()
    for frag in fragments[1:]:
        cands = enumerate_candidates(mol, frag)
        if not cands:
            break
        if scorer is None or len(cands) == 1:
            mol = cands[0]
        else:
            s = _scores(scorer, featurize(cands))
            mol = cands[int(np.argmax(s))]
    return mol
