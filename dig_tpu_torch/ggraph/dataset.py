"""Dense one-hot molecule datasets for generative models.

Parity with ``dig/ggraph/dataset/PygDataset.py:16-376`` +
``ggraph_dataset.py:9-185`` (QM9 / ZINC250k / ZINC800 / MOSES): CSV with a
SMILES column -> dense one-hot node tensor [max_size, node_dim] with BFS
atom ordering and bond tensor [4, max_size, max_size] (single/double/
triple/virtual channels), optional property column. SMILES parsing via the
dig_tpu chem kernel (RDKit-free).

When no CSV cache exists (zero-egress environment), use
:func:`synthetic_smiles_dataset` for smoke/training tests.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem import Mol, mol_from_smiles, mol_to_dense
from ..chem.mol import bfs_order

ATOM_LIST_QM9 = [6, 7, 8, 9]
ATOM_LIST_ZINC = [6, 7, 8, 9, 15, 16, 17, 35, 53]


class DenseMolDataset:
    """List of dense (x, adj[, y]) molecule tensors."""

    def __init__(self, smiles: Sequence[str], atom_list: Sequence[int],
                 max_size: int, props: Optional[Sequence[float]] = None,
                 skip_invalid: bool = True):
        self.atom_list = list(atom_list)
        self.max_size = max_size
        self.x = []
        self.adj = []
        self.y = []
        self.smiles = []
        for k, s in enumerate(smiles):
            try:
                mol = mol_from_smiles(s)
                if mol.num_atoms > max_size:
                    raise ValueError("too large")
                if any(a.z not in self.atom_list for a in mol.atoms):
                    raise ValueError("atom type outside atom_list")
                order = bfs_order(mol)
                x, adj = mol_to_dense(mol, self.atom_list, max_size, order)
            except Exception:
                if skip_invalid:
                    continue
                raise
            self.x.append(x)
            self.adj.append(adj)
            self.smiles.append(s)
            if props is not None:
                self.y.append(float(props[k]))

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        item = {"x": self.x[i], "adj": self.adj[i], "smiles": self.smiles[i]}
        if self.y:
            item["y"] = self.y[i]
        return item

    @classmethod
    def from_csv(cls, path: str, atom_list, max_size,
                 smiles_col: str = "smile", prop_col: Optional[str] = None,
                 limit: Optional[int] = None):
        smiles, props = [], []
        with open(path) as f:
            reader = csv.DictReader(f)
            for row in reader:
                smiles.append(row[smiles_col])
                if prop_col:
                    props.append(float(row[prop_col]))
                if limit and len(smiles) >= limit:
                    break
        return cls(smiles, atom_list, max_size,
                   props if prop_col else None)


def qm9_dense(root: str = "dataset/", prop_col: Optional[str] = None,
              limit: Optional[int] = None) -> DenseMolDataset:
    """QM9 for generation: max 9 heavy atoms, [C, N, O, F]
    (reference ggraph_dataset.py QM9: num_max_node=9, atom_list [6,7,8,9])."""
    for name in ("qm9_property.csv", "qm9.csv"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            return DenseMolDataset.from_csv(p, ATOM_LIST_QM9, 9,
                                            prop_col=prop_col, limit=limit)
    raise FileNotFoundError(
        f"no QM9 csv under {root}; use synthetic_smiles_dataset offline")


def zinc250k_dense(root: str = "dataset/", prop_col: Optional[str] = None,
                   limit: Optional[int] = None) -> DenseMolDataset:
    """ZINC250k: max 38 atoms, 9 atom types (reference ggraph_dataset.py)."""
    for name in ("zinc250k_property.csv", "zinc250k.csv"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            return DenseMolDataset.from_csv(p, ATOM_LIST_ZINC, 38,
                                            smiles_col="smile",
                                            prop_col=prop_col, limit=limit)
    raise FileNotFoundError(
        f"no ZINC250k csv under {root}; use synthetic_smiles_dataset")


_SYNTH_SMILES = [
    "CCO", "CCN", "CCC", "CC=O", "C1CC1", "C1CCC1", "C1CCCC1", "c1ccccc1",
    "CC(C)O", "CC(N)=O", "CCOC", "CC#N", "OCC(O)CO", "CNC", "CC(C)=O",
    "C1CCOC1", "c1ccncc1", "c1cc[nH]c1", "c1ccoc1", "CC(=O)OC",
    "NCC(=O)O", "CC(C)CO", "OCCO", "C=CC=C", "CC=CC", "N#CC#N",
    "CCCO", "CCCN", "OC1CCC1", "CC1CC1", "CN1CCC1", "O=C1CCC1",
    "FC(F)F", "CF", "CCF", "NC=O", "COC=O", "OC=O", "C#C", "C=C",
]


def synthetic_smiles_dataset(atom_list=ATOM_LIST_QM9, max_size: int = 9,
                             repeat: int = 4,
                             with_props: bool = False) -> DenseMolDataset:
    """Small fixed SMILES corpus for offline training tests."""
    smiles = _SYNTH_SMILES * repeat
    props = None
    if with_props:
        props = [float(len(s)) / 10.0 for s in smiles]
    return DenseMolDataset(smiles, atom_list, max_size, props)


class DenseMolLoader:
    """Minibatches of stacked dense tensors."""

    def __init__(self, dataset: DenseMolDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: Optional[bool] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last

    def __len__(self):
        n = len(self.ds)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = {
                "x": np.stack([self.ds.x[i] for i in idx]),
                "adj": np.stack([self.ds.adj[i] for i in idx]),
            }
            if self.ds.y:
                batch["y"] = np.array([self.ds.y[i] for i in idx],
                                      np.float32)
            yield batch
