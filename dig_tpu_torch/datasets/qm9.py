"""QM9-3D: molecules with 3D coordinates and 12 regression targets. Port of
``dig_tpu/datasets/qm9.py`` (host numpy, no download).

Reads the DimeNet-format ``qm9_eV.npz`` (``R`` flat positions, ``Z`` flat
atomic numbers, ``N`` atoms per molecule, the 12 target columns) from a
local file under ``root``; raises ``FileNotFoundError`` when there is none.
The split is ``np.random.RandomState(seed).permutation(n)`` sliced into
train / valid / rest, as the reference's.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

TARGETS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
           "U0", "U", "H", "G", "Cv"]

_SEARCH_PATHS = [
    "{root}/qm9_eV.npz",
    "{root}/raw/qm9_eV.npz",
    "{root}/qm9/raw/qm9_eV.npz",
]


def get_idx_split(data_size: int, train_size: int, valid_size: int,
                  seed: int) -> Dict[str, np.ndarray]:
    """``{"train", "valid", "test"}`` index arrays:
    ``RandomState(seed).permutation(data_size)`` sliced train, valid, rest."""
    ids = np.random.RandomState(seed).permutation(data_size)
    return {"train": ids[:train_size],
            "valid": ids[train_size:train_size + valid_size],
            "test": ids[train_size + valid_size:]}


class QM93D:
    """In-memory QM9-3D. ``data[i]`` -> ``{z, pos, y[12]}``."""

    def __init__(self, root: str = "dataset/"):
        self.root = root
        path = next((p for p in (pat.format(root=root)
                                 for pat in _SEARCH_PATHS)
                     if os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"qm9_eV.npz not found under {root}; place the DimeNet "
                "qm9_eV.npz there or use synthetic_molecules()")
        raw = np.load(path)
        self.N = raw["N"].astype(np.int64)
        split = np.cumsum(self.N)[:-1]
        self.R = np.split(raw["R"].astype(np.float32), split)
        self.Z = np.split(raw["Z"].astype(np.int32), split)
        self.y = np.stack([raw[t].astype(np.float32) for t in TARGETS],
                          axis=1)

    def __len__(self) -> int:
        return len(self.N)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {"z": self.Z[i], "pos": self.R[i], "y": self.y[i]}

    def get_idx_split(self, data_size: int, train_size: int, valid_size: int,
                      seed: int) -> Dict[str, np.ndarray]:
        return get_idx_split(data_size, train_size, valid_size, seed)

    def select(self, idx) -> List[Dict[str, np.ndarray]]:
        return [self[int(i)] for i in idx]
