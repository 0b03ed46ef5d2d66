"""MD17 molecular-dynamics trajectories: energies and forces per frame.
Port of ``dig_tpu/datasets/md17.py`` (host numpy, no download).

Reads the MD17 ``<name>_dft.npz`` format (``E``, ``F``, ``R``, ``z``) from a
local file under ``root``; raises ``FileNotFoundError`` when there is none.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .qm9 import get_idx_split


class MD17:
    """``data[i]`` -> ``{z, pos, y[1], force}`` of frame ``i``."""

    def __init__(self, root: str = "dataset/", name: str = "benzene_old"):
        path = next((p for p in (f"{root}/md17_{name}.npz",
                                 f"{root}/raw/md17_{name}.npz",
                                 f"{root}/{name}_dft.npz")
                     if os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"MD17 file for '{name}' not found under {root}; place the "
                "npz there")
        raw = np.load(path)
        self.E = raw["E"].astype(np.float32).reshape(-1)
        self.F = raw["F"].astype(np.float32)
        self.R = raw["R"].astype(np.float32)
        self.z = raw["z"].astype(np.int32)

    def __len__(self):
        return len(self.E)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {"z": self.z, "pos": self.R[i],
                "y": np.array([self.E[i]], np.float32),
                "force": self.F[i]}

    def get_idx_split(self, data_size: int, train_size: int, valid_size: int,
                      seed: int) -> Dict[str, np.ndarray]:
        return get_idx_split(data_size, train_size, valid_size, seed)
