"""Protein datasets for ProNet: EC / FOLD. Port of
``dig_tpu/datasets/proteins.py`` (host numpy, copied; batches through the
port's ``graph.batch_np``, so they are the JAX loader's arrays bit for
bit, on ``device``).

Enzyme-commission and fold classification: C-alpha / N / C backbone
coordinates, backbone dihedral and side-chain torsion embeddings. Real data
loads from a local npz file (``FileNotFoundError`` when there is none);
:func:`synthetic_proteins` makes batch-ready random backbones.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..device import DeviceLike
from ..graph import batch_np


def load_protein_npz(root: str, name: str) -> List[Dict]:
    """{root}/{name}.npz with object arrays per protein: z, pos (C-alpha),
    pos_n, pos_c, bb_embs, side_chain_embs, y."""
    path = os.path.join(root, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing; place the processed npz there or use "
            "synthetic_proteins")
    raw = np.load(path, allow_pickle=True)
    n = len(raw["y"])
    return [{k: raw[k][i] for k in raw.files} for i in range(n)]


def ECdataset(root: str = "dataset/", split: str = "train") -> List[Dict]:
    return load_protein_npz(root, f"ec_{split}")


def FOLDdataset(root: str = "dataset/", split: str = "training") -> List[Dict]:
    return load_protein_npz(root, f"fold_{split}")


def compute_dihedrals(v1: np.ndarray, v2: np.ndarray,
                      v3: np.ndarray) -> np.ndarray:
    """Torsion angle of three consecutive bond vectors (ECdataset.py:151-157:
    atan2 of the binormal projection over the plane-normal dot), NaN-safe —
    missing side-chain atoms propagate NaN vectors and land on 0 exactly as
    the reference's ``nan_to_num``."""
    n1 = np.cross(v1, v2)
    n2 = np.cross(v2, v3)
    a = np.sum(n1 * n2, axis=-1)
    norm = np.linalg.norm(v2, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        b = np.sum(np.cross(n1, n2) * v2, axis=-1) / norm
    return np.nan_to_num(np.arctan2(np.nan_to_num(b), np.nan_to_num(a)))


def bb_embs(X: np.ndarray) -> np.ndarray:
    """Backbone dihedral embedding [n_res, 6] from X [n_res, 3, 3]
    (N/CA/C coords per residue): the (phi, psi, omega) chain dihedrals as
    (cos, sin) pairs, phi[0]/psi[-1]/omega[-1] zero-padded
    (ECdataset.py:126-147)."""
    n = X.shape[0]
    flat = X.reshape(3 * n, 3)
    dX = flat[1:] - flat[:-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        U = dX / np.linalg.norm(dX, axis=-1, keepdims=True)
    U = np.nan_to_num(U)
    angle = compute_dihedrals(U[:-2], U[1:-1], U[2:])
    angle = np.pad(angle, (1, 2))
    angle = angle.reshape(n, 3)
    return np.concatenate([np.cos(angle), np.sin(angle)],
                          axis=1).astype(np.float32)


def side_chain_embs(pos_n, pos_ca, pos_c, pos_cb, pos_g, pos_d, pos_e,
                    pos_z, pos_h) -> np.ndarray:
    """Side-chain embedding [n_res, 8]: the first four chi torsions along
    N-CA-CB-G-D-E-Z(-H) as (sin, cos) pairs; residues missing atoms get 0
    via the NaN chain (ECdataset.py:109-123)."""
    vs = [pos_ca - pos_n, pos_cb - pos_ca, pos_g - pos_cb, pos_d - pos_g,
          pos_e - pos_d, pos_z - pos_e, pos_h - pos_z]
    angles = np.stack([compute_dihedrals(vs[k], vs[k + 1], vs[k + 2])
                       for k in range(4)], axis=1)
    return np.concatenate([np.sin(angles), np.cos(angles)],
                          axis=1).astype(np.float32)


def synthetic_proteins(num: int = 16, min_res: int = 8, max_res: int = 24,
                       num_classes: int = 4, seed: int = 0) -> List[Dict]:
    """Random self-avoiding-ish backbones with class-correlated geometry.

    bb_embs / side_chain_embs are COMPUTED from the synthetic coordinates
    with the real pipeline above (not sampled), so models exercise the
    same coordinate->embedding path real EC/FOLD data takes."""
    rng = np.random.default_rng(seed)
    prots = []
    for _ in range(num):
        n = int(rng.integers(min_res, max_res + 1))
        cls = int(rng.integers(num_classes))
        # class controls local curliness of the backbone walk
        step = 3.8
        turn = 0.3 + 0.4 * cls / max(num_classes - 1, 1)
        pos = [np.zeros(3)]
        d = np.array([1.0, 0.0, 0.0])
        for _ in range(n - 1):
            d = d + turn * rng.normal(size=3)
            d = d / np.linalg.norm(d)
            pos.append(pos[-1] + step * d)
        pos = np.asarray(pos, np.float32)
        pos_n = pos + rng.normal(0, 0.4, (n, 3)).astype(np.float32)
        pos_c = pos + rng.normal(0, 0.4, (n, 3)).astype(np.float32)
        # plausible side-chain atoms walking out from CB; drop tail atoms
        # for ~half the residues to exercise the NaN-missing-atom path
        chain = [pos + rng.normal(0, 0.6, (n, 3)).astype(np.float32)]
        for _ in range(5):
            chain.append(chain[-1]
                         + rng.normal(0, 0.8, (n, 3)).astype(np.float32))
        for arr in chain[2:]:
            arr[rng.random(n) < 0.15] = np.nan
        prots.append({
            "z": rng.integers(0, 20, n).astype(np.int32),
            "pos": pos,
            "pos_n": pos_n,
            "pos_c": pos_c,
            "bb_embs": bb_embs(np.stack([pos_n, pos, pos_c], axis=1)),
            "side_chain_embs": side_chain_embs(pos_n, pos, pos_c, *chain),
            "y": cls,
        })
    return prots


class ProteinLoader:
    """Batches protein dicts into GraphBatches for ProNet, on ``device``
    (default: the CUDA card)."""

    def __init__(self, proteins, batch_size: int,
                 n_node_pad: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 slot_size: Optional[int] = None,
                 device: DeviceLike = None):
        self.data = list(proteins)
        self.device = device
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last
        self.slot_size = slot_size
        if slot_size is not None:
            if (n_node_pad is not None
                    and n_node_pad != batch_size * slot_size):
                raise ValueError(
                    f"n_node_pad={n_node_pad} conflicts with slot_size="
                    f"{slot_size}")
            n_node_pad = batch_size * slot_size
        elif n_node_pad is None:
            max_res = max(len(p["z"]) for p in self.data)
            n_node_pad = batch_size * max_res
        self.n_node_pad = n_node_pad

    def __len__(self):
        n = len(self.data)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        order = np.arange(len(self.data))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            graphs = []
            for i in idx:
                p = self.data[i]
                graphs.append({
                    "nodes": {k: p[k] for k in
                              ("z", "pos", "pos_n", "pos_c", "bb_embs",
                               "side_chain_embs")},
                    "senders": np.zeros(0, np.int32),
                    "receivers": np.zeros(0, np.int32),
                    "globals": {"y": np.atleast_1d(
                        np.asarray(p["y"], np.float32))},
                })
            yield batch_np(graphs, self.n_node_pad, 1,
                           num_graphs=self.batch_size,
                           slot_size=self.slot_size, device=self.device)
