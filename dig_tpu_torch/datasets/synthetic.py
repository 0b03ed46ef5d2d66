"""Synthetic molecular data for tests and on-card runs (host numpy; a copy of
``dig_tpu/datasets/synthetic.py`` so the port needs no JAX package)."""
from __future__ import annotations

import numpy as np


def synthetic_molecules(num: int, seed: int = 0, min_atoms: int = 4,
                        max_atoms: int = 29, num_targets: int = 12,
                        with_forces: bool = False, box: float = 4.0):
    """Random QM9-shaped molecules: uniform positions in a box (rescaled so
    radius graphs at cutoff 5.0 are non-trivial), light-element Z."""
    rng = np.random.default_rng(seed)
    Z_CHOICES = np.array([1, 6, 7, 8, 9])  # H C N O F
    mols = []
    for _ in range(num):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        z = rng.choice(Z_CHOICES, size=n)
        pos = rng.uniform(-box / 2, box / 2, size=(n, 3)).astype(np.float32)
        y = rng.normal(size=(num_targets,)).astype(np.float32)
        mol = {"z": z.astype(np.int32), "pos": pos, "y": y}
        if with_forces:
            mol["force"] = rng.normal(size=(n, 3)).astype(np.float32)
        mols.append(mol)
    return mols


def morse_energy(z, pos, D: float = 0.5, a: float = 1.5, r0: float = 1.5,
                 cutoff: float = 5.0):
    """Analytic Morse pair-potential energy and forces for a molecule.

    Species-dependent well depth D_ij = D * sqrt(z_i z_j) / 6 makes the
    labels z-sensitive: a learnable physical target for synthetic molecules.
    """
    pos = np.asarray(pos, np.float64)
    z = np.asarray(z, np.float64)
    diff = pos[:, None] - pos[None, :]
    r = np.sqrt((diff ** 2).sum(-1) + 1e-12)
    np.fill_diagonal(r, np.inf)
    Dij = D * np.sqrt(np.outer(z, z)) / 6.0
    mask = r < cutoff
    x = np.exp(-a * (r - r0))
    e_pair = Dij * ((1.0 - x) ** 2 - 1.0) * mask
    energy = 0.5 * e_pair.sum()
    # dE/dr = Dij * 2(1-x) * a x ; force_i = -sum_j dE/dr * (p_i-p_j)/r
    dedr = Dij * 2.0 * (1.0 - x) * a * x * mask
    fvec = -(dedr / r)[:, :, None] * diff
    forces = fvec.sum(axis=1)
    return np.float32(energy), forces.astype(np.float32)


def synthetic_morse_molecules(num: int, seed: int = 0, min_atoms: int = 4,
                              max_atoms: int = 29, box: float = 6.0,
                              cutoff: float = 5.0):
    """QM9-shaped molecules with Morse-potential energy/forces as targets."""
    rng = np.random.default_rng(seed)
    Z_CHOICES = np.array([1, 6, 7, 8, 9])
    mols = []
    for _ in range(num):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        z = rng.choice(Z_CHOICES, size=n).astype(np.int32)
        pos = rng.uniform(-box / 2, box / 2, size=(n, 3)).astype(np.float32)
        e, f = morse_energy(z, pos, cutoff=cutoff)
        mols.append({"z": z, "pos": pos, "y": np.full((12,), e, np.float32),
                     "force": f})
    return mols


def synthetic_crystals(num: int, seed: int = 0, min_atoms: int = 4,
                       max_atoms: int = 12, a_min: float = 9.0,
                       a_max: float = 12.0):
    """Random periodic structures for the periodic (OCP-style) path:
    near-cubic cells with jittered lattice vectors (``cell`` rows), atoms
    at uniform fractional coordinates, the Morse energy over the
    open-boundary atoms as a stand-in target."""
    rng = np.random.default_rng(seed)
    Z_CHOICES = np.array([1, 6, 8, 13, 14, 26, 29])  # H C O Al Si Fe Cu
    mols = []
    for _ in range(num):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        lengths = rng.uniform(a_min, a_max, size=3)
        cell = np.diag(lengths) + rng.normal(scale=0.3, size=(3, 3))
        frac = rng.uniform(0.0, 1.0, size=(n, 3))
        pos = (frac @ cell).astype(np.float32)
        z = rng.choice(Z_CHOICES, size=n).astype(np.int32)
        e, _ = morse_energy(z, pos)
        mols.append({"z": z, "pos": pos,
                     "cell": cell.astype(np.float32),
                     "y": np.atleast_1d(e).astype(np.float32)})
    return mols
