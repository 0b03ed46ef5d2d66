"""The one generator of molecule traffic, driven by ``traffic/<t>.json``.

A mix gives the pool's size (``pool`` batches, cycled through the
window) and each batch's molecules: a list of parts, each ``count``
molecules whose atom counts spread evenly over ``atoms = [lo, hi]``.
Every seed gets the same multiset of sizes in every batch, so every seed
does the same work; the seed decides their order, the elements (H, C, N,
O, F, uniformly), the positions (uniform in a cube of side ``box``
angstrom, no two atoms closer than ``min_dist`` angstrom: an atom of a
pair too close is drawn again until none is), the ``targets`` regression targets (standard normal) and,
with ``forces``, the target forces (standard normal, as ``bench.py``
draws them). The draws follow ``synthetic_molecules`` of the port's
datasets, which is not imported, but for ``min_dist``: bonded atoms of
real molecules lie 0.95 angstrom apart or more, and nearer pairs give
forces and second derivatives that no molecule has.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

Z_CHOICES = np.array([1, 6, 7, 8, 9])


def batch_sizes(parts) -> List[int]:
    """The atom counts of one batch, before the seed orders them."""
    sizes = []
    for part in parts:
        lo, hi = part["atoms"]
        span = hi - lo + 1
        sizes += [lo + i % span for i in range(part["count"])]
    return sizes


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % 2 ** 64)


def positions(gen: np.random.Generator, n: int, box: float,
              min_dist: float) -> np.ndarray:
    pos = gen.uniform(-box / 2, box / 2, size=(n, 3))
    while True:
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        close = np.triu(d < min_dist, 1).any(0)
        if not close.any():
            return pos.astype(np.float32)
        pos[close] = gen.uniform(-box / 2, box / 2, size=(int(close.sum()), 3))


def groups(traffic: dict, seed: int) -> List[List[Dict[str, np.ndarray]]]:
    """The pool's molecules, one list per batch, in the order the loader
    takes them."""
    spec = traffic["molecules"]
    gen = rng(seed)
    box, targets = spec["box"], spec["targets"]
    out = []
    for _ in range(traffic["pool"]):
        sizes = np.array(batch_sizes(spec["batch"]))
        gen.shuffle(sizes)
        mols = []
        for n in sizes:
            m = {"z": gen.choice(Z_CHOICES, size=int(n)).astype(np.int32),
                 "pos": positions(gen, int(n), box, spec["min_dist"]),
                 "y": gen.normal(size=(targets,)).astype(np.float32)}
            if spec["forces"]:
                m["force"] = gen.normal(size=(int(n), 3)).astype(np.float32)
            mols.append(m)
        out.append(mols)
    return out


def bucket_of(size: int, slots) -> int:
    """The smallest slot size that holds a molecule of ``size`` atoms, as
    the port's bucketed loaders place it."""
    return min(int(s) for s in slots if size <= int(s))
