"""Weak-scaling measurement for the graph-parallel path. Port of
``dig_tpu/parallel/scaling.py``.

The scaling argument is made from its two measurable preconditions:

1. **Constant per-rank communication volume.** At fixed per-rank graph
   size, the halo rows each rank exchanges per step must not grow with
   the number of parts P.
2. **P-independent collective count.** One all-to-all per halo exchange
   (not P point-to-point sends), so the step's collective *count* is a
   property of the model depth, not of the group size.

Both are measured by :func:`measure_gp_scaling` on a ring-lattice graph
(every node linked to its k nearest neighbours per side), whose optimal
partition has an exactly constant boundary of k rows per cut.

Deliberate deviation: the JAX package counts the collectives of the
lowered program by parsing its HLO text (:func:`count_collectives`, kept
here for such text). The port counts the collectives one train step
issues through its own wrappers (:data:`~dig_tpu_torch.parallel.comm.
counts`, forward and backward), on every rank of a P-rank group.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np

from . import comm
from .gp import make_gp_train_step, prepare_gp_graph, slab_layout


def ring_lattice(n: int, k: int):
    """Directed ring lattice: each node sends to its k nearest neighbours
    on each side. Returns (senders, receivers), each [n * 2k]."""
    offs = np.concatenate([np.arange(1, k + 1), -np.arange(1, k + 1)])
    senders = np.repeat(np.arange(n), 2 * k)
    receivers = (senders.reshape(n, 2 * k) + offs[None, :]).ravel() % n
    return senders.astype(np.int64), receivers.astype(np.int64)


def count_collectives(hlo_text: str) -> Dict[str, int]:
    """Count collective *ops* in HLO/StableHLO text (``stablehlo.all_to_all``,
    or ``all-to-all`` / async ``all-to-all-start`` pairs counted once)."""
    counts = {}
    for name in ("all-to-all", "all-reduce", "collective-permute",
                 "all-gather", "reduce-scatter"):
        us = name.replace("-", "_")
        stable = len(re.findall(rf"stablehlo\.{us}", hlo_text))
        starts = len(re.findall(rf"{name}-start", hlo_text))
        plain = len(re.findall(
            rf"{name}(?!-start|-done)[.(\s]", hlo_text))
        counts[us] = stable if stable else (starts if starts else plain)
    return counts


def measure_gp_scaling(P: int, n_local: int = 256, k: int = 4,
                       in_dim: int = 32, hidden: int = 16,
                       num_classes: int = 4, compile_step: bool = True,
                       mesh=None) -> Dict:
    """Weak-scaling probe at P parts with ``n_local`` nodes a rank.

    Returns per-rank halo-exchange volume (real rows and padded-buffer
    rows, bytes at fp32 x ``hidden``) and, with ``compile_step``, the
    collectives of one partitioned-GCN train step by kind
    (``collectives``), counted on this rank. ``compile_step`` needs a
    1-D mesh of P ranks (its one dimension holds the parts); every rank
    of it calls this function."""
    N = P * n_local
    senders, receivers = ring_lattice(N, k)
    g, perm, H, C = prepare_gp_graph(senders, receivers, N, P)

    send_mask = np.asarray(g.send_mask)          # [P, P, K]
    send_rows = send_mask.sum(axis=(1, 2))       # real rows sent per rank
    halo_rows = send_mask.sum(axis=(0, 2))       # rows received per rank

    out = {
        "P": P, "n_local": n_local, "k": k,
        "nodes_per_part": int(C),
        "halo_pad_rows": int(H),                 # padded halo buffer
        "send_rows_max": int(send_rows.max()),
        "send_rows_mean": float(send_rows.mean()),
        "recv_rows_max": int(halo_rows.max()),
        "halo_bytes_per_device": int(send_rows.max()) * hidden * 4,
        "edges_per_device": int(np.asarray(g.edge_mask).sum(1).max()),
    }

    if compile_step:
        if mesh is None or mesh.size() != P or mesh.ndim != 1:
            raise RuntimeError(f"need a 1-D mesh of {P} ranks")
        init_fn, step, _ = make_gp_train_step(
            mesh, num_layers=2, hidden=hidden, num_classes=num_classes,
            in_dim=in_dim, halo_size=H, nodes_per_part=C,
            axis=mesh.mesh_dim_names[0])
        rng = np.random.RandomState(0)
        x = rng.randn(N, in_dim).astype(np.float32)
        y = rng.randint(0, num_classes, N)
        m = np.ones(N, bool)
        xs = slab_layout(x, perm, P, C)
        ys = slab_layout(y, perm, P, C)
        ms = slab_layout(m, perm, P, C)
        init_fn(xs, g)
        step(g, xs, ys, ms)            # plans built, nothing counted yet
        comm.reset_counts()
        step(g, xs, ys, ms)
        out["collectives"] = {kind: int(comm.counts.get(kind, 0)) for kind
                              in ("all_to_all", "all_reduce", "ppermute",
                                  "all_gather")}
    return out
