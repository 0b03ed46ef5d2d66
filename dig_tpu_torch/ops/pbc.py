"""Periodic-boundary radius graphs for crystals (OC20-style workloads).
Port of ``dig_tpu/ops/pbc.py``.

Every ordered pair of one crystal is scored against a static set of
lattice-image offsets (``{-images..images}^3``) in one masked ``[N, N, M]``
distance tensor, so the shapes depend on nothing but the batch. Edges
carry their displacement vector, so the geometry downstream (local
frames, angles, forces through dE/dpos) treats periodic neighbours as
open-boundary ones. Products with the cell are written out elementwise in
float32 (no matmul: a TF32 matmul on the card would move pairs across the
cutoff).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def pbc_offsets(images: int = 1) -> np.ndarray:
    """Integer lattice offsets in ``{-images..images}^3``, the zero offset
    first (a stable sort by L1 norm), float32 ``[M, 3]``."""
    r = np.arange(-images, images + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    order = np.argsort(np.abs(offs).sum(1), kind="stable")
    return offs[order].astype(np.float32)


def _rowvec(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``v @ m`` over the last axis of ``v [..., 3]`` and ``m [..., 3, 3]``,
    as three products and two adds per output."""
    return (v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :]
            + v[..., 2:3] * m[..., 2, :])


def wrap_positions(pos: torch.Tensor, cell: torch.Tensor,
                   node_graph: torch.Tensor) -> torch.Tensor:
    """Positions wrapped into their unit cell (fractional [0, 1)). The
    floor is piecewise constant, so dE/dpos through the wrapped positions
    equals dE/dpos through the originals. A singular (padding) cell is
    taken as the identity."""
    cell_n = cell[node_graph.long()]                      # [N, 3, 3]
    a, b, c = cell_n[:, 0], cell_n[:, 1], cell_n[:, 2]
    det = torch.sum(a * torch.linalg.cross(b, c), dim=-1)
    singular = (torch.abs(det) <= 1e-8)[:, None]
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    a = torch.where(singular, eye[0], a)
    b = torch.where(singular, eye[1], b)
    c = torch.where(singular, eye[2], c)
    cbc = torch.linalg.cross(b, c)
    det = torch.sum(a * cbc, dim=-1)
    inv = torch.stack([cbc, torch.linalg.cross(c, a),
                       torch.linalg.cross(a, b)], dim=-1) / det[:, None, None]
    frac = _rowvec(pos, inv)
    frac = frac - torch.floor(frac)
    return _rowvec(frac, torch.stack([a, b, c], dim=1))


class PBCGraph(NamedTuple):
    senders: torch.Tensor    # [max_edges] j (source)
    receivers: torch.Tensor  # [max_edges] i (destination)
    edge_mask: torch.Tensor  # [max_edges]
    edge_vec: torch.Tensor   # [max_edges, 3] pos[j] + off @ cell - pos[i]
    edge_dist: torch.Tensor  # [max_edges]


def _pbc_adjacency(pos, cell, node_graph, node_mask, cutoff: float,
                   images: int):
    """``(disp [N, N, M, 3], adj [N, N, M])`` over the wrapped positions:
    ``disp[i, j, m] = pos[j] + offs[m] @ cell - pos[i]``, ``adj`` the
    in-cutoff pairs of one crystal without the true self-pair (zero image);
    a node's periodic copies stay."""
    pos = wrap_positions(pos, cell, node_graph)
    N = pos.shape[0]
    offs = torch.as_tensor(pbc_offsets(images), device=pos.device)
    M = offs.shape[0]
    cell_n = cell[node_graph.long()]                      # [N, 3, 3]
    shift = _rowvec(offs[None, :, :], cell_n[:, None])    # [N, M, 3]
    disp = (pos[None, :, None, :] + shift[None, :, :, :]
            - pos[:, None, None, :])                      # [N, N, M, 3]
    d2 = torch.sum(disp * disp, dim=-1)
    same = node_graph[:, None] == node_graph[None, :]
    valid = node_mask[:, None] & node_mask[None, :] & same
    adj = valid[:, :, None] & (d2 < cutoff * cutoff)
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    zero = torch.arange(M, device=pos.device) == 0
    return disp, adj & ~(eye[:, :, None] & zero[None, None, :])


def radius_graph_pbc_flat(pos: torch.Tensor, cell: torch.Tensor,
                          node_graph: torch.Tensor, node_mask: torch.Tensor,
                          cutoff: float, max_edges: int,
                          images: int = 1) -> PBCGraph:
    """Periodic radius graph of a flat padded batch of crystals (``cell
    [G, 3, 3]``, lattice vectors as rows): one edge j -> i per (i, j,
    image) whose displacement lies inside the cutoff, in (i, j, m) order
    (a stable sort of the flattened table, padding last), capped at
    ``max_edges`` (:func:`pbc_overflow` counts the dropped ones). Correct
    while ``images`` shells cover the cutoff. Padding edges hold node 0, a
    zero vector and distance 1."""
    disp, adj = _pbc_adjacency(pos, cell, node_graph, node_mask, cutoff,
                               images)
    N, _, M = adj.shape
    flat = adj.reshape(-1)
    order = torch.argsort((~flat).to(torch.uint8), stable=True)
    take = order[:max_edges]
    edge_mask = flat[take]
    i_idx = take // (N * M)
    j_idx = (take % (N * M)) // M
    receivers = torch.where(edge_mask, i_idx, 0).to(torch.int32)
    senders = torch.where(edge_mask, j_idx, 0).to(torch.int32)
    vec = torch.where(edge_mask[:, None], disp.reshape(N * N * M, 3)[take],
                      0.0)
    dist = torch.sqrt(torch.clamp(torch.sum(vec * vec, -1), min=1e-12))
    dist = torch.where(edge_mask, dist, 1.0)
    return PBCGraph(senders=senders, receivers=receivers,
                    edge_mask=edge_mask, edge_vec=vec, edge_dist=dist)


def pbc_overflow(pos: torch.Tensor, cell: torch.Tensor,
                 node_graph: torch.Tensor, node_mask: torch.Tensor,
                 cutoff: float, max_edges: int,
                 images: int = 1) -> torch.Tensor:
    """Edges the ``max_edges`` cap of :func:`radius_graph_pbc_flat`
    drops."""
    _, adj = _pbc_adjacency(pos, cell, node_graph, node_mask, cutoff, images)
    return torch.clamp(torch.sum(adj) - max_edges, min=0)
