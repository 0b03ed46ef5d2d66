"""ProNet: complete 3D graph networks for protein representations. Port of
``dig_tpu/models/pronet.py``.

Amino-acid, backbone and all-atom levels over a radius graph of the
C-alpha coordinates: the geometry (d, theta, phi) from the sequential
reference residues, then the rotation-invariant tau (``aminoacid``) or the
backbone frames' Euler angles (``backbone``, ``allatom``), a
sequence-offset positional embedding and three ``EdgeGraphConv`` streams a
block. Node fields: ``z`` (residue type), ``pos`` (C-alpha), and for the
backbone and all-atom levels ``pos_n``, ``pos_c``, ``bb_embs`` and
``side_chain_embs`` (``datasets.ProteinLoader`` batches).

Layouts, as in the JAX model: flat (``radius_graph_flat`` with
``max_num_neighbors``; edge values through ``gather_rows``, the
edge->node sums through the sorted-CSR kernel) and NK (``nk_degree``,
with ``block_size`` per slot of a slot-aligned batch; receiver values as
broadcasts, sender values through one ``nk_gather`` of a packed per-node
table, reshape-sum aggregation). The readout is ``readout_sum``. Vectors
are componentwise ``(x, y, z)`` tuples of ``[E]`` tensors, as in the JAX
model, so both round alike.

Training noise: ``dropout``, ``euler_noise`` (clipped N(0, 0.025) on the
three Euler angles) and ``data_augment_eachlayer`` (the same on the node
features before each block) act only with ``deterministic=False``, and draw
from the ``generator`` the caller passes to ``forward`` (``None``: torch's
default generator) in the JAX model's order: the Euler noise, then per
block the feature noise and the block's three dropout masks, then the
readout's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..nn.blocks import dense, swish
from ..ops.basis import bessel_table, sph_full_table, sph_m0_table
from ..ops.radius import (radius_graph_flat, radius_graph_nk,
                          radius_graph_nk_blocked)
from ..ops.segment import gather_rows, readout_sum
from ..ops.triplets import nk_gather
from .comenet import EdgeGraphConv, TwoLayerLinear, safe_atan2
from .schnet_dense import _linear

NUM_AA_TYPE = 26
NUM_BB_EMBS = 6
NUM_SIDE_CHAIN_EMBS = 8


def _standard_normal(shape, generator, device) -> torch.Tensor:
    """N(0, 1) draws of the training noise."""
    return torch.randn(shape, generator=generator, device=device)


def _keep_mask(keep: float, shape, generator, device) -> torch.Tensor:
    """Bernoulli(``keep``) draws of a dropout mask."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _clipped_noise(shape, generator, device) -> torch.Tensor:
    return torch.clamp(0.025 * _standard_normal(shape, generator, device),
                       -0.1, 0.1)


def _dropout(x, rate: float, deterministic: bool, generator):
    """flax ``Dropout``: kept rows scaled by 1 / (1 - rate)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = _keep_mask(keep, x.shape, generator, x.device)
    return torch.where(m, x / keep, 0.0)


def _col3(t, o):
    return t[:, o], t[:, o + 1], t[:, o + 2]


def _sub3(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _norm3(a):
    return torch.sqrt(torch.clamp(_dot3(a, a), min=1e-12))


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


class ProNetInteraction(nn.Module):
    """One ProNet block (the reference's ``pronet.py:150-254``): three conv
    streams (dropout after each), an MLP over their concatenation, a skip
    from the input, a second MLP and a last linear."""

    def __init__(self, hidden: int, mid_emb: int, f0_dim: int, f1_dim: int,
                 pos_dim: int, num_layers: int = 3, dropout: float = 0.0,
                 dtype=None, gen=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        T = lambda i: TwoLayerLinear(i, mid_emb, hidden, True, dtype, gen)
        L = lambda i: _linear(i, hidden, True, gen)
        self.tlls = nn.ModuleList([T(f0_dim), T(f1_dim), T(pos_dim)])
        self.lin_h = L(hidden)
        self.convs = nn.ModuleList(EdgeGraphConv(hidden, dtype, gen)
                                   for _ in range(3))
        self.lin_convs = nn.ModuleList(L(hidden) for _ in range(3))
        self.lins_cat = nn.ModuleList(L(3 * hidden if li == 0 else hidden)
                                      for li in range(num_layers))
        self.lin_skip = L(hidden)
        self.lins_after = nn.ModuleList(L(hidden)
                                        for _ in range(num_layers - 1))
        self.lin_out = L(hidden)

    def flax_denses(self):
        """Linears in the order flax numbers the block's Dense_i."""
        return [self.lin_h, *self.lin_convs, *self.lins_cat, self.lin_skip,
                *self.lins_after, self.lin_out]

    def forward(self, x, feature0, feature1, pos_emb, senders, receivers,
                edge_mask, g: GraphBatch, deterministic: bool = True,
                nkg=None, generator=None):
        dt, N = self.dtype, g.num_nodes
        fs = [tll(f) for tll, f in zip(self.tlls,
                                       (feature0, feature1, pos_emb))]
        h = swish(dense(x, self.lin_h, dt))
        hs = [_dropout(swish(dense(conv(h, senders, receivers, edge_mask, f,
                                        N, nkg), lin, dt)),
                       self.dropout, deterministic, generator)
              for conv, lin, f in zip(self.convs, self.lin_convs, fs)]
        out = torch.cat(hs, dim=-1)
        for lin in self.lins_cat:
            out = swish(dense(out, lin, dt))
        out = out + swish(dense(x, self.lin_skip, dt))
        for lin in self.lins_after:
            out = swish(dense(out, lin, dt))
        return dense(out, self.lin_out, dt)


class ProNet(nn.Module):
    """Defaults as the JAX model's (the reference's ``pronet.py:278-296``).
    ``generator`` seeds the initial weights, ``device`` (default: the CUDA
    card) holds them."""

    def __init__(self, level: str = "aminoacid", num_blocks: int = 4,
                 hidden_channels: int = 128, out_channels: int = 1,
                 mid_emb: int = 64, num_radial: int = 6,
                 num_spherical: int = 2, cutoff: float = 10.0,
                 max_num_neighbors: int = 32, int_emb_layers: int = 3,
                 out_layers: int = 2, num_pos_emb: int = 16,
                 max_edges: int = 8192, dropout: float = 0.0,
                 nk_degree: int = 0, block_size: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 data_augment_eachlayer: bool = False,
                 euler_noise: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if level not in ("aminoacid", "backbone", "allatom"):
            raise ValueError(f"level must be aminoacid, backbone or allatom, "
                             f"got {level!r}")
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None, float32 or "
                             f"bfloat16, got {compute_dtype}")
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.level = level
        self.num_radial, self.num_spherical = num_radial, num_spherical
        self.cutoff, self.max_num_neighbors = cutoff, max_num_neighbors
        self.num_pos_emb, self.max_edges = num_pos_emb, max_edges
        self.dropout = dropout
        self.nk_degree, self.block_size = nk_degree, block_size
        self.data_augment_eachlayer = data_augment_eachlayer
        self.euler_noise = euler_noise
        dt = None if compute_dtype == torch.float32 else compute_dtype
        self.dtype = dt
        H, n, k = hidden_channels, num_spherical, num_radial
        if level == "aminoacid":
            self.embed = nn.Embedding(NUM_AA_TYPE, H)
            with torch.no_grad():   # flax Embed: variance 1 / fan-in
                self.embed.weight.normal_(0.0, 1.0 / math.sqrt(H),
                                          generator=gen)
        else:
            d_in = NUM_AA_TYPE + NUM_BB_EMBS + (
                NUM_SIDE_CHAIN_EMBS if level == "allatom" else 0)
            self.lin_in = _linear(d_in, H, True, gen)
        f1_dim = n * k if level == "aminoacid" else 3 * n * k
        self.blocks = nn.ModuleList(
            ProNetInteraction(H, mid_emb, n * n * k, f1_dim, num_pos_emb,
                              int_emb_layers, dropout, dt, gen)
            for _ in range(num_blocks))
        self.lins_out = nn.ModuleList(_linear(H, H, True, gen)
                                      for _ in range(out_layers - 1))
        self.lin_out = _linear(H, out_channels, True, gen)
        self.to(device)

    def flax_denses(self):
        """The top level's linears in flax's Dense_i order."""
        first = [] if self.level == "aminoacid" else [self.lin_in]
        return [*first, *self.lins_out, self.lin_out]

    def _graph(self, pos, g: GraphBatch):
        """``(senders, receivers, edge_mask, nkg, at_node, at_nbr)``:
        ``at_node(t)`` / ``at_nbr(t)`` take a per-node table ``[N, C]`` to
        the edges' receiver / sender rows ``[E, C]``."""
        N = g.num_nodes
        if self.nk_degree > 0:
            K = self.nk_degree
            if self.block_size > 0:
                nkg = radius_graph_nk_blocked(pos, g.node_mask, self.cutoff,
                                              K, self.block_size,
                                              node_graph=g.node_graph)
            else:
                nkg = radius_graph_nk(pos, g.node_graph, g.node_mask,
                                      self.cutoff, K)
            return (nkg.senders, nkg.receivers, nkg.edge_mask, nkg,
                    lambda t: t[:, None, :].expand(N, K, t.shape[-1])
                    .reshape(N * K, -1),
                    lambda t: nk_gather(t, nkg.nbr_idx, nkg.rev_edge,
                                        nkg.nbr_mask))
        s, r, m = radius_graph_flat(pos, g.node_graph, g.node_mask,
                                    self.cutoff, self.max_edges,
                                    max_num_neighbors=self.max_num_neighbors)
        return (s, r, m, None, lambda t: gather_rows(t, r),
                lambda t: gather_rows(t, s))

    def forward(self, g: GraphBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Outputs ``[G, out_channels]`` of a batch."""
        z, pos = g.nodes["z"], g.nodes["pos"]
        N, dev = g.num_nodes, pos.device
        train = not deterministic
        if self.level == "aminoacid":
            x = gather_rows(self.embed.weight, z)
        else:
            feats = [F.one_hot(z.long(), NUM_AA_TYPE).float(),
                     g.nodes["bb_embs"]]
            if self.level == "allatom":
                feats.append(g.nodes["side_chain_embs"])
            x = self.lin_in(torch.cat(feats, dim=-1))
        nm = g.node_mask[:, None]
        x = torch.where(nm, x, 0.0)
        senders, receivers, edge_mask, nkg, at_node, at_nbr = self._graph(
            pos, g)
        j, i = senders, receivers
        E = senders.shape[0]

        # the sequence-offset positional embedding
        offset = (i - j).float()
        freqs = torch.exp(torch.arange(0, self.num_pos_emb, 2,
                                       dtype=torch.float32, device=dev)
                          * -(math.log(10000.0) / self.num_pos_emb))
        ang = offset[:, None] * freqs[None, :]
        pos_emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)

        # theta and phi from the sequential reference residues: per-node
        # tables packed into one [N, 9 | 15] table, one gather a side
        cols = [pos, torch.roll(pos, 1, 0) - pos, torch.roll(pos, -1, 0) - pos]
        if self.level != "aminoacid":
            o1x_n = g.nodes["pos_n"] - pos
            cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
            cols += [o1x_n, cross(o1x_n, cross(o1x_n, g.nodes["pos_c"] - pos))]
        tab = torch.cat(cols, dim=1)
        gn, ge = at_node(tab), at_nbr(tab)
        v_ji = _sub3(_col3(ge, 0), _col3(gn, 0))
        dist = torch.where(edge_mask, _norm3(v_ji), 1.0)
        v_ref0, v_b1 = _col3(gn, 3), _col3(gn, 6)
        theta = safe_atan2(_norm3(_cross3(v_ji, v_ref0)), _dot3(v_ji, v_ref0))
        plane1 = _cross3(v_ref0, v_b1)
        plane2 = _cross3(v_ref0, v_ji)
        phi = safe_atan2(_dot3(_cross3(plane1, plane2), v_ref0)
                         / torch.clamp(_norm3(v_ref0), min=1e-9),
                         _dot3(plane1, plane2))

        n, k = self.num_spherical, self.num_radial
        rbf = bessel_table(n, k, dist / self.cutoff)
        cbf = sph_full_table(n, theta, phi).reshape(-1, n, n)
        em = edge_mask[:, None]
        feature0 = torch.where(em, (cbf[:, :, :, None] * rbf[:, None, :, :])
                               .reshape(E, n * n * k), 0.0)

        def d_angle(angle):
            return (rbf * sph_m0_table(n, angle)[:, :, None]).reshape(E,
                                                                     n * k)

        if self.level == "aminoacid":
            # tau between the sequential planes; the reference residue
            # (i-1 or i+1, j-1 or j+1) avoids the edge's partner
            v_refi = _where3(((i - 1) % N) == j, v_b1, v_ref0)
            v_refj = _where3(((j - 1) % N) == i, _col3(ge, 6), _col3(ge, 3))
            p1, p2 = _cross3(v_ji, v_refi), _cross3(v_ji, v_refj)
            tau = safe_atan2(_dot3(_cross3(p1, p2), v_ji)
                             / torch.clamp(dist, min=1e-9), _dot3(p1, p2))
            feature1 = d_angle(tau)
        else:
            # the backbone frames' Euler angles (columns 9..14)
            o1x, o1z = _col3(gn, 9), _col3(gn, 12)
            o2x, o2z = _col3(ge, 9), _col3(ge, 12)
            o1zl, o2zl = _norm3(o1z) + 1e-7, _norm3(o2z) + 1e-7
            nvec = _cross3(o1z, o2z)
            angles = [
                safe_atan2(_dot3(_cross3(o1x, nvec), o1z) / o1zl,
                           _dot3(o1x, nvec)),
                safe_atan2(_norm3(_cross3(o1z, o2z)), _dot3(o1z, o2z)),
                safe_atan2(_dot3(_cross3(nvec, o2x), o2z) / o2zl,
                           _dot3(nvec, o2x))]
            if self.euler_noise and train:
                noise = _clipped_noise((3, E), generator, dev)
                angles = [a + noise[c] for c, a in enumerate(angles)]
            feature1 = torch.cat([d_angle(a) for a in angles], dim=-1)
        feature1 = torch.where(em, feature1, 0.0)

        for blk in self.blocks:
            if self.data_augment_eachlayer and train:
                x = x + _clipped_noise(tuple(x.shape), generator, dev)
            x = blk(x, feature0, feature1, pos_emb, senders, receivers,
                    edge_mask, g, deterministic, nkg, generator)
            x = torch.where(nm, x.float(), 0.0)

        y = readout_sum(x, g.node_graph, g.num_graphs, g.node_mask)
        for lin in self.lins_out:
            y = _dropout(F.relu(lin(y)), self.dropout, deterministic,
                         generator)
        return self.lin_out(y)
