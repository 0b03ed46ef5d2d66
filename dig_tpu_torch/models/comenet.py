"""ComENet: complete and efficient message passing with rotation-invariant
local frames. Port of ``dig_tpu/models/comenet.py``.

Per node the nearest and second-nearest neighbours give a local frame;
each edge gets the geometry (d, theta, phi, tau); two ``EdgeGraphConv``
streams take the torsion-type (n_r * n_s^2) and the angle-type
(n_r * n_s) basis features; a residual MLP and ``GraphNorm`` close each
block; the readout sums atom-wise outputs per graph.

Layouts, as in the JAX model:

* flat (``nk_degree=0``): the compacted radius graph
  (``radius_graph_flat``, receivers ascending) and four
  ``segment_argmin`` frame picks (receiver and sender side, nearest and
  second nearest);
* NK (``nk_degree > 0``, over the whole batch or, with ``block_size``,
  per slot of a ``MoleculeLoader(slot_size=block_size)`` batch): the
  frame picks are a per-row argmin over the K lanes, the selected vectors
  a one-hot contraction, the sender side one ``nk_gather`` of a packed
  per-node table, the aggregation a reshape-sum;
* periodic (``use_pbc``, ``ComENetOCP``): ``radius_graph_pbc_flat`` over
  ``globals['cell']``, the geometry on its minimum-image displacement
  vectors, the frame picks of the flat layout. ``nk_degree`` is ignored.

Every sum that reaches the card goes through the sorted-CSR kernel, so a
step repeats bit for bit: the flat edge->node sums through
``segment_sum_sorted`` (a window of every edge: no overflow check), the
per-graph sums (``GraphNorm``'s statistics, the readout) through
``readout_sum``, and every row gather with a gradient through
``gather_rows``. The angles use a guarded ``atan2`` whose arguments are
replaced, not its output, where they degenerate, so the force loss's
double backward stays finite.

``compute_dtype`` (``torch.bfloat16``) runs the linears and the basis
features in it; parameters, geometry, ``GraphNorm`` and the readout MLP
stay float32.
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
from ..ops.pbc import radius_graph_pbc_flat
from ..ops.radius import (radius_graph_flat, radius_graph_nk,
                          radius_graph_nk_blocked)
from ..ops.segment import (flat_edges_to_nodes, gather_rows, readout_sum,
                           segment_argmin, segment_sum)
from ..ops.segment_csr import full_window
from ..ops.triplets import edges_to_nodes_nk, nk_gather
from .schnet_dense import _linear   # Glorot-uniform kernel, zero bias


def safe_atan2(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``atan2(b, a)`` with (a, b) -> (1, 0) where ``a^2 + b^2 < 1e-12``
    (the arguments are replaced, so the gradient there is 0, not NaN, at
    every order), and ``|b| < 1e-5 |a|`` snapped to 0 so anti-parallel
    planes give +pi, not +-pi on rounding noise."""
    deg = (a * a + b * b) < 1e-12
    a = torch.where(deg, 1.0, a)
    b = torch.where(deg, 0.0, b)
    b = torch.where(torch.abs(b) < 1e-5 * torch.abs(a), 0.0, b)
    return torch.atan2(b, a)


def _unit(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.clamp(torch.sum(v * v, -1, keepdim=True), min=1e-24)
    return v * torch.rsqrt(n2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _plane_dihedral(u, r1, r2):
    """Angle in [0, pi] between the planes span(u, r1) and span(u, r2)
    around the axis u (unit vectors); 0 where a plane degenerates (a
    reference vector (anti)parallel to the edge), detected on the plane
    norms."""
    p1 = _cross(u, r1)
    p2 = _cross(u, r2)
    deg = (torch.sum(p1 * p1, -1) < 1e-6) | (torch.sum(p2 * p2, -1) < 1e-6)
    a = torch.where(deg, 1.0, torch.sum(p1 * p2, -1))
    b = torch.where(deg, 0.0, torch.sum(_cross(p1, p2) * u, -1))
    ang = safe_atan2(b, a)
    return torch.where(ang < 0, ang + math.pi, ang)


class TwoLayerLinear(nn.Module):
    """Two bias-free linears, swish after each with ``act``."""

    def __init__(self, in_dim: int, middle: int, out: int, act: bool,
                 dtype, gen):
        super().__init__()
        self.act, self.dtype = act, dtype
        self.lin1 = _linear(in_dim, middle, False, gen)
        self.lin2 = _linear(middle, out, False, gen)

    def flax_denses(self):
        return [self.lin1, self.lin2]

    def forward(self, x):
        x = dense(x, self.lin1, self.dtype)
        if self.act:
            x = swish(x)
        x = dense(x, self.lin2, self.dtype)
        return swish(x) if self.act else x


class EdgeGraphConv(nn.Module):
    """GraphConv with edge-feature-modulated messages: ``out =
    lin_rel(sum_j w_e * x_j) + lin_root(x)``. NK layout: the sender rows
    through ``nk_gather``, a reshape-sum onto the receivers; flat: the
    sender rows through ``gather_rows``, the sorted-CSR sum."""

    def __init__(self, dim: int, dtype, gen):
        super().__init__()
        self.dtype = dtype
        self.lin_rel = _linear(dim, dim, True, gen)
        self.lin_root = _linear(dim, dim, False, gen)

    def flax_denses(self):
        return [self.lin_rel, self.lin_root]

    def forward(self, x, senders, receivers, edge_mask, edge_weight,
                num_nodes: int, nkg=None):
        if nkg is not None:
            xs = nk_gather(x, nkg.nbr_idx, nkg.rev_edge, nkg.nbr_mask)
            agg = edges_to_nodes_nk(xs * edge_weight, num_nodes,
                                    mask=edge_mask)
        else:
            # the real receivers ascend in every layout built here: the
            # sorted-CSR sum over a window of every edge
            msgs = gather_rows(x, senders) * edge_weight
            agg = flat_edges_to_nodes(msgs, receivers, num_nodes, edge_mask,
                                      full_window(msgs.shape[0]))
        return (dense(agg, self.lin_rel, self.dtype)
                + dense(x, self.lin_root, self.dtype))


class GraphNorm(nn.Module):
    """Per-graph normalisation (torch_geometric's GraphNorm), float32: the
    statistics through ``readout_sum``, their rows back through
    ``gather_rows``."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(dim))
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x, node_graph, node_mask, num_graphs: int):
        cnt = torch.clamp(segment_sum(node_mask.to(x.dtype), node_graph,
                                      num_graphs), min=1.0)[:, None]
        mean = readout_sum(x, node_graph, num_graphs, node_mask) / cnt
        sub = x - self.alpha * gather_rows(mean, node_graph)
        var = readout_sum(sub * sub, node_graph, num_graphs, node_mask) / cnt
        std = gather_rows(torch.sqrt(var + 1e-5), node_graph)
        out = self.gamma * sub / std + self.beta
        return torch.where(node_mask[:, None], out, 0.0)


class SimpleInteractionBlock(nn.Module):
    """One ComENet block: two conv streams, a residual MLP of
    ``num_layers`` linears, ``GraphNorm`` (float32), a last linear."""

    def __init__(self, hidden: int, middle: int, num_radial: int,
                 num_spherical: int, num_layers: int, out_dim: int, dtype,
                 gen):
        super().__init__()
        self.dtype = dtype
        n, k = num_spherical, num_radial
        L = lambda i, o: _linear(i, o, True, gen)
        self.lin_x = L(hidden, hidden)
        self.tll1 = TwoLayerLinear(n * n * k, middle, hidden, False, dtype,
                                   gen)
        self.conv1 = EdgeGraphConv(hidden, dtype, gen)
        self.lin1 = L(hidden, hidden)
        self.tll2 = TwoLayerLinear(n * k, middle, hidden, False, dtype, gen)
        self.conv2 = EdgeGraphConv(hidden, dtype, gen)
        self.lin2 = L(hidden, hidden)
        self.lin_cat = L(2 * hidden, hidden)
        self.lins = nn.ModuleList(L(hidden, hidden)
                                  for _ in range(num_layers))
        self.norm = GraphNorm(hidden)
        self.lin_out = L(hidden, out_dim)

    def flax_denses(self):
        """Linears in the order flax numbers the block's Dense_i."""
        return [self.lin_x, self.lin1, self.lin2, self.lin_cat, *self.lins,
                self.lin_out]

    def forward(self, x, feature1, feature2, senders, receivers, edge_mask,
                g: GraphBatch, nkg=None):
        dt, N = self.dtype, g.num_nodes
        x = swish(dense(x, self.lin_x, dt))
        h1 = self.conv1(x, senders, receivers, edge_mask,
                        self.tll1(feature1), N, nkg)
        h1 = swish(dense(h1, self.lin1, dt))
        h2 = self.conv2(x, senders, receivers, edge_mask,
                        self.tll2(feature2), N, nkg)
        h2 = swish(dense(h2, self.lin2, dt))
        h = dense(torch.cat([h1, h2], dim=-1), self.lin_cat, dt) + x
        for lin in self.lins:
            h = swish(dense(h, lin, dt)) + h
        h = self.norm(h.float(), g.node_graph, g.node_mask, g.num_graphs)
        if dt is not None:
            h = h.to(dt)
        return dense(h, self.lin_out, dt)


class ComENet(nn.Module):
    """Defaults as the JAX model's (the reference's ``comenet.py:232-242``).
    See the module docstring for the layouts; ``generator`` seeds the
    initial weights, ``device`` (default: the CUDA card) holds them."""

    use_pbc_default = False

    def __init__(self, cutoff: float = 8.0, num_layers: int = 4,
                 hidden_channels: int = 256, middle_channels: int = 64,
                 out_channels: int = 1, num_radial: int = 3,
                 num_spherical: int = 2, num_output_layers: int = 3,
                 max_edges: int = 4096, use_pbc: Optional[bool] = None,
                 pbc_images: int = 1, nk_degree: int = 0,
                 block_size: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None, float32 or "
                             f"bfloat16, got {compute_dtype}")
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.cutoff = cutoff
        self.num_radial, self.num_spherical = num_radial, num_spherical
        self.max_edges = max_edges
        self.use_pbc = self.use_pbc_default if use_pbc is None else use_pbc
        self.pbc_images = pbc_images
        self.nk_degree, self.block_size = nk_degree, block_size
        dt = None if compute_dtype == torch.float32 else compute_dtype
        self.dtype = dt
        self.embed = nn.Embedding(95, hidden_channels)
        with torch.no_grad():   # flax uniform(scale=sqrt 3): U[0, sqrt 3)
            self.embed.weight.uniform_(0.0, math.sqrt(3.0), generator=gen)
        self.blocks = nn.ModuleList(
            SimpleInteractionBlock(hidden_channels, middle_channels,
                                   num_radial, num_spherical,
                                   num_output_layers, hidden_channels, dt,
                                   gen)
            for _ in range(num_layers))
        self.lins = nn.ModuleList(
            _linear(hidden_channels, hidden_channels, True, gen)
            for _ in range(num_output_layers))
        self.lin_out = _linear(hidden_channels, out_channels, True, gen)
        self.to(device)

    def flax_denses(self):
        return [*self.lins, self.lin_out]

    def _frames_nk(self, pos, g: GraphBatch):
        """The NK layout's graph and frame vectors: one closed gather of the
        positions, a per-row argmin over the K lanes for the nearest and
        second-nearest slot, one closed gather of the packed per-node
        table ``[v0 | v1 | n0]`` for the sender side."""
        if self.block_size > 0:
            nkg = radius_graph_nk_blocked(pos, g.node_mask, self.cutoff,
                                          self.nk_degree, self.block_size,
                                          node_graph=g.node_graph)
        else:
            nkg = radius_graph_nk(pos, g.node_graph, g.node_mask,
                                  self.cutoff, self.nk_degree)
        N, K = g.num_nodes, self.nk_degree
        i = nkg.receivers
        ev = (nk_gather(pos, nkg.nbr_idx, nkg.rev_edge, nkg.nbr_mask)
              .reshape(N, K, 3) - pos[:, None, :])
        vecs = ev.reshape(N * K, 3)
        d2d = torch.sqrt(torch.clamp(torch.sum(ev * ev, -1), min=1e-12))
        dist = torch.where(nkg.edge_mask, d2d.reshape(-1), 1.0)
        with torch.no_grad():
            dsel = torch.where(nkg.nbr_mask, d2d, torch.inf)
            slot0 = torch.argmin(dsel, dim=1)
            oh0 = F.one_hot(slot0, K).to(pos.dtype)
            slot1 = torch.argmin(torch.where(oh0 > 0, torch.inf, dsel), dim=1)
            oh1 = F.one_hot(slot1, K).to(pos.dtype)
            n0 = torch.gather(nkg.nbr_idx, 1, slot0[:, None])[:, 0]
        # the selected vectors as one-hot contractions: exact, and their
        # adjoint is a broadcast, no scatter
        v0 = torch.sum(oh0[:, :, None] * ev, dim=1)
        v1 = torch.sum(oh1[:, :, None] * ev, dim=1)
        tab = torch.cat([v0, v1, n0[:, None].to(pos.dtype)], dim=1)
        gj = nk_gather(tab, nkg.nbr_idx, nkg.rev_edge, nkg.nbr_mask)
        n0j = gj[:, 6].detach().to(torch.int32)
        mask_iref = (n0[:, None] == nkg.nbr_idx).reshape(-1)
        pos_in0 = v0[:, None, :].expand(N, K, 3).reshape(-1, 3)
        pos_in1 = v1[:, None, :].expand(N, K, 3).reshape(-1, 3)
        pos_iref = torch.where(mask_iref[:, None], pos_in1, pos_in0)
        # the flat layout orients the sender side's vector pos[j] - pos[ref];
        # ev is pos[ref] - pos[j]
        pos_jref_j = -torch.where((n0j == i)[:, None], gj[:, 3:6], gj[:, :3])
        return (nkg.senders, nkg.receivers, nkg.edge_mask, vecs, dist,
                pos_in0, pos_in1, pos_iref, pos_jref_j, nkg)

    def _frames_flat(self, pos, g: GraphBatch):
        """The flat and periodic layouts' graph and frame vectors: four
        ``segment_argmin`` picks, the vectors through one ``gather_rows``."""
        N = g.num_nodes
        if self.use_pbc:
            pg = radius_graph_pbc_flat(pos, g.globals["cell"], g.node_graph,
                                       g.node_mask, self.cutoff,
                                       self.max_edges, images=self.pbc_images)
            senders, receivers, edge_mask = (pg.senders, pg.receivers,
                                             pg.edge_mask)
            vecs, dist = pg.edge_vec, pg.edge_dist
        else:
            senders, receivers, edge_mask = radius_graph_flat(
                pos, g.node_graph, g.node_mask, self.cutoff, self.max_edges)
            ji = gather_rows(pos, torch.stack([senders, receivers], dim=1))
            vecs = ji[:, 0] - ji[:, 1]
            dist = torch.where(edge_mask, torch.sqrt(torch.clamp(
                torch.sum(vecs * vecs, -1), min=1e-12)), 1.0)
        j, i = senders.long(), receivers.long()
        E = senders.shape[0]
        with torch.no_grad():
            d = dist.detach()
            ar = torch.arange(E, device=pos.device)
            am0 = segment_argmin(d, i, N, mask=edge_mask).long()
            am1 = segment_argmin(d, i, N,
                                 mask=edge_mask & (ar != am0[i])).long()
            am0_j = segment_argmin(d, j, N, mask=edge_mask).long()
            am1_j = segment_argmin(d, j, N,
                                   mask=edge_mask & (ar != am0_j[j])).long()
            # the reference neighbour must differ from the edge's partner
            idx_iref = torch.where(j[am0][i] == j, am1[i], am0[i])
            idx_jref = torch.where(i[am0_j][j] == i, am1_j[j], am0_j[j])
            idx = torch.stack([am0[i], am1[i], idx_iref, idx_jref], dim=1)
        sel = gather_rows(vecs, idx)                  # [E, 4, 3]
        return (senders, receivers, edge_mask, vecs, dist, sel[:, 0],
                sel[:, 1], sel[:, 2], sel[:, 3], None)

    def forward(self, g: GraphBatch) -> torch.Tensor:
        """Energies ``[G, out_channels]`` of a batch."""
        pos = g.nodes["pos"]
        if self.nk_degree > 0 and not self.use_pbc:
            frames = self._frames_nk(pos, g)
        else:
            frames = self._frames_flat(pos, g)
        (senders, receivers, edge_mask, pos_ji, dist, pos_in0, pos_in1,
         pos_iref, pos_jref_j, nkg) = frames
        E = senders.shape[0]
        # theta, phi, tau (the reference's comenet.py:365-386)
        a = torch.sum(-pos_ji * pos_in0, -1)
        cr = _cross(-pos_ji, pos_in0)
        b = torch.sqrt(torch.clamp(torch.sum(cr * cr, -1), min=1e-12))
        theta = safe_atan2(b, a)
        theta = torch.where(theta < 0, theta + math.pi, theta)
        u_ji = _unit(pos_ji)
        phi = _plane_dihedral(u_ji, _unit(pos_in0), _unit(pos_in1))
        tau = _plane_dihedral(u_ji, _unit(pos_jref_j), _unit(pos_iref))

        n, k = self.num_spherical, self.num_radial
        rbf = bessel_table(n, k, dist / self.cutoff)            # [E, n, k]
        cbf = sph_full_table(n, theta, phi).reshape(-1, n, n)
        feature1 = (cbf[:, :, :, None] * rbf[:, None, :, :]).reshape(
            E, n * n * k)
        feature2 = (rbf * sph_m0_table(n, tau)[:, :, None]).reshape(E, n * k)
        em = edge_mask[:, None]
        feature1 = torch.where(em, feature1, 0.0)
        feature2 = torch.where(em, feature2, 0.0)
        dt = self.dtype
        w = self.embed.weight
        if dt is not None:
            feature1, feature2, w = feature1.to(dt), feature2.to(dt), w.to(dt)
        nm = g.node_mask[:, None]
        x = torch.where(nm, gather_rows(w, g.nodes["z"]), 0.0)
        for blk in self.blocks:
            x = blk(x, feature1, feature2, senders, receivers, edge_mask, g,
                    nkg)
            x = torch.where(nm, x, 0.0)
        x = x.float()
        for lin in self.lins:
            x = swish(lin(x))
        x = self.lin_out(x)
        return readout_sum(x, g.node_graph, g.num_graphs, g.node_mask)


class ComENetOCP(ComENet):
    """The OCP / S2EF configuration: periodic crystals (``use_pbc=True``;
    the reference's ``comenet-ocp.py:274``)."""

    use_pbc_default = True
