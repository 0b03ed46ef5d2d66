"""SphereNet and DimeNet++ on the flat (compacted edge list) layout and on
the [N, K] neighbour-table layout. Port of ``dig_tpu/models/spherenet.py``.

Supported layouts:

* flat (``nk_degree=0``, the default): the radius graph is a compacted
  edge list capped at ``max_edges`` (``radius_graph_flat``), the triplets
  come from ``build_triplets`` with ``max_in_degree`` in-edge slots, and
  the triplet product runs as plain PyTorch (``expand_kj``,
  ``triplets_to_edges``). ``UpdateV`` sums edges onto nodes through the
  sorted-CSR segment sum when ``segment_eb > 0`` (the kernel of
  ``csrc/segment_csr.cu`` on the card), else through ``index_add_``. The
  ``pallas_*`` flags are ignored here, as the JAX model falls back to its
  unfused chain on this layout.
* NK (``nk_degree > 0``): the radius graph is a per-node nearest-K table,
  built over the whole batch (``block_size=0``: ``radius_graph_nk``, any
  flat batch) or per slot of a slot-aligned batch (``block_size > 0``:
  ``radius_graph_nk_blocked``, batches from
  ``MoleculeLoader(slot_size=block_size)``). Four branches:

  - unfused (``pallas_triplet`` off): the plain chain over ``[T, C]``
    tensors (``expand_kj``, ``triplets_to_edges``);
  - the triplet product (``pallas_triplet`` without
    ``pallas_fuse_basis``): ``expand_kj_raw`` gathers the triplet rows and
    every layer's product is ``fused_triplet_product`` (DimeNet++:
    ``fused_angle_product``), the CUDA kernels of
    ``csrc/triplet_product.cu`` on the card; ``pallas_basis_grads=False``
    skips the basis cotangents (energy training only);
  - the packed basis (``pallas_triplet`` and ``pallas_fuse_basis`` without
    the slot kernel: ``block_size=0``, or ``pallas_slot`` off): the packed
    transposed basis table ``[R, T]`` is built once, ``expand_kj_raw``
    gathers the triplet rows and every layer's product is
    ``fused_triplet_pt`` (``csrc/triplet_pt.cu`` on the card);
  - the slot kernel (``pallas_triplet``, ``pallas_fuse_basis`` and
    ``pallas_slot`` with ``block_size > 0``): the packed basis table
    ``[K, R, E]`` is built once and every layer's product is
    ``fused_triplet_slot`` (``csrc/triplet_slot.cu`` on the card).

  The fused branches compose the two factorised basis projections into
  ``ws = ws1 @ ws2`` and ``wt = wt1 @ wt2`` from the same Linear weights,
  so one parameter set serves every branch.

Both branches differentiate twice: force training takes ``-dE/dpos``
with ``create_graph`` inside the loss (the fused branches through their
second-order kernels; ``pallas_basis_grads=True`` is required there).
The geometry keeps its graph back to ``pos`` (closed gather pairs, the
argmin-recompute torsion, the basis closed forms), and the fused kernels'
basis gradients are asked for whenever ``pos`` requires a gradient.
``forward(g, block_size=s)`` overrides the slot size per call of a
blocked model, so one module (one parameter set) serves every bucket of a
``BucketedMoleculeLoader`` batch; an unblocked model builds its table over
the whole batch whatever the call says.

On the NK layout ``UpdateV`` is a reshape-sum and ``segment_eb`` is
accepted and ignored, as in the JAX ``UpdateV``. The per-graph readout is
``readout_sum`` (the sorted-CSR sum: bitwise repeatable on the card).
``remat=True`` recomputes each ``UpdateE`` in the backward pass (a
non-reentrant ``torch.utils.checkpoint``, as the JAX model's ``nn.remat``)
instead of keeping its activations: the same values, less memory, one
more forward of each layer per backward. It survives the force loss's
double backward; the recomputed forward launches the layer's kernels again.

``compute_dtype`` (e.g. ``torch.bfloat16``) casts where the JAX model
casts: the distance embedding, the bases and the linears run in it;
parameters, geometry and the basis tables are computed in float32; the
final readout projection is float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..nn.blocks import dense
from ..nn.init import glorot_orthogonal
from ..ops.basis import Envelope, bessel_table, sph_full_table, sph_m0_table
from ..ops.radius import (NKGraph, radius_graph_flat, radius_graph_nk,
                          radius_graph_nk_blocked)
from ..ops.segment import flat_edges_to_nodes, gather_rows, readout_sum
from ..ops.triplet_product import fused_angle_product, fused_triplet_product
from ..ops.triplet_pt import basis_pt, fused_triplet_pt
from ..ops.triplet_slot import basis_pt_k, fused_triplet_slot
from ..ops.triplets import (Triplets, build_triplets, build_triplets_nk,
                            edge_distances, edges_to_nodes_nk, expand_kj,
                            expand_kj_raw, nk_edge_distances, nk_gather_nodes,
                            torsion_angles, triplet_geometry,
                            triplet_kj_distances, triplets_to_edges)


class Geometry(NamedTuple):
    """One batch's radius graph, triplets and geometry (float32). ``nkg``
    is None on the flat layout, whose edge list is ``trip``'s."""
    nkg: Optional[NKGraph]
    trip: Triplets
    dist: torch.Tensor                # [E] edge lengths
    angle: torch.Tensor               # [T] angle at j
    dist_kj: torch.Tensor             # [T] k->j lengths
    phi: Optional[torch.Tensor]       # [T] torsion (SphereNet only)


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _linear(i: int, o: int, bias: bool, gen: torch.Generator,
            ortho: bool = True) -> nn.Linear:
    """A Linear initialised as the JAX model's Dense: glorot-orthogonal
    (scale 2) where it passes ``kernel_init=go2``, LeCun-normal
    otherwise; zero bias."""
    lin = nn.Linear(i, o, bias=bias)
    with torch.no_grad():
        if ortho:
            glorot_orthogonal(lin.weight, gen)
        else:
            lin.weight.normal_(0.0, 1.0 / math.sqrt(i), generator=gen)
        if bias:
            lin.bias.zero_()
    return lin


class DistEmb(nn.Module):
    """Learnable-frequency spherical-Bessel j0 radial basis with the
    polynomial envelope; ``freq`` starts at n*pi."""

    def __init__(self, num_radial: int, cutoff: float,
                 envelope_exponent: int = 5):
        super().__init__()
        self.cutoff = cutoff
        self.envelope = Envelope(envelope_exponent)
        self.freq = nn.Parameter(torch.arange(1, num_radial + 1,
                                              dtype=torch.float32) * math.pi)

    def forward(self, dist):
        d = (dist / self.cutoff)[:, None]
        return self.envelope(d) * torch.sin(self.freq * d)


class AngleEmb(nn.Module):
    """bessel(d_kj) x Y_l^0(theta) -> [T, n*k]."""

    def __init__(self, num_spherical: int, num_radial: int, cutoff: float):
        super().__init__()
        self.n, self.k, self.cutoff = num_spherical, num_radial, cutoff

    def forward(self, rbf_kj, angle):
        cbf = sph_m0_table(self.n, angle)                     # [T, n]
        out = rbf_kj * cbf[:, :, None]                        # [T, n, k]
        return out.reshape(out.shape[0], -1)


class TorsionEmb(nn.Module):
    """t_{l,m}(d_kj, theta, phi) -> [T, n*n*k] in the reference's layout:
    ``out[t, a, b, c] = Y[a*n + b](theta, phi) * j[b, c](d_kj)``."""

    def __init__(self, num_spherical: int, num_radial: int, cutoff: float):
        super().__init__()
        self.n, self.k, self.cutoff = num_spherical, num_radial, cutoff

    def forward(self, rbf_kj, angle, phi):
        n, k = self.n, self.k
        cbf = sph_full_table(n, angle, phi).reshape(-1, n, n)
        out = cbf[:, :, :, None] * rbf_kj[:, None, :, :]
        return out.reshape(out.shape[0], n * n * k)


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int, dtype, gen):
        super().__init__()
        self.dtype = dtype
        self.lin1 = _linear(hidden, hidden, True, gen)
        self.lin2 = _linear(hidden, hidden, True, gen)

    def flax_denses(self):
        return [self.lin1, self.lin2]

    def forward(self, x):
        h = swish(dense(x, self.lin1, self.dtype))
        h = swish(dense(h, self.lin2, self.dtype))
        return x + h


class InitBlock(nn.Module):
    """init_e: e1 = act(W [x_i ; x_j ; act(W0 rbf)]), e2 = (W1 rbf) * e1.
    NK layout: x_j through the closed gather, x_i as a broadcast; flat:
    ``x[senders]``, ``x[receivers]``."""

    def __init__(self, hidden: int, num_radial: int, dtype, gen):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Embedding(95, hidden)
        with torch.no_grad():   # flax Embed init: U(-sqrt 3, sqrt 3)
            self.embed.weight.uniform_(-math.sqrt(3.0), math.sqrt(3.0),
                                       generator=gen)
        self.lin_rbf0 = _linear(num_radial, hidden, True, gen, ortho=False)
        self.lin = _linear(3 * hidden, hidden, True, gen, ortho=False)
        self.lin_rbf1 = _linear(num_radial, hidden, False, gen)

    def flax_denses(self):
        return [self.lin_rbf0, self.lin, self.lin_rbf1]

    def forward(self, z, rbf, trip):
        w = self.embed.weight
        # gather_rows: its adjoint (a sorted-CSR sum) repeats bit for bit on
        # the card, where indexing's accumulates with atomics
        x = gather_rows(w if self.dtype is None else w.to(self.dtype), z)
        rbf0 = swish(dense(rbf, self.lin_rbf0, self.dtype))
        if trip.nk_nbr is None:
            xs = gather_rows(x, trip.senders)
            xr = gather_rows(x, trip.receivers)
        else:
            N, K = trip.nk_nbr.shape
            xs = nk_gather_nodes(x, trip)
            xr = x[:, None, :].expand(N, K, x.shape[-1]).reshape(N * K, -1)
        e1 = swish(dense(torch.cat([xr, xs, rbf0], dim=-1), self.lin,
                         self.dtype))
        e2 = dense(rbf, self.lin_rbf1, self.dtype) * e1
        return e1, e2


class UpdateE(nn.Module):
    """update_e: basis projections, down-projection, the triplet product
    (``branch``: "unfused"; "product", ``fused_triplet_product`` /
    ``fused_angle_product``; "pt", ``fused_triplet_pt`` on the packed table
    ``geom``; "slot", the slot kernel on ``geom``), up-projection and
    residual stacks around a skip."""

    def __init__(self, hidden: int, int_emb: int, b_dist: int, b_angle: int,
                 b_torsion: int, use_torsion: bool, num_before_skip: int,
                 num_after_skip: int, num_spherical: int, num_radial: int,
                 basis_grads: bool, dtype, gen):
        super().__init__()
        self.dtype = dtype
        self.use_torsion = use_torsion
        self.basis_grads = basis_grads
        self.ns, self.nr = num_spherical, num_radial
        self.int_emb = int_emb
        L = lambda i, o, b=False: _linear(i, o, b, gen)
        s_dim, t_dim = num_spherical * num_radial, \
            num_spherical ** 2 * num_radial
        self.lin_ji = L(hidden, hidden, True)
        self.lin_kj = L(hidden, hidden, True)
        self.lin_rbf1 = L(num_radial, b_dist)
        self.lin_rbf2 = L(b_dist, hidden)
        self.lin_down = L(hidden, int_emb)
        self.lin_sbf1 = L(s_dim, b_angle)
        self.lin_sbf2 = L(b_angle, int_emb)
        if use_torsion:
            self.lin_t1 = L(t_dim, b_torsion)
            self.lin_t2 = L(b_torsion, int_emb)
        self.lin_up = L(int_emb, hidden)
        self.before = nn.ModuleList(ResidualLayer(hidden, dtype, gen)
                                    for _ in range(num_before_skip))
        self.lin_skip = L(hidden, hidden, True)
        self.after = nn.ModuleList(ResidualLayer(hidden, dtype, gen)
                                   for _ in range(num_after_skip))
        self.lin_rbf_out = L(num_radial, hidden)

    def flax_denses(self):
        """Linears in the order flax numbers this module's Dense_i."""
        t = [self.lin_t1, self.lin_t2] if self.use_torsion else []
        return ([self.lin_ji, self.lin_kj, self.lin_rbf1, self.lin_rbf2,
                 self.lin_down, self.lin_sbf1, self.lin_sbf2] + t
                + [self.lin_up, self.lin_skip, self.lin_rbf_out])

    def composed(self, lin1: nn.Linear, lin2: nn.Linear) -> torch.Tensor:
        """``w1 @ w2`` ([in, out]) in the compute dtype, as the JAX model
        gets it by applying both Dense to an identity."""
        dt = self.dtype or torch.float32
        return lin1.weight.t().to(dt) @ lin2.weight.t().to(dt)

    def packed_weights(self):
        """``(ws, wt)`` of the packed-basis kernels: the composed angle and
        torsion projections, ``wt`` a ``[1, int_emb]`` zero dummy (no
        parameter) without torsion."""
        ws = self.composed(self.lin_sbf1, self.lin_sbf2)
        wt = (self.composed(self.lin_t1, self.lin_t2) if self.use_torsion
              else torch.zeros((1, self.int_emb), dtype=ws.dtype,
                               device=ws.device))
        return ws, wt

    def forward(self, e1, rbf0, sbf, tbf, trip, branch="unfused",
                geom=None):
        """``geom``: ``(pt [K, R, E], m2T, lj, slot size)`` for "slot", the
        packed table ``pt [R, T]`` for "pt"."""
        dt = self.dtype
        x_ji = swish(dense(e1, self.lin_ji, dt))
        x_kj = swish(dense(e1, self.lin_kj, dt))
        rbf = dense(dense(rbf0, self.lin_rbf1, dt), self.lin_rbf2, dt)
        x_kj = swish(dense(x_kj * rbf, self.lin_down, dt))
        cfg = (self.ns, self.nr, self.use_torsion)
        if branch == "slot":
            pt_s, m2t, lj, slot_atoms = geom
            K = trip.nk_nbr.shape[1]
            x_kj = fused_triplet_slot(x_kj, pt_s, *self.packed_weights(), m2t,
                                      lj, slot_atoms, K, cfg)
        elif branch in ("pt", "product"):
            # the raw gather: the kernel masks its rows and their cotangents
            K = trip.nk_nbr.shape[1]
            xg = expand_kj_raw(x_kj, trip)
            m2d = trip.mask.reshape(-1, K).to(dt or torch.float32)
            if branch == "pt":
                x_kj = fused_triplet_pt(xg, geom, *self.packed_weights(), m2d,
                                        K, 128, cfg)
            elif self.use_torsion:
                x_kj = fused_triplet_product(
                    xg, sbf, tbf, *self.packed_weights(), m2d, K,
                    basis_grads=self.basis_grads)
            else:
                x_kj = fused_angle_product(
                    xg, sbf, self.composed(self.lin_sbf1, self.lin_sbf2), m2d,
                    K, basis_grads=self.basis_grads)
        else:
            s = dense(dense(sbf, self.lin_sbf1, dt), self.lin_sbf2, dt)
            x_kj = expand_kj(x_kj, trip) * s
            if self.use_torsion:
                t = dense(dense(tbf, self.lin_t1, dt), self.lin_t2, dt)
                x_kj = x_kj * t
            x_kj = triplets_to_edges(x_kj, e1.shape[0])
        x_kj = swish(dense(x_kj, self.lin_up, dt))
        e1_new = x_ji + x_kj
        for layer in self.before:
            e1_new = layer(e1_new)
        e1_new = swish(dense(e1_new, self.lin_skip, dt)) + e1
        for layer in self.after:
            e1_new = layer(e1_new)
        e2 = dense(rbf0, self.lin_rbf_out, dt) * e1_new
        return e1_new, e2


class UpdateV(nn.Module):
    """update_v: edge->node sum (NK layout: a reshape-sum; flat: the
    sorted-CSR sum when ``segment_eb > 0``, else ``index_add_``), output
    MLP, float32 readout projection."""

    def __init__(self, hidden: int, out_emb: int, out_channels: int,
                 num_output_layers: int, output_init: str, segment_eb: int,
                 dtype, gen):
        super().__init__()
        self.dtype = dtype
        self.segment_eb = segment_eb
        self.lin_in = _linear(hidden, out_emb, True, gen)
        self.lins = nn.ModuleList(_linear(out_emb, out_emb, True, gen)
                                  for _ in range(num_output_layers))
        self.lin_out = _linear(out_emb, out_channels, False, gen)
        if output_init == "zeros":
            with torch.no_grad():
                self.lin_out.weight.zero_()

    def flax_denses(self):
        return [self.lin_in, *self.lins, self.lin_out]

    def forward(self, e2, trip: Triplets, num_nodes):
        if trip.nk_nbr is not None:
            v = edges_to_nodes_nk(e2, num_nodes, mask=trip.edge_mask)
        else:
            v = flat_edges_to_nodes(e2, trip.receivers, num_nodes,
                                    trip.edge_mask, self.segment_eb)
        v = dense(v, self.lin_in, self.dtype)
        for lin in self.lins:
            v = swish(dense(v, lin, self.dtype))
        return self.lin_out(v.float())


class _SphericalMPNN(nn.Module):
    """Shared body of SphereNet / DimeNet++ (see the module docstring for
    the supported layouts)."""

    use_torsion = True

    def __init__(self, cutoff: float = 5.0, num_layers: int = 4,
                 hidden_channels: int = 128, out_channels: int = 1,
                 int_emb_size: int = 64, basis_emb_size_dist: int = 8,
                 basis_emb_size_angle: int = 8,
                 basis_emb_size_torsion: int = 8,
                 out_emb_channels: int = 256, num_spherical: int = 7,
                 num_radial: int = 6, envelope_exponent: int = 5,
                 num_before_skip: int = 1, num_after_skip: int = 2,
                 num_output_layers: int = 3,
                 output_init: str = "GlorotOrthogonal",
                 max_edges: int = 4096, max_in_degree: int = 24,
                 segment_eb: int = 0, nk_degree: int = 0,
                 block_size: int = 0,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, pallas_triplet: bool = False,
                 pallas_basis_grads: bool = True,
                 pallas_fuse_basis: bool = False, pallas_slot: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None, float32 or "
                             f"bfloat16, got {compute_dtype}")
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.cutoff = cutoff
        self.num_spherical, self.num_radial = num_spherical, num_radial
        self.max_edges, self.max_in_degree = max_edges, max_in_degree
        self.nk_degree, self.block_size = nk_degree, block_size
        self.compute_dtype = compute_dtype
        self.pallas_triplet = pallas_triplet
        self.pallas_basis_grads = pallas_basis_grads
        self.pallas_fuse_basis = pallas_fuse_basis
        self.pallas_slot = pallas_slot
        self.remat = remat
        dt = None if compute_dtype == torch.float32 else compute_dtype
        self.dist_emb = DistEmb(num_radial, cutoff, envelope_exponent)
        self.init_block = InitBlock(hidden_channels, num_radial, dt, gen)
        mk_v = lambda: UpdateV(hidden_channels, out_emb_channels,
                               out_channels, num_output_layers, output_init,
                               segment_eb, dt, gen)
        self.update_vs = nn.ModuleList([mk_v()])
        self.update_es = nn.ModuleList()
        for _ in range(num_layers):
            self.update_es.append(UpdateE(
                hidden_channels, int_emb_size, basis_emb_size_dist,
                basis_emb_size_angle, basis_emb_size_torsion,
                self.use_torsion, num_before_skip, num_after_skip,
                num_spherical, num_radial, pallas_basis_grads, dt, gen))
            self.update_vs.append(mk_v())
        self.dtype = dt
        self.to(device)

    @property
    def slot_fused(self) -> bool:
        """Every layer's triplet product through ``fused_triplet_slot``."""
        return (self.pallas_triplet and self.pallas_fuse_basis
                and self.pallas_slot and self.nk_degree > 0
                and self.block_size > 0)

    @property
    def pt_fused(self) -> bool:
        """Every layer's triplet product through ``fused_triplet_pt`` on the
        packed table (the JAX model's ``fuse_basis and not slot_fused``)."""
        return (self.pallas_triplet and self.pallas_fuse_basis
                and self.nk_degree > 0 and not self.slot_fused)

    @property
    def product_fused(self) -> bool:
        """Every layer's triplet product through ``fused_triplet_product``
        (``fused_angle_product`` without torsion)."""
        return (self.pallas_triplet and not self.pallas_fuse_basis
                and self.nk_degree > 0)

    def _slot_size(self, block_size: Optional[int]) -> int:
        """The batch's slot size: the call's, else the model's; 0 (the
        whole batch) for an unblocked model."""
        return (block_size or self.block_size) if self.block_size > 0 else 0

    def geometry(self, pos: torch.Tensor, g: GraphBatch,
                 block_size: Optional[int] = None) -> Geometry:
        """Radius graph, triplets and per-edge / per-triplet geometry
        (``block_size``: the batch's slot size on the blocked NK layout,
        default the model's)."""
        if self.nk_degree > 0:
            A = self._slot_size(block_size)
            if A > 0:
                nkg = radius_graph_nk_blocked(pos, g.node_mask, self.cutoff,
                                              self.nk_degree, A,
                                              node_graph=g.node_graph)
            else:
                nkg = radius_graph_nk(pos, g.node_graph, g.node_mask,
                                      self.cutoff, self.nk_degree)
            trip = build_triplets_nk(nkg)
            dist = nk_edge_distances(pos, trip)
        else:
            nkg = None
            senders, receivers, edge_mask = radius_graph_flat(
                pos, g.node_graph, g.node_mask, self.cutoff, self.max_edges)
            trip = build_triplets(senders, receivers, edge_mask, g.num_nodes,
                                  self.max_in_degree)
            dist = edge_distances(pos, senders, receivers, edge_mask)
        return Geometry(
            nkg, trip, dist,
            triplet_geometry(pos, trip), triplet_kj_distances(pos, trip),
            torsion_angles(pos, trip) if self.use_torsion else None)

    def slot_operands(self, geo: Geometry,
                      block_size: Optional[int] = None):
        """``(pt [K, R, E], m2T [K, E], lj [1, E])`` of
        ``fused_triplet_slot``: the packed basis built s-leading (keeping
        its graph back to the positions), the triplet mask and the
        slot-local sender ids, in the compute type (``lj`` int32)."""
        ns, nr = self.num_spherical, self.num_radial
        A, K = self._slot_size(block_size), self.nk_degree
        E = geo.nkg.senders.shape[0]
        smaj = lambda v: v.reshape(E, K).t()          # [T] e-major -> [K, E]
        pt_s = basis_pt_k(ns, nr, smaj(geo.angle),
                          None if geo.phi is None else smaj(geo.phi),
                          smaj(geo.dist_kj) / self.cutoff, self.use_torsion)
        cdt = self.dtype or torch.float32
        m2t = geo.trip.mask.reshape(E, K).t().to(cdt).contiguous()
        slot = torch.arange(E, dtype=torch.int32,
                            device=m2t.device) // (A * K)
        lj = (geo.nkg.senders - slot * A).to(torch.int32)[None]
        return pt_s.to(cdt), m2t, lj

    def bases(self, geo: Geometry):
        """``(sbf [T, n*k], tbf [T, n*n*k] or None)``, float32: the angle
        and torsion bases of the unfused and the product branch, from one
        shared Bessel evaluation on the triplet rows."""
        ns, nr = self.num_spherical, self.num_radial
        rbf_kj = bessel_table(ns, nr, geo.dist_kj / self.cutoff)
        sbf = AngleEmb(ns, nr, self.cutoff)(rbf_kj, geo.angle)
        tbf = (TorsionEmb(ns, nr, self.cutoff)(rbf_kj, geo.angle, geo.phi)
               if self.use_torsion else None)
        return sbf, tbf

    def forward(self, g: GraphBatch,
                block_size: Optional[int] = None) -> torch.Tensor:
        """Energies ``[G, out]`` of a batch (on the blocked NK layout a
        slot-aligned one whose slot size is ``block_size``, default the
        model's)."""
        A = self._slot_size(block_size)
        pos = g.nodes["pos"]
        N, G = g.num_nodes, g.num_graphs
        dt = self.dtype
        geo = self.geometry(pos, g, A)
        trip = geo.trip
        rbf0 = self.dist_emb(geo.dist)
        geom = sbf = tbf = None
        branch = ("slot" if self.slot_fused else "pt" if self.pt_fused else
                  "product" if self.product_fused else "unfused")
        if branch == "slot":
            geom = self.slot_operands(geo, A) + (A,)
        elif branch == "pt":
            # the packed transposed table [R, T], built once for all layers
            geom = basis_pt(self.num_spherical, self.num_radial, geo.angle,
                            geo.phi, geo.dist_kj / self.cutoff,
                            self.use_torsion).to(dt or torch.float32)
        else:
            sbf, tbf = self.bases(geo)
            if dt is not None:
                sbf = sbf.to(dt)
                tbf = None if tbf is None else tbf.to(dt)
        if dt is not None:
            rbf0 = rbf0.to(dt)
        e1, e2 = self.init_block(g.nodes["z"], rbf0, trip)
        v = self.update_vs[0](e2, trip, N)
        u = readout_sum(v, g.node_graph, G, g.node_mask)
        for ue, uv in zip(self.update_es, self.update_vs[1:]):
            if self.remat:
                e1, e2 = checkpoint(ue, e1, rbf0, sbf, tbf, trip, branch,
                                    geom, use_reentrant=False)
            else:
                e1, e2 = ue(e1, rbf0, sbf, tbf, trip, branch, geom)
            v = uv(e2, trip, N)
            u = u + readout_sum(v, g.node_graph, G, g.node_mask)
        return u


class SphereNet(_SphericalMPNN):
    """SphereNet: distance, angle and torsion bases."""
    use_torsion = True


class DimeNetPP(_SphericalMPNN):
    """DimeNet++: the same body without the torsion basis."""
    use_torsion = False
