"""Triplet (k->j->i) tables and angle/torsion geometry, on the flat
(compacted edge list) layout and on the [N, K] neighbour-table layout. Port
of ``dig_tpu/ops/triplets.py``.

Triplets are laid out ``[E, D]`` row-major (T = E*D): triplet (e, s) has
ji-edge e and, as its kj-edge, the s-th in-edge of e's sender, so the
reduction over triplets of one edge is a reshape-sum. On the flat layout
the in-edge tables come from one stable sort and a rank within each
receiver's run (:func:`build_in_edge_table`); on the NK layout (D = K)
every table is index arithmetic.

Gathers whose plain adjoint would be a scatter-add come in closed pairs:
each member is a ``torch.autograd.Function`` whose backward is the other
member, so every derivative order is a gather over a reverse table
(deterministic, free of atomics). Both members are exact only when the
consumer's cotangent is zero at invalid slots; every consumer here masks.
The flat geometry's own gathers (``pos[senders]``, ``pos[in-neighbours]``)
go through ``gather_rows``, whose adjoint is a sorted-CSR sum: bitwise
repeatable on the card too.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .radius import NKGraph
from .segment import gather_rows


class Triplets(NamedTuple):
    idx_kj: torch.Tensor       # [T] edge id of k->j
    idx_ji: torch.Tensor       # [T] edge id of j->i
    idx_k: torch.Tensor        # [T] node k
    idx_j: torch.Tensor        # [T] node j
    idx_i: torch.Tensor        # [T] node i
    mask: torch.Tensor         # [T] bool
    in_edges: torch.Tensor     # [N, K] incoming-edge table
    in_mask: torch.Tensor      # [N, K]
    kj_bwd_idx: torch.Tensor   # [E, K] triplets t with idx_kj[t] == e
    kj_bwd_mask: torch.Tensor  # [E, K]
    senders: torch.Tensor      # [E]
    receivers: torch.Tensor    # [E]
    edge_mask: torch.Tensor    # [E]
    nk_nbr: Optional[torch.Tensor] = None  # [N, K] sender table
    nk_rev: Optional[torch.Tensor] = None  # [N, K] reverse-edge ids


def build_in_edge_table(receivers: torch.Tensor, edge_mask: torch.Tensor,
                        num_nodes: int, max_in_degree: int):
    """Capped per-node incoming-edge table ``(in_edges [N, D], in_mask
    [N, D], edge_rank [E])``: ``in_edges[n, d]`` is the id of the d-th
    edge (ascending id) with receiver n; ``edge_rank`` is each edge's slot
    in its receiver's row (D for padding and for edges past the cap, which
    are dropped)."""
    E, D = receivers.shape[0], max_in_degree
    dev = receivers.device
    recv = torch.where(edge_mask, receivers.long(), num_nodes)  # park pads
    order = torch.argsort(recv, stable=True)
    recv_sorted = recv[order]
    # rank within the receiver's run: position minus the run's start
    rank = (torch.arange(E, device=dev)
            - torch.searchsorted(recv_sorted, recv_sorted, side="left"))
    valid = (recv_sorted < num_nodes) & (rank < D)
    flat_idx = torch.where(valid, recv_sorted * D + rank, num_nodes * D)
    # one spare slot takes the dropped entries and is cut off
    in_edges = torch.zeros(num_nodes * D + 1, dtype=torch.int32, device=dev)
    in_edges[flat_idx] = order.to(torch.int32)
    in_mask = torch.zeros(num_nodes * D + 1, dtype=torch.bool, device=dev)
    in_mask[flat_idx] = True
    edge_rank = torch.full((E,), D, dtype=torch.int32, device=dev)
    edge_rank[order] = torch.where(valid, rank, D).to(torch.int32)
    return (in_edges[:-1].reshape(num_nodes, D),
            in_mask[:-1].reshape(num_nodes, D), edge_rank)


def build_triplets(senders: torch.Tensor, receivers: torch.Tensor,
                   edge_mask: torch.Tensor, num_nodes: int,
                   max_in_degree: int) -> Triplets:
    """All (k->j->i) triplets with k != i of a flat edge list, ``[E * D]``.

    Also builds the reverse table ``kj_bwd_idx [E, D]``: the triplet rows
    whose kj-edge is f, i.e. ``out_edges[receivers[f]] * D +
    edge_rank[f]`` (the out-edges of f's receiver, at f's slot), the
    gather indices of :func:`expand_kj`'s adjoint. Exact whenever every
    node's degree fits ``max_in_degree``."""
    E, D = senders.shape[0], max_in_degree
    i32 = torch.int32
    in_edges, in_mask, edge_rank = build_in_edge_table(
        receivers, edge_mask, num_nodes, D)
    out_edges, out_mask, _ = build_in_edge_table(
        senders, edge_mask, num_nodes, D)
    j, i = senders.long(), receivers.long()
    kj = in_edges[j]                                       # [E, D]
    kj_valid = in_mask[j] & edge_mask[:, None]
    k = torch.where(kj_valid, senders[kj.long()], 0)
    mask = kj_valid & (k != receivers[:, None])
    idx_ji = torch.arange(E, dtype=i32, device=senders.device)[:, None]
    f_ok = edge_mask & (edge_rank < D)
    kj_bwd_mask = out_mask[i] & f_ok[:, None]
    kj_bwd_idx = torch.where(kj_bwd_mask, out_edges[i] * D
                             + edge_rank[:, None], 0)
    m = mask.reshape(-1)
    z = lambda t: torch.where(m, t.expand(E, D).reshape(-1), 0).to(i32)
    return Triplets(
        idx_kj=z(kj), idx_ji=z(idx_ji), idx_k=z(k),
        idx_j=z(senders[:, None]), idx_i=z(receivers[:, None]), mask=m,
        in_edges=in_edges, in_mask=in_mask, kj_bwd_idx=kj_bwd_idx.to(i32),
        kj_bwd_mask=kj_bwd_mask, senders=senders, receivers=receivers,
        edge_mask=edge_mask)


def build_triplets_nk(g: NKGraph) -> Triplets:
    """Triplets of an :class:`NKGraph`, zero sorts: the in-edge table of
    node n is ``arange(n*K, n*K + K)``, its out-edge table ``rev_edge[n]``
    and ``edge_rank[e] = e % K``."""
    N, K = g.nbr_idx.shape
    E = N * K
    dev = g.nbr_idx.device
    i32 = torch.int32
    ar_k = torch.arange(K, dtype=i32, device=dev)
    j, i = g.senders.long(), g.receivers.long()
    kj = g.senders[:, None] * K + ar_k[None, :]
    kj_valid = g.nbr_mask[j] & g.edge_mask[:, None]
    k = torch.where(kj_valid, g.nbr_idx[j], 0)
    mask = kj_valid & (k != g.receivers[:, None])
    idx_ji = torch.arange(E, dtype=i32, device=dev)[:, None].expand(E, K)

    # consumers of edge f as a kj edge: the out-edges of receivers[f]
    oe = g.rev_edge[i]
    kj_bwd_mask = g.nbr_mask[i] & g.edge_mask[:, None]
    rank = torch.arange(E, dtype=i32, device=dev) % K
    kj_bwd_idx = torch.where(kj_bwd_mask, oe * K + rank[:, None], 0)

    m = mask.reshape(-1)
    z = lambda t: torch.where(m, t.reshape(-1), 0).to(i32)
    return Triplets(
        idx_kj=z(kj), idx_ji=z(idx_ji), idx_k=z(k),
        idx_j=z(g.senders[:, None].expand(E, K)),
        idx_i=z(g.receivers[:, None].expand(E, K)),
        mask=m,
        in_edges=torch.arange(E, dtype=i32, device=dev).reshape(N, K),
        in_mask=g.nbr_mask, kj_bwd_idx=kj_bwd_idx.to(i32),
        kj_bwd_mask=kj_bwd_mask, senders=g.senders, receivers=g.receivers,
        edge_mask=g.edge_mask, nk_nbr=g.nbr_idx, nk_rev=g.rev_edge)


def edges_to_nodes_nk(data: torch.Tensor, num_nodes: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge->node sum in the [N, K] layout (receivers[e] == e // K): a
    dense reshape-sum, deterministic."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
        data = torch.where(m, data, 0)
    K = data.shape[0] // num_nodes
    return data.reshape(num_nodes, K, *data.shape[1:]).sum(dim=1)


def triplets_to_edges(data: torch.Tensor, num_edges: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum triplet rows onto their ji edge (``idx_ji[e*K + s] == e``): a
    dense reshape-sum, the replacement for a segment sum over idx_ji."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
        data = torch.where(m, data, 0)
    D = data.shape[0] // num_edges
    return data.reshape(num_edges, D, *data.shape[1:]).sum(dim=1)


# ---------------------------------------------------------------------------
# closed gather pairs: each Function's backward is the other one
# ---------------------------------------------------------------------------

def _nbr_gather(x, nbr):
    return x[nbr.long()]


def _nbr_gather_adj(ct, rev, in_mask):
    N, K = rev.shape
    g = ct.reshape(N * K, -1)[rev.long()]                # [N, K, C]
    return torch.where(in_mask[:, :, None], g, 0).sum(dim=1)


class _NbrGather(torch.autograd.Function):
    """``x [N, C] -> [N, K, C]``, ``out[n, d] = x[nbr[n, d]]`` (raw:
    garbage at invalid slots). Adjoint: :class:`_NbrGatherAdj`."""

    @staticmethod
    def forward(ctx, x, nbr, rev, in_mask):
        ctx.save_for_backward(nbr, rev, in_mask)
        return _nbr_gather(x, nbr)

    @staticmethod
    def backward(ctx, ct):
        nbr, rev, in_mask = ctx.saved_tensors
        return _NbrGatherAdj.apply(ct, nbr, rev, in_mask), None, None, None


class _NbrGatherAdj(torch.autograd.Function):
    """``ct [N, K, C] -> [N, C]``, ``dx[m] = sum_t in_mask[m, t] *
    ct.reshape(N*K, C)[rev[m, t]]``. Adjoint: :class:`_NbrGather`."""

    @staticmethod
    def forward(ctx, ct, nbr, rev, in_mask):
        ctx.save_for_backward(nbr, rev, in_mask)
        return _nbr_gather_adj(ct, rev, in_mask)

    @staticmethod
    def backward(ctx, u):
        nbr, rev, in_mask = ctx.saved_tensors
        return _NbrGather.apply(u, nbr, rev, in_mask), None, None, None


def nk_gather_nodes(x: torch.Tensor, trip: Triplets) -> torch.Tensor:
    """Per-node rows ``x [N, C]`` to the edge table ``[E, C]`` (row
    e = (i, d) holds ``x[nbr[i, d]]``): ``x[senders]`` with a
    scatter-free adjoint."""
    N, K = trip.nk_nbr.shape
    return _NbrGather.apply(x, trip.nk_nbr, trip.nk_rev,
                            trip.in_mask).reshape(N * K, -1)


def nk_gather(x: torch.Tensor, nbr: torch.Tensor, rev: torch.Tensor,
              in_mask: torch.Tensor) -> torch.Tensor:
    """:func:`nk_gather_nodes` for callers holding an ``NKGraph``
    (``nbr=nbr_idx``, ``rev=rev_edge``, ``in_mask=nbr_mask``): ``x [N, C]
    -> [N*K, C]``."""
    N, K = nbr.shape
    return _NbrGather.apply(x, nbr, rev, in_mask).reshape(N * K, -1)


def _expand_raw(x, nbr):
    N, K = nbr.shape
    return x.reshape(N, K, x.shape[-1])[nbr.long()].reshape(N * K * K, -1)


def _expand_raw_adj(ct, rev, in_mask):
    N, K = rev.shape
    g4 = ct.reshape(N * K, K, ct.shape[-1])[rev.long()]   # [N, K, K, C]
    g4 = torch.where(in_mask[:, :, None, None], g4, 0)
    return g4.sum(dim=1).reshape(N * K, -1)


def _expand(x, mask, nbr):
    return torch.where(mask[:, None], _expand_raw(x, nbr), 0)


def _expand_adj(ct, mask, rev, in_mask):
    return _expand_raw_adj(torch.where(mask[:, None], ct, 0), rev, in_mask)


class _ExpandKJ(torch.autograd.Function):
    """Edge rows ``x [E, C]`` to triplet rows ``[T, C]`` by [K, C] blocks,
    zero at masked triplets. Adjoint: :class:`_ExpandKJAdj`."""

    @staticmethod
    def forward(ctx, x, mask, nbr, rev, in_mask):
        ctx.save_for_backward(mask, nbr, rev, in_mask)
        return _expand(x, mask, nbr)

    @staticmethod
    def backward(ctx, ct):
        mask, nbr, rev, in_mask = ctx.saved_tensors
        return (_ExpandKJAdj.apply(ct, mask, nbr, rev, in_mask),
                None, None, None, None)


class _ExpandKJAdj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, mask, nbr, rev, in_mask):
        ctx.save_for_backward(mask, nbr, rev, in_mask)
        return _expand_adj(ct, mask, rev, in_mask)

    @staticmethod
    def backward(ctx, u):
        mask, nbr, rev, in_mask = ctx.saved_tensors
        return (_ExpandKJ.apply(u, mask, nbr, rev, in_mask),
                None, None, None, None)


class _ExpandKJRaw(torch.autograd.Function):
    """:func:`expand_kj_raw`: edge rows ``x [E, C]`` to triplet rows
    ``[T, C]`` by [K, C] blocks, garbage at masked triplets. Adjoint:
    :class:`_ExpandKJRawAdj`."""

    @staticmethod
    def forward(ctx, x, nbr, rev, in_mask):
        ctx.save_for_backward(nbr, rev, in_mask)
        return _expand_raw(x, nbr)

    @staticmethod
    def backward(ctx, ct):
        return (_ExpandKJRawAdj.apply(ct, *ctx.saved_tensors),
                None, None, None)


class _ExpandKJRawAdj(torch.autograd.Function):
    """``ct [T, C] -> [E, C]``: ``dx[j*K + s] = sum_m in_mask[j, m] *
    ct.reshape(E, K, C)[rev[j, m], s]``, over the mutual-edge slots only and
    mask-free in ``ct``. Adjoint: :class:`_ExpandKJRaw`."""

    @staticmethod
    def forward(ctx, ct, nbr, rev, in_mask):
        ctx.save_for_backward(nbr, rev, in_mask)
        return _expand_raw_adj(ct, rev, in_mask)

    @staticmethod
    def backward(ctx, u):
        return (_ExpandKJRaw.apply(u, *ctx.saved_tensors),
                None, None, None)


def expand_kj_raw(x: torch.Tensor, trip: Triplets) -> torch.Tensor:
    """Mask-free NK block gather (the edge rows ``x [E, C]`` at each
    triplet's kj edge, ``[T, C]``): garbage rows at masked triplets, and an
    adjoint over the mutual-edge slots that does not mask its cotangent.

    Sound only for a consumer that multiplies the rows by the triplet mask
    before any reduction and zeroes its cotangent at masked triplets, as
    ``fused_triplet_product`` / ``fused_angle_product`` do; it saves the
    two [T, C] ``where`` passes of :func:`expand_kj`. Both members of the
    closed pair are gathers, to any derivative order."""
    return _ExpandKJRaw.apply(x, trip.nk_nbr, trip.nk_rev, trip.in_mask)


def _expand_flat(x, mask, idx_kj):
    return torch.where(mask[:, None], x[idx_kj.long()], 0)


def _expand_flat_adj(ct, mask, kj_bwd_idx, kj_bwd_mask):
    ct = torch.where(mask[:, None], ct, 0)
    g = ct[kj_bwd_idx.long()]                             # [E, D, C]
    return torch.where(kj_bwd_mask[:, :, None], g, 0).sum(dim=1)


class _ExpandKJFlat(torch.autograd.Function):
    """Edge rows ``x [E, C]`` to triplet rows ``[T, C]`` by ``idx_kj``,
    zero at masked triplets. Adjoint: :class:`_ExpandKJFlatAdj`."""

    @staticmethod
    def forward(ctx, x, mask, idx_kj, kj_bwd_idx, kj_bwd_mask):
        ctx.save_for_backward(mask, idx_kj, kj_bwd_idx, kj_bwd_mask)
        return _expand_flat(x, mask, idx_kj)

    @staticmethod
    def backward(ctx, ct):
        return (_ExpandKJFlatAdj.apply(ct, *ctx.saved_tensors),
                None, None, None, None)


class _ExpandKJFlatAdj(torch.autograd.Function):
    """``ct [T, C] -> [E, C]``: ``dx[f] = sum_d kj_bwd_mask[f, d] *
    (mask * ct)[kj_bwd_idx[f, d]]``. Adjoint: :class:`_ExpandKJFlat`."""

    @staticmethod
    def forward(ctx, ct, mask, idx_kj, kj_bwd_idx, kj_bwd_mask):
        ctx.save_for_backward(mask, idx_kj, kj_bwd_idx, kj_bwd_mask)
        return _expand_flat_adj(ct, mask, kj_bwd_idx, kj_bwd_mask)

    @staticmethod
    def backward(ctx, u):
        return (_ExpandKJFlat.apply(u, *ctx.saved_tensors),
                None, None, None, None)


def expand_kj(x: torch.Tensor, trip: Triplets) -> torch.Tensor:
    """Gather edge rows ``x [E, C]`` to triplet rows ``[T, C]`` (kj edge
    of each triplet), zeroing masked triplets. The adjoint is a gather over
    the reverse table, not a scatter: [K, C] blocks over ``nk_rev`` on the
    NK layout, rows over ``kj_bwd_idx`` on the flat one."""
    if trip.nk_nbr is not None:
        return _ExpandKJ.apply(x, trip.mask, trip.nk_nbr, trip.nk_rev,
                               trip.in_mask)
    return _ExpandKJFlat.apply(x, trip.mask, trip.idx_kj, trip.kj_bwd_idx,
                               trip.kj_bwd_mask)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _edge_frames(pos: torch.Tensor, trip: Triplets):
    """Per-edge geometry: ji [E] and jk [E, D] vectors (componentwise),
    the in-neighbour table [N, D] and the [E, D] slot mask."""
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    if trip.nk_nbr is None:
        j, i = trip.senders, trip.receivers
        kn_tab = torch.where(trip.in_mask, trip.senders[trip.in_edges.long()],
                             0)
        pi, pj = gather_rows(pos, i), gather_rows(pos, j)        # [E, 3]
        pk = gather_rows(gather_rows(pos, kn_tab), j)             # [E, D, 3]
        ji = tuple(pi[:, c] - pj[:, c] for c in range(3))
        jk = tuple(pk[..., c] - pj[:, c, None] for c in range(3))
        nbr_mask = trip.in_mask[j.long()] & trip.edge_mask[:, None]
        return ji, jk, kn_tab, nbr_mask
    nbr = trip.nk_nbr
    N, K = nbr.shape
    pn = _NbrGather.apply(pos, nbr, trip.nk_rev, trip.in_mask)  # [N, K, 3]
    evx = pn[..., 0] - px[:, None]
    evy = pn[..., 1] - py[:, None]
    evz = pn[..., 2] - pz[:, None]
    ji = (-evx.reshape(-1), -evy.reshape(-1), -evz.reshape(-1))
    evcat = torch.cat([evx, evy, evz], dim=1)                   # [N, 3K]
    g = _NbrGather.apply(evcat, nbr, trip.nk_rev,
                         trip.in_mask).reshape(N * K, 3 * K)
    jk = (g[:, :K], g[:, K:2 * K], g[:, 2 * K:])
    nbr_mask = (trip.in_mask[nbr.long()].reshape(N * K, K)
                & trip.edge_mask[:, None])
    return ji, jk, nbr, nbr_mask


def _norm(x, y, z, eps):
    return torch.sqrt(torch.clamp(x * x + y * y + z * z, min=eps))


def edge_distances(pos, senders, receivers, edge_mask,
                   eps: float = 1e-12) -> torch.Tensor:
    """Edge lengths [E] of a flat edge list; masked rows 1.0 (safe for
    log and division)."""
    diff = gather_rows(pos, receivers) - gather_rows(pos, senders)
    d = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=eps))
    return torch.where(edge_mask, d, 1.0)


def nk_edge_distances(pos, trip: Triplets, eps: float = 1e-12):
    """Edge lengths [E] from the closed frame table; masked rows 1.0."""
    (jix, jiy, jiz), _, _, _ = _edge_frames(pos, trip)
    return torch.where(trip.edge_mask, _norm(jix, jiy, jiz, eps), 1.0)


def triplet_kj_distances(pos, trip: Triplets, eps: float = 1e-12):
    """Per-triplet k->j edge length [T]; masked rows 1.0."""
    _, (jkx, jky, jkz), _, nbr_mask = _edge_frames(pos, trip)
    d = _norm(jkx, jky, jkz, eps)
    return torch.where(nbr_mask.reshape(-1) & trip.mask, d.reshape(-1), 1.0)


def triplet_geometry(pos, trip: Triplets, eps: float = 1e-12):
    """Angle at j between j->i and j->k per triplet, in [0, pi]:
    atan2(|cross|, dot)."""
    (jix, jiy, jiz), (jkx, jky, jkz), _, _ = _edge_frames(pos, trip)
    jix, jiy, jiz = jix[:, None], jiy[:, None], jiz[:, None]
    a = jix * jkx + jiy * jky + jiz * jkz
    cx = jiy * jkz - jiz * jky
    cy = jiz * jkx - jix * jkz
    cz = jix * jky - jiy * jkx
    b = _norm(cx, cy, cz, eps)
    angle = torch.atan2(b, a).reshape(-1)
    return torch.where(trip.mask, angle, 0.0)


def _ab(pd, pn, j, dji):
    """a = P_d . P_n, b = (P_d x P_n) . ji / |ji| (componentwise)."""
    (xd, yd, zd), (xn, yn, zn), (jx, jy, jz) = pd, pn, j
    a = xd * xn + yd * yn + zd * zn
    b = ((yd * zn - zd * yn) * jx + (zd * xn - xd * zn) * jy
         + (xd * yn - yd * xn) * jz) / dji
    return a, b


def _sanitize(a, b, eps):
    # double where: atan2(0, 0) has a NaN gradient that leaks through a
    # single where, so the degenerate inputs are replaced before atan2
    degenerate = (a * a + b * b) < eps
    return torch.where(degenerate, 1.0, a), torch.where(degenerate, 0.0, b)


def _dihedral(pd, pn, j, dji, eps):
    a, b = _sanitize(*_ab(pd, pn, j, dji), eps)
    tors = torch.atan2(b, a)
    # remap to (0, 2 pi]; the small epsilon puts the self-candidate
    # (b ~ 0 after rounding) on the 2 pi branch, as the reference
    return torch.where(tors <= 1e-6, tors + 2.0 * math.pi, tors)


def _dihedral_key(pd, pn, j, dji, eps):
    """Monotone surrogate of the remapped dihedral (the 'diamond angle'
    in [0, 4)), for the argmin only."""
    a, b = _sanitize(*_ab(pd, pn, j, dji), eps)
    ab = torch.abs(a) + torch.abs(b)
    num = torch.where(b >= 0, torch.where(a >= 0, b, -a),
                      torch.where(a < 0, -b, a))
    off = torch.where(b >= 0, torch.where(a >= 0, 0.0, 1.0),
                      torch.where(a < 0, 2.0, 3.0))
    t = off + num / ab
    return torch.where(t <= 1e-6, t + 4.0, t)


def torsion_angles(pos, trip: Triplets, eps: float = 1e-12):
    """Per-triplet torsion: min over the reference neighbours k_n of j
    (k_n != i) of the dihedral between planes (ji, jk) and (ji, j k_n), in
    (0, 2 pi].

    The [E, K, K] candidate grid only selects the reference neighbour, so
    it is evaluated without gradients (argmin, first minimum on ties); the
    dihedral is recomputed on the selected candidate, picked by a one-hot
    product (elementwise, no matmul and no scatter in its adjoint).
    """
    (jix, jiy, jiz), (jkx, jky, jkz), kn_tab, nbr_mask = _edge_frames(
        pos, trip)
    i = trip.receivers
    j = trip.senders.long()
    dist_ji = _norm(jix, jiy, jiz, eps)
    p_x = jiy[:, None] * jkz - jiz[:, None] * jky
    p_y = jiz[:, None] * jkx - jix[:, None] * jkz
    p_z = jix[:, None] * jky - jiy[:, None] * jkx
    cand_valid = nbr_mask & (kn_tab[j] != i[:, None])           # [E, K]

    with torch.no_grad():
        gx, gy, gz = p_x[:, :, None], p_y[:, :, None], p_z[:, :, None]
        hx, hy, hz = p_x[:, None, :], p_y[:, None, :], p_z[:, None, :]
        key = _dihedral_key(
            (gx, gy, gz), (hx, hy, hz),
            (jix[:, None, None], jiy[:, None, None], jiz[:, None, None]),
            dist_ji[:, None, None], eps)
        key = torch.where(cand_valid[:, None, :], key, 1e30)
        n_star = torch.argmin(key, dim=2)                        # [E, K]
        any_valid = torch.amin(key, dim=2) < 1e29
        K = p_x.shape[1]
        onehot = (torch.arange(K, device=pos.device)[None, None, :]
                  == n_star[:, :, None]).to(p_x.dtype)

    sel = lambda t: torch.sum(onehot * t[:, None, :], dim=2)
    out = _dihedral((p_x, p_y, p_z), (sel(p_x), sel(p_y), sel(p_z)),
                    (jix[:, None], jiy[:, None], jiz[:, None]),
                    dist_ji[:, None], eps).reshape(-1)
    return torch.where(trip.mask & any_valid.reshape(-1), out, 0.0)
