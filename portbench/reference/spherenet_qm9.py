"""Plain reference of SphereNet (Liu et al., "Spherical Message Passing
for 3D Molecular Graphs", DIG's ``spherenet.py``) at the configuration's
widths, in float32, trained on energies or on energies and forces.

Geometry, per molecule:

* edges: each atom keeps its ``nk_degree`` nearest neighbours within the
  cutoff; an edge j -> i exists where each of i and j keeps the other.
  Squared distances are |p|^2 + |q|^2 - 2 p.q, as the port ranks them;
* triplets k -> j -> i: every edge j -> i with every edge k -> j, k != i;
* the angle at j between j->i and j->k (atan2 of |cross| and dot), and
  the torsion: the smallest dihedral in (0, 2 pi] between the plane
  (ji, jk) and a plane (ji, j k'), k' over j's other neighbours (k' != i;
  k itself lands at 2 pi).

Bases: DistEmb = envelope(d / c) sin(freq d / c) (exponent 5), the
spherical Bessel basis j_l(z_lm x) normalised over the zeros z_lm of
j_l, real spherical harmonics Y_l^m (the order [m=0, 1..l, -l..-1] of
the port's tables), sbf = bessel x Y_l^0, tbf = Y_l^m x bessel. The
Bessel and harmonic rows are evaluated in float64 and rounded to
float32.

Network: the init block, ``num_layers`` edge updates (basis projections,
the triplet product summed onto the ji edge, one residual layer before
the skip and two after) and ``num_layers + 1`` node updates (edge sum,
Linear, three swish Linears, a bias-free output), the energy the sum of
the node updates' outputs over the molecule's atoms.

Loss: L1 energy error (mean over molecules) for ``energy``; for
``energy_force``, (sum |E - y_0| + p * sum |F - F_target|) / molecules,
with F = -dE/dpos kept differentiable. Gradients are taken over blocks
of molecules and summed.

Departures from DIG, as the port has them: the nearest-``nk_degree``
mutual neighbour list in place of radius_graph's 32 (the same pairs
where ``nk_degree`` is at least the largest molecule's atoms less one),
the torsion's reference neighbour chosen as above, and the weights' init
(the seed's).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .common import (Precision, accumulate, chunks, linear_spec, swish)

CHUNK = {"energy": 64, "energy_force": 24}    # molecules a block


def param_spec(cfg: dict):
    H, I, O = (cfg["hidden_channels"], cfg["int_emb_size"],
               cfg["out_emb_channels"])
    n, k = cfg["num_spherical"], cfg["num_radial"]
    Bd, Ba, Bt = (cfg["basis_emb_size_dist"], cfg["basis_emb_size_angle"],
                  cfg["basis_emb_size_torsion"])
    L = lambda name, i, o, b=False: linear_spec(name, i, o, b)
    spec = [("dist_emb.freq", (k,),
             ("values", [math.pi * (i + 1) for i in range(k)])),
            ("init_block.embed.weight", (95, H), ("normal", 1.0))]
    spec += L("init_block.lin_rbf0", k, H, True)
    spec += L("init_block.lin", 3 * H, H, True)
    spec += L("init_block.lin_rbf1", k, H)
    for v in range(cfg["num_layers"] + 1):
        p = f"update_vs.{v}"
        spec += L(f"{p}.lin_in", H, O, True)
        for j in range(cfg["num_output_layers"]):
            spec += L(f"{p}.lins.{j}", O, O, True)
        spec += L(f"{p}.lin_out", O, cfg["out_channels"])
    for e in range(cfg["num_layers"]):
        p = f"update_es.{e}"
        spec += L(f"{p}.lin_ji", H, H, True) + L(f"{p}.lin_kj", H, H, True)
        spec += L(f"{p}.lin_rbf1", k, Bd) + L(f"{p}.lin_rbf2", Bd, H)
        spec += L(f"{p}.lin_down", H, I)
        spec += L(f"{p}.lin_sbf1", n * k, Ba) + L(f"{p}.lin_sbf2", Ba, I)
        spec += L(f"{p}.lin_t1", n * n * k, Bt) + L(f"{p}.lin_t2", Bt, I)
        spec += L(f"{p}.lin_up", I, H)
        for j in range(cfg["num_before_skip"]):
            spec += (L(f"{p}.before.{j}.lin1", H, H, True)
                     + L(f"{p}.before.{j}.lin2", H, H, True))
        spec += L(f"{p}.lin_skip", H, H, True)
        for j in range(cfg["num_after_skip"]):
            spec += (L(f"{p}.after.{j}.lin1", H, H, True)
                     + L(f"{p}.after.{j}.lin2", H, H, True))
        spec += L(f"{p}.lin_rbf_out", k, H)
    return spec


# ---------------------------------------------------------------------------
# bases
# ---------------------------------------------------------------------------

def _sph_jn(l: int, x):
    """Spherical Bessel j_l(x) of a float64 array or tensor, by the upward
    recurrence."""
    sin, cos = (torch.sin, torch.cos) if torch.is_tensor(x) else (np.sin,
                                                                  np.cos)
    j0 = sin(x) / x
    if l == 0:
        return j0
    j1 = sin(x) / x ** 2 - cos(x) / x
    for i in range(1, l):
        j0, j1 = j1, (2 * i + 1) / x * j1 - j0
    return j1


@lru_cache(maxsize=None)
def bessel_zeros(n: int, k: int) -> np.ndarray:
    """The first k positive zeros of j_0..j_{n-1} ``[n, k]``, by bisection
    between the interlacing zeros of the order below."""
    zeros = np.zeros((n, k))
    points = np.arange(1, k + n) * np.pi       # zeros of j_0
    zeros[0] = points[:k]
    for l in range(1, n):
        roots = []
        for a, b in zip(points[:-1], points[1:]):
            fa = _sph_jn(l, np.float64(a))
            for _ in range(200):
                mid = 0.5 * (a + b)
                fm = _sph_jn(l, np.float64(mid))
                if (fm > 0) == (fa > 0):
                    a, fa = mid, fm
                else:
                    b = mid
            roots.append(0.5 * (a + b))
        points = np.array(roots)
        zeros[l] = points[:k]
    return zeros


@lru_cache(maxsize=None)
def bessel_norms(n: int, k: int) -> np.ndarray:
    """``[n, k]``: 1 / sqrt(j_{l+1}(z_lm)^2 / 2)."""
    z = bessel_zeros(n, k)
    return np.array([[1.0 / math.sqrt(0.5 * _sph_jn(l + 1, z0) ** 2)
                      for z0 in z[l]] for l in range(n)])


def bessel_rows(n: int, k: int, x: torch.Tensor) -> torch.Tensor:
    """``[..., n, k]``: the normalised j_l(z_lm x), x = d / c, evaluated
    in float64."""
    f64 = lambda a: torch.tensor(a, dtype=torch.float64, device=x.device)
    arg = f64(bessel_zeros(n, k)) * x.double()[..., None, None]
    return torch.stack([_sph_jn(l, arg[..., l, :]) for l in range(n)],
                       -2) * f64(bessel_norms(n, k))


def _pf(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) * math.factorial(l - abs(m))
                     / (4 * math.pi * math.factorial(l + abs(m))))


def _legendre(n: int, z: torch.Tensor):
    """P_l^m(z) without the (1 - z^2)^(m/2) factor, Condon-Shortley
    phase: ``P[l][m]`` for 0 <= m <= l < n."""
    P = [[None] * (l + 1) for l in range(n)]
    P[0][0] = torch.ones_like(z)
    if n > 1:
        P[1][0] = z
    for l in range(2, n):
        P[l][0] = ((2 * l - 1) * z * P[l - 1][0] - (l - 1) * P[l - 2][0]) / l
    for m in range(1, n):
        P[m][m] = (1 - 2 * m) * P[m - 1][m - 1]
        if m + 1 < n:
            P[m + 1][m] = (2 * m + 1) * z * P[m][m]
        for l in range(m + 2, n):
            P[l][m] = ((2 * l - 1) * z * P[l - 1][m]
                       - (l + m - 1) * P[l - 2][m]) / (l - m)
    return P


def sph_m0(n: int, theta: torch.Tensor) -> torch.Tensor:
    """``[..., n]``: Y_l^0(theta)."""
    P = _legendre(n, torch.cos(theta.double()))
    return torch.stack([_pf(l, 0) * P[l][0] for l in range(n)], -1)


def sph_full(n: int, theta: torch.Tensor, phi: torch.Tensor):
    """``[..., n * n]``: Y_l^m(theta, phi), l-major, each l in the order
    [m=0, 1..l, -l..-1]; cos(m phi) and sin(m phi) carry sin(theta)^m."""
    th, ph = theta.double(), phi.double()
    P = _legendre(n, torch.cos(th))
    xs, ys = torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph)
    S, C = [torch.zeros_like(th)], [torch.ones_like(th)]
    for i in range(1, n):
        S.append(xs * S[i - 1] + ys * C[i - 1])
        C.append(xs * C[i - 1] - ys * S[i - 1])
    out = []
    for l in range(n):
        row = [None] * (2 * l + 1)
        row[0] = _pf(l, 0) * P[l][0]
        for m in range(1, l + 1):
            row[m] = math.sqrt(2) * _pf(l, m) * C[m] * P[l][m]
            row[-m] = math.sqrt(2) * _pf(l, -m) * S[m] * P[l][m]
        out += row
    return torch.stack(out, -1)


def envelope(x: torch.Tensor, exponent: int) -> torch.Tensor:
    p = exponent + 1
    a, b, c = -(p + 1) * (p + 2) / 2, p * (p + 2), -p * (p + 1) / 2
    return 1.0 / x + a * x ** (p - 1) + b * x ** p + c * x ** (p + 1)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def neighbours(pos: torch.Tensor, mask: torch.Tensor, cutoff: float,
               K: int):
    """Per padded molecule ``[M, A]``: ``(nbr [M, A, K], keep [M, A, K])``,
    the K nearest in-cutoff neighbours of each atom and which of them
    survive the mutual rule. No gradient."""
    with torch.no_grad():
        p = pos.float()
        sq = torch.sum(p * p, -1)
        dot = torch.sum(p[:, :, None, :] * p[:, None, :, :], -1)
        d2 = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, min=0.0)
        M, A = mask.shape
        eye = torch.eye(A, dtype=torch.bool, device=pos.device)
        adj = mask[:, :, None] & mask[:, None, :] & ~eye \
            & (d2 < cutoff * cutoff)
        score = torch.where(adj, -d2, -torch.inf)
        kk = min(K, A)
        vals, nbr = torch.topk(score, kk, dim=-1, sorted=True)
        top = vals > -torch.inf
        nbr = torch.where(top, nbr, 0)
        kept = torch.zeros((M, A, A), dtype=torch.bool, device=pos.device)
        bi = torch.arange(M, device=pos.device)[:, None, None].expand_as(nbr)
        ii = torch.arange(A, device=pos.device)[None, :, None].expand_as(nbr)
        kept[bi[top], ii[top], nbr[top]] = True
        keep = top & kept[bi, nbr, ii]
    return nbr, keep


class Graph:
    """A block of molecules as compact real edges and triplets over the
    flattened padded atoms (row = molecule * A + atom)."""

    def __init__(self, pos, mask, cutoff, K):
        M, A = mask.shape
        dev = pos.device
        nbr, keep = neighbours(pos, mask, cutoff, K)
        K = nbr.shape[-1]
        base = (torch.arange(M, device=dev) * A)[:, None, None]
        recv = (base + torch.arange(A, device=dev)[None, :, None]
                ).expand(M, A, K)
        send = (base + nbr).reshape(M * A, K)                # atom tables
        flat_keep = keep.reshape(-1)
        self.recv = recv.reshape(-1)[flat_keep]              # i of edge e
        self.send = send.reshape(-1)[flat_keep]              # j of edge e
        eid = torch.full((M * A * K,), -1, dtype=torch.long, device=dev)
        eid[flat_keep] = torch.arange(int(flat_keep.sum()), device=dev)
        eid = eid.view(M * A, K)
        # each edge e: j -> i and the slots of j's table; a slot holding a
        # kept k -> j with k != i is a triplet and a torsion candidate
        f = eid[self.send]                                   # [E, K]
        self.k_table = send[self.send]                       # [E, K] atom k
        self.ok = (f >= 0) & (self.k_table != self.recv[:, None])
        E = self.recv.shape[0]
        self.t_ji = torch.arange(E, device=dev)[:, None].expand_as(f)[self.ok]
        self.t_slot = torch.arange(K, device=dev)[None, :].expand_as(f)[
            self.ok]
        self.t_kj = f[self.ok]

    def counts(self, M: int, A: int) -> torch.Tensor:
        """``[M, 4]`` work of each molecule of the block: real edges, real
        triplets, the distinct kj rows the triplets gather and the edges
        that own a triplet."""
        dev = self.recv.device
        mol = lambda e: self.recv[e] // A
        count = lambda e: torch.bincount(mol(e), minlength=M)
        all_e = torch.arange(self.recv.shape[0], device=dev)
        return torch.stack([count(all_e), count(self.t_ji),
                            count(torch.unique(self.t_kj)),
                            count(torch.unique(self.t_ji))], 1)


def _norm(x, eps=1e-12):
    return torch.sqrt(torch.clamp(torch.sum(x * x, -1), min=eps))


def _sanitize(a, b, eps):
    # a double where: atan2(0, 0) has a NaN gradient
    degenerate = (a * a + b * b) < eps
    return torch.where(degenerate, 1.0, a), torch.where(degenerate, 0.0, b)


def _ab(pd, pn, ji, dji):
    a = torch.sum(pd * pn, -1)
    b = torch.sum(torch.cross(pd, pn, dim=-1) * ji, -1) / dji
    return a, b


def _key(pd, pn, ji, dji, eps):
    """A monotone stand-in of the dihedral remapped to (0, 2 pi], in
    [0, 4), for choosing the torsion's reference neighbour."""
    a, b = _sanitize(*_ab(pd, pn, ji, dji), eps)
    ab = torch.abs(a) + torch.abs(b)
    num = torch.where(b >= 0, torch.where(a >= 0, b, -a),
                      torch.where(a < 0, -b, a))
    off = torch.where(b >= 0, torch.where(a >= 0, 0.0, 1.0),
                      torch.where(a < 0, 2.0, 3.0))
    t = off + num / ab
    return torch.where(t <= 1e-6, t + 4.0, t)


def geometry(g: Graph, pos_flat: torch.Tensor, eps: float = 1e-12):
    """``(dist [E], angle [T], dist_kj [T], phi [T])``."""
    pj = pos_flat[g.send]
    ji = pos_flat[g.recv] - pj                               # [E, 3]
    dist = _norm(ji, eps)
    jk_all = pos_flat[g.k_table] - pj[:, None, :]            # [E, K, 3]
    jk = jk_all[g.t_ji, g.t_slot]                            # [T, 3]
    ji_t, d_t = ji[g.t_ji], dist[g.t_ji]
    angle = torch.atan2(_norm(torch.cross(ji_t, jk, dim=-1), eps),
                        torch.sum(ji_t * jk, -1))
    p_all = torch.cross(ji[:, None, :].expand_as(jk_all), jk_all, dim=-1)
    pd = p_all[g.t_ji, g.t_slot]                             # [T, 3]
    with torch.no_grad():
        key = _key(pd[:, None, :], p_all[g.t_ji], ji_t[:, None, :],
                   d_t[:, None], eps)                        # [T, K]
        n_star = torch.argmin(torch.where(g.ok[g.t_ji], key, 1e30), dim=1)
    a, b = _sanitize(*_ab(pd, p_all[g.t_ji, n_star], ji_t, d_t), eps)
    tors = torch.atan2(b, a)
    phi = torch.where(tors <= 1e-6, tors + 2.0 * math.pi, tors)
    return dist, angle, _norm(jk, eps), phi


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

def energies(P, z, pos, mask, cfg, prec: Precision):
    """Energies ``[M]`` of a block of padded molecules (``pos`` may
    require a gradient)."""
    n, k, c = cfg["num_spherical"], cfg["num_radial"], cfg["cutoff"]
    M, A = mask.shape
    lin = lambda x, name, b=True: prec.linear(
        x, P[f"{name}.weight"], P.get(f"{name}.bias") if b else None)
    g = Graph(pos, mask, c, cfg["nk_degree"])
    pos_flat = pos.reshape(M * A, 3)
    dist, angle, dist_kj, phi = geometry(g, pos_flat)
    d = (dist / c)[:, None]
    rbf = envelope(d, cfg["envelope_exponent"]) * torch.sin(
        P["dist_emb.freq"] * d)                              # [E, k]
    bes = bessel_rows(n, k, dist_kj / c)                     # [T, n, k]
    sbf = (bes * sph_m0(n, angle)[:, :, None]).reshape(-1, n * k).float()
    tbf = (sph_full(n, angle, phi).reshape(-1, n, n)[:, :, :, None]
           * bes[:, None, :, :]).reshape(-1, n * n * k).float()

    x = P["init_block.embed.weight"][z.reshape(-1)]
    rbf0 = swish(lin(rbf, "init_block.lin_rbf0"))
    e1 = swish(lin(torch.cat([x[g.recv], x[g.send], rbf0], -1),
                   "init_block.lin"))
    e2 = lin(rbf, "init_block.lin_rbf1", False) * e1
    node_mask = mask.reshape(-1)

    def update_v(v_i, e2):
        p = f"update_vs.{v_i}"
        v = torch.zeros((M * A, e2.shape[1]), dtype=e2.dtype,
                        device=e2.device).index_add(0, g.recv, e2)
        v = lin(v, f"{p}.lin_in")
        for j in range(cfg["num_output_layers"]):
            v = swish(lin(v, f"{p}.lins.{j}"))
        v = lin(v, f"{p}.lin_out", False)[:, 0] * node_mask
        return v.reshape(M, A).sum(1)

    def residual(x, p):
        h = swish(lin(x, f"{p}.lin1"))
        return x + swish(lin(h, f"{p}.lin2"))

    E = update_v(0, e2)
    for l in range(cfg["num_layers"]):
        p = f"update_es.{l}"
        x_ji = swish(lin(e1, f"{p}.lin_ji"))
        x_kj = swish(lin(e1, f"{p}.lin_kj"))
        r = lin(lin(rbf, f"{p}.lin_rbf1", False), f"{p}.lin_rbf2", False)
        x_kj = swish(lin(x_kj * r, f"{p}.lin_down", False))
        s = lin(lin(sbf, f"{p}.lin_sbf1", False), f"{p}.lin_sbf2", False)
        t = lin(lin(tbf, f"{p}.lin_t1", False), f"{p}.lin_t2", False)
        m = x_kj[g.t_kj] * s * t
        x_kj = torch.zeros_like(x_ji[:, :m.shape[1]]).index_add(0, g.t_ji, m)
        x_kj = swish(lin(x_kj, f"{p}.lin_up", False))
        h = x_ji + x_kj
        for j in range(cfg["num_before_skip"]):
            h = residual(h, f"{p}.before.{j}")
        h = swish(lin(h, f"{p}.lin_skip")) + e1
        for j in range(cfg["num_after_skip"]):
            h = residual(h, f"{p}.after.{j}")
        e1 = h
        e2 = lin(rbf, f"{p}.lin_rbf_out", False) * e1
        E = E + update_v(l + 1, e2)
    return E


def pad(mols, device, with_forces: bool):
    n = max(len(m["z"]) for m in mols)
    M = len(mols)
    z = np.zeros((M, n), np.int64)
    pos = np.zeros((M, n, 3), np.float32)
    mask = np.zeros((M, n), bool)
    force = np.zeros((M, n, 3), np.float32)
    for i, m in enumerate(mols):
        a = len(m["z"])
        z[i, :a], pos[i, :a], mask[i, :a] = m["z"], m["pos"], True
        if with_forces:
            force[i, :a] = m["force"]
    t = lambda x: torch.from_numpy(x).to(device)
    return t(z), t(pos), t(mask), t(force)


def loss_and_grads(P, mols, cfg, traffic, prec: Precision):
    kind = traffic["kind"]
    p_force = traffic["loss"].get("force_weight", 0.0)
    names = list(P)
    leaves = [P[k].detach().requires_grad_() for k in names]
    Pg = dict(zip(names, leaves))
    dev = leaves[0].device
    total, grads = 0.0, None
    for part in chunks(mols, CHUNK[kind]):
        z, pos, mask, f_t = pad(part, dev, kind == "energy_force")
        y = torch.tensor(np.array([m["y"][0] for m in part]), device=dev)
        if kind == "energy":
            loss = torch.sum(torch.abs(energies(Pg, z, pos, mask, cfg, prec)
                                       - y))
        else:
            pos = pos.requires_grad_()
            e = energies(Pg, z, pos, mask, cfg, prec)
            (gpos,) = torch.autograd.grad(e.sum(), pos, create_graph=True)
            loss = (torch.sum(torch.abs(e - y)) + p_force * torch.sum(
                torch.abs(-gpos - f_t) * mask[..., None]))
        loss = loss / len(mols)
        g = torch.autograd.grad(loss, leaves)
        grads = accumulate(grads, dict(zip(names, g)))
        total += float(loss.detach())
    return total, grads
