"""Port's flat-layout graph ops vs the JAX package's, on the CPU: the radius
and kNN builders (``radius_graph_flat``, ``knn_graph_flat``,
``adjacency_to_edges``, ``radius_overflow``), the triplet tables
(``build_in_edge_table``, ``build_triplets``), the closed ``expand_kj``
pair and the geometry (``edge_distances``, ``triplet_geometry``,
``triplet_kj_distances``, ``torsion_angles``) on flat triplets.

Inputs are made with numpy from a seed and handed to both packages.
Indices and masks must be identical. Float32 values agree to 1e-6
(relative and absolute: the same formulas, evaluated in another order by
XLA); gradients with respect to the positions to 1e-5 (sums of many such
terms), the ``expand_kj`` adjoint to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops import radius as jr
from dig_tpu.ops import triplets as jt
from dig_tpu_torch.ops import radius as tr
from dig_tpu_torch.ops import triplets as tt


def _conformation(seed, n_graphs=3, n_pad=30, box=3.5):
    """Padded flat batch: graphs of 5-9 atoms, then padding rows."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 10, n_graphs)
    node_graph = np.full(n_pad, n_graphs - 1, np.int32)
    node_mask = np.zeros(n_pad, bool)
    off = 0
    for gi, s in enumerate(sizes):
        node_graph[off:off + s] = gi
        node_mask[off:off + s] = True
        off += s
    pos = (rng.uniform(size=(n_pad, 3)) * box).astype(np.float32)
    return pos, node_graph, node_mask


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


def _same(t_out, j_out, names):
    for name, a, b in zip(names, t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


EDGES = ("senders", "receivers", "edge_mask")


@pytest.mark.parametrize("cap", [None, 3])
def test_radius_graph_flat_identical(cap):
    j, t = _both(*_conformation(0))
    want = jr.radius_graph_flat(*j, 2.5, 400, max_num_neighbors=cap)
    got = tr.radius_graph_flat(*t, 2.5, 400, max_num_neighbors=cap)
    _same(got, want, EDGES)
    s, r, m = (x.numpy() for x in got)
    assert m.sum() > 20 and not m[m.sum():].any()     # padding last
    assert np.all(np.diff(r[m]) >= 0)                  # receivers ascend


def test_knn_graph_flat_identical():
    j, t = _both(*_conformation(1))
    _same(tr.knn_graph_flat(*t, 3, 300), jr.knn_graph_flat(*j, 3, 300),
          EDGES)


def test_truncation_by_max_edges_and_overflow():
    """A dense clump of 12 atoms has more than 64 in-cutoff pairs; a cap
    of 64 keeps the first 64 in row-major order, and radius_overflow
    counts the rest."""
    rng = np.random.default_rng(8)
    pos = rng.normal(size=(12, 3)).astype(np.float32) * 0.8
    j, t = _both(pos, np.zeros(12, np.int32), np.ones(12, bool))
    for cap in (64, 200):
        _same(tr.radius_graph_flat(*t, 3.0, cap),
              jr.radius_graph_flat(*j, 3.0, cap), EDGES)
        assert int(tr.radius_overflow(*t, 3.0, cap)) == int(
            jr.radius_overflow(*j, 3.0, cap))
    total = int(tr.radius_graph_flat(*t, 3.0, 200)[2].sum())
    assert int(tr.radius_overflow(*t, 3.0, 64)) == total - 64 > 0


TRIP = ("idx_kj", "idx_ji", "idx_k", "idx_j", "idx_i", "mask", "in_edges",
        "in_mask", "kj_bwd_idx", "kj_bwd_mask", "senders", "receivers",
        "edge_mask")


def _triplets(seed, max_edges, D, cutoff=2.5):
    pos, ng, nm = _conformation(seed)
    j, t = _both(pos, ng, nm)
    je = jr.radius_graph_flat(*j, cutoff, max_edges)
    te = tr.radius_graph_flat(*t, cutoff, max_edges)
    n = pos.shape[0]
    return (pos, jt.build_triplets(*je, n, D), tt.build_triplets(*te, n, D))


@pytest.mark.parametrize("max_edges, D", [(400, 12), (400, 3), (60, 8)],
                         ids=["uncapped", "degree_cap", "edge_cap"])
def test_build_triplets_identical(max_edges, D):
    _, jtr, ttr = _triplets(2, max_edges, D)
    _same([getattr(ttr, f) for f in TRIP], [getattr(jtr, f) for f in TRIP],
          TRIP)
    assert ttr.nk_nbr is None and ttr.mask.sum() > 0
    table = [tt.build_in_edge_table(ttr.receivers, ttr.edge_mask, 30, D),
             jt.build_in_edge_table(jtr.receivers, jtr.edge_mask, 30, D)]
    _same(table[0], table[1], ("in_edges", "in_mask", "edge_rank"))


def test_expand_kj_forward_adjoint_and_double_backward():
    """Forward and VJP against JAX; the double backward (the adjoint's
    adjoint is the forward gather) against autograd of the plain gather."""
    _, jtr, ttr = _triplets(3, 400, 10)
    E = ttr.senders.shape[0]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(E, 5)).astype(np.float32)
    ct = rng.normal(size=(E * 10, 5)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jt.expand_kj(a, jtr), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tt.expand_kj(xt, ttr)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(ct))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(vjp(
        jnp.asarray(ct))[0]), rtol=1e-6, atol=1e-6)

    def plain(a):
        return torch.where(ttr.mask[:, None], a[ttr.idx_kj.long()], 0)
    res = []
    for fn in (lambda a: tt.expand_kj(a, ttr), plain):
        a = torch.tensor(x, requires_grad=True)
        (g,) = torch.autograd.grad(torch.sum(fn(a) ** 3), a,
                                   create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g * torch.tensor(x)), a)
        res.append(h.numpy())
    assert np.abs(res[1]).max() > 0
    np.testing.assert_allclose(res[0], res[1], rtol=1e-5, atol=1e-5)


def _geometry(mod, pos, trip):
    return (mod.edge_distances(pos, trip.senders, trip.receivers,
                               trip.edge_mask),
            mod.triplet_geometry(pos, trip),
            mod.triplet_kj_distances(pos, trip),
            mod.torsion_angles(pos, trip))


GEOM = ("dist", "angle", "dist_kj", "torsion")


def test_geometry_and_its_gradient_match_jax():
    pos, jtr, ttr = _triplets(5, 400, 12)
    want = _geometry(jt, jnp.asarray(pos), jtr)
    p = torch.tensor(pos, requires_grad=True)
    got = _geometry(tt, p, ttr)
    for name, a, b in zip(GEOM, got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert float(got[3].detach().max()) > 0
    w = [np.random.default_rng(6).normal(size=a.shape).astype(np.float32)
         for a in got]

    def j_obj(q):
        return sum(jnp.sum(jnp.asarray(wi) * a)
                   for wi, a in zip(w, _geometry(jt, q, jtr)))
    g_j = np.asarray(jax.grad(j_obj)(jnp.asarray(pos)))
    (g_t,) = torch.autograd.grad(
        sum(torch.sum(torch.tensor(wi) * a) for wi, a in zip(w, got)), p)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5, atol=1e-5)


def test_flat_torsion_finite_at_both_derivative_levels():
    """Padding edges (node 0 to node 0) and empty in-edge slots stay
    finite through a force-like double backward."""
    pos, _, ttr = _triplets(7, 400, 12)
    assert not bool(ttr.edge_mask.all())            # padding rows present
    p = torch.tensor(pos, requires_grad=True)
    e = sum(torch.sum(torch.sin(a)) for a in _geometry(tt, p, ttr))
    (f,) = torch.autograd.grad(e, p, create_graph=True)
    (h,) = torch.autograd.grad(torch.sum(f * f), p)
    assert torch.isfinite(f).all() and torch.isfinite(h).all()
    assert float(h.abs().max()) > 0
