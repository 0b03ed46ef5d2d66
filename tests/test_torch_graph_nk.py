"""Port's slot-aligned batches, NK radius graph, triplet tables, geometry
and basis tables vs the JAX package's, float32 on the CPU.

Inputs come from numpy seeds (``synthetic_molecules``) and pass between
the two frameworks as numpy arrays. Tolerances:

* batches and integer/boolean tables: bit-identical;
* geometry values: 1e-5 absolute (float32, the same expressions in
  another library);
* position gradients: 1e-5 of the largest gradient entry (float32 sums
  over the closed gathers in another order);
* basis tables: 1e-5 relative and absolute (the same sympy expressions
  lambdified to another library), 1e-4 for the Bessel rows: the closed
  forms of j_l (l >= 1) cancel terms of order 1/x^l near 0, which
  magnifies float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.ops import basis as jbasis
from dig_tpu.ops import radius as jradius
from dig_tpu.ops import segment as jsegment
from dig_tpu.ops import triplets as jtrip
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.graph import pad_to_next_power
from dig_tpu_torch.ops import basis as tbasis
from dig_tpu_torch.ops import radius as tradius
from dig_tpu_torch.ops import segment as tsegment
from dig_tpu_torch.ops import triplets as ttrip

CUTOFF, A = 5.0, 29


def _mols(n=12, seed=0):
    # box 6.0 with up to 29 atoms: in-degrees above K, so the top-k
    # truncation and the symmetrisation both drop pairs
    return synthetic_molecules(n, seed=seed, min_atoms=12, max_atoms=A,
                               box=6.0)


def _batches(batch_size=6, seed=0, **kw):
    mols = _mols()
    jb = next(iter(JLoader(mols, batch_size, shuffle=True, seed=seed, **kw)))
    tb = next(iter(TLoader(mols, batch_size, shuffle=True, seed=seed,
                           device="cpu", **kw)))
    return jb, tb


def _graphs(K, seed=0):
    jb, tb = _batches(seed=seed, slot_size=A)
    jg = jradius.radius_graph_nk_blocked(jb.nodes["pos"], jb.node_mask,
                                         CUTOFF, K, A,
                                         node_graph=jb.node_graph)
    tg = tradius.radius_graph_nk_blocked(tb.nodes["pos"], tb.node_mask,
                                         CUTOFF, K, A,
                                         node_graph=tb.node_graph)
    return jb, tb, jg, tg


@pytest.mark.parametrize("slot_size", [None, A])
def test_molecule_loader_batches_bit_identical(slot_size):
    mols = _mols()
    jl = JLoader(mols, 5, shuffle=True, seed=3, slot_size=slot_size)
    tl = TLoader(mols, 5, shuffle=True, seed=3, slot_size=slot_size,
                 device="cpu")
    assert len(jl) == len(tl)
    for _ in range(2):                       # two epochs: the reshuffle too
        for jb, tb in zip(jl, tl):
            for f in ("senders", "receivers", "node_graph", "node_mask",
                      "edge_mask", "graph_mask", "n_node", "n_edge"):
                a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            for part in ("nodes", "globals"):
                jd, td = getattr(jb, part), getattr(tb, part)
                assert sorted(jd) == sorted(td)
                for k in jd:
                    a, b = np.asarray(jd[k]), td[k].numpy()
                    assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("K", [8, 16])
def test_radius_and_triplet_tables_equal(K):
    jb, tb, jg, tg = _graphs(K)
    for f in jg._fields:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    jt, tt = jtrip.build_triplets_nk(jg), ttrip.build_triplets_nk(tg)
    for f in jt._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert np.array_equal(a, b), f
    d_j = int(jradius.radius_blocked_dropped(jb.nodes["pos"], jb.node_graph,
                                             jb.node_mask, CUTOFF, A))
    d_t = int(tradius.radius_blocked_dropped(tb.nodes["pos"], tb.node_graph,
                                             tb.node_mask, CUTOFF, A))
    assert d_j == d_t == 0                   # slot-aligned: nothing crosses


@pytest.mark.parametrize("name", ["nk_edge_distances",
                                  "triplet_kj_distances",
                                  "triplet_geometry", "torsion_angles"])
def test_geometry_and_position_gradients(name):
    _, tb, jg, tg = _graphs(16)
    jt, tt = jtrip.build_triplets_nk(jg), ttrip.build_triplets_nk(tg)
    jf, tf = getattr(jtrip, name), getattr(ttrip, name)
    pos_np = tb.nodes["pos"].numpy()
    want = np.asarray(jf(jnp.asarray(pos_np), jt))
    w = np.random.default_rng(0).normal(size=want.shape).astype(np.float32)
    g_want = np.asarray(jax.grad(lambda p: jnp.sum(jf(p, jt) * w))(
        jnp.asarray(pos_np)))
    pos = torch.tensor(pos_np, requires_grad=True)
    got = tf(pos, tt)
    g_got, = torch.autograd.grad((got * torch.tensor(w)).sum(), pos)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(g_got.numpy() - g_want).max() <= 1e-5 * np.abs(g_want).max()


def test_basis_tables_on_a_grid():
    """n = 3 (the slot paths) and the tables DimeNet++ builds at its
    published n = 7, k = 6 (Bessel and Y_l^0). At n = 7 the closed forms of
    j_l up to l = 6 cancel terms of order 1/x^7 near x = 0.05 in float32
    (the two libraries round them differently, 4.8e-4 of the table's
    largest value on this grid), so the n = 7 Bessel table is held to 1e-3
    of its largest value."""
    x = np.linspace(0.05, 1.0, 40, dtype=np.float32)
    th = np.linspace(0.0, np.pi, 40, dtype=np.float32)
    ph = np.linspace(0.0, 2 * np.pi, 40, dtype=np.float32)
    n, k = 3, 6
    cases = [
        (jbasis.bessel_table(n, k, x),
         tbasis.bessel_table(n, k, torch.tensor(x)), 1e-4, 1e-4),
        (jbasis.sph_m0_table(n, th),
         tbasis.sph_m0_table(n, torch.tensor(th)), 1e-5, 1e-5),
        (jbasis.sph_full_table(n, th, ph),
         tbasis.sph_full_table(n, torch.tensor(th), torch.tensor(ph)), 1e-5,
         1e-5),
        (jbasis.Envelope(5)(x), tbasis.Envelope(5)(torch.tensor(x)), 1e-5,
         1e-5),
    ]
    b7 = np.asarray(jbasis.bessel_table(7, 6, x))
    cases += [
        (b7, tbasis.bessel_table(7, 6, torch.tensor(x)), 1e-4,
         1e-3 * np.abs(b7).max()),
        (jbasis.sph_m0_table(7, th), tbasis.sph_m0_table(7, torch.tensor(th)),
         1e-5, 1e-5),
    ]
    for want, got, rtol, atol in cases:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("which", ["nk_gather_nodes", "expand_kj"])
def test_closed_gather_adjoint_equals_plain_gradient(which):
    """The gather-over-rev_edge adjoint equals autograd's scatter-add of the
    plain gather when the cotangent is zero at invalid slots."""
    _, _, _, tg = _graphs(16)
    trip = ttrip.build_triplets_nk(tg)
    N, K = trip.nk_nbr.shape
    rng = np.random.default_rng(1)
    if which == "nk_gather_nodes":
        x = torch.tensor(rng.normal(size=(N, 5)).astype(np.float32),
                         requires_grad=True)
        out = ttrip.nk_gather_nodes(x, trip)
        plain = x[trip.senders.long()]
        valid = trip.edge_mask
    else:
        x = torch.tensor(rng.normal(size=(N * K, 5)).astype(np.float32),
                         requires_grad=True)
        out = ttrip.expand_kj(x, trip)
        plain = torch.where(trip.mask[:, None], x[trip.idx_kj.long()], 0)
        valid = trip.mask
    ct = torch.tensor(rng.normal(size=out.shape).astype(np.float32))
    ct = torch.where(valid[:, None], ct, 0)
    torch.testing.assert_close(torch.where(valid[:, None], out, 0),
                               torch.where(valid[:, None], plain, 0))
    g_closed, = torch.autograd.grad(out, x, ct)
    g_plain, = torch.autograd.grad(plain, x, ct)
    torch.testing.assert_close(g_closed, g_plain, rtol=1e-5, atol=1e-5)


def test_graph_batch_with_edges_counts_like_jax():
    """The NK edge table attached to a batch: the same per-graph edge
    counts as the JAX ``with_edges``; the replace helpers keep the rest."""
    jb, tb, jg, tg = _graphs(16)
    j2 = jb.with_edges(jg.senders, jg.receivers, jg.edge_mask)
    t2 = tb.with_edges(tg.senders, tg.receivers, tg.edge_mask)
    assert np.array_equal(np.asarray(j2.n_edge), t2.n_edge.numpy())
    assert t2.num_edges == t2.senders.shape[0] == t2.edge_mask.shape[0]
    t3 = t2.replace_globals(e=t2.globals["y"][:, :1]).replace_nodes(
        pos=t2.nodes["pos"] * 2)
    assert torch.equal(t3.nodes["z"], tb.nodes["z"])
    assert torch.equal(t3.globals["e"][:, 0], tb.globals["y"][:, 0])
    assert (t3.num_nodes, t3.num_graphs) == (tb.num_nodes, tb.num_graphs)


def test_segment_sum_and_pad_to_next_power():
    rng = np.random.default_rng(4)
    data = rng.normal(size=(30, 3)).astype(np.float32)
    ids = rng.integers(0, 7, size=30).astype(np.int32)
    mask = rng.random(30) > 0.3
    want = np.asarray(jsegment.segment_sum(jnp.asarray(data),
                                           jnp.asarray(ids), 7,
                                           mask=jnp.asarray(mask)))
    got = tsegment.segment_sum(torch.tensor(data), torch.tensor(ids), 7,
                               mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert [pad_to_next_power(v) for v in (1, 8, 9, 100)] == [8, 8, 16, 128]
