"""Port's unblocked [N, K] radius graph (``radius_graph_nk``), its triplet
tables and the raw block gather ``expand_kj_raw`` vs the JAX package's,
on the CPU.

Inputs: flat ``MoleculeLoader`` batches (no slots) of seeded synthetic
molecules of 12-29 atoms in a 6 A box, whose in-degrees exceed K = 8 and
16, so the top-k truncation and the symmetrisation both drop pairs.
Tolerances: integer and boolean tables bit-equal; the gather and its
adjoints to the second order 1e-5 of the largest reference value (the
same sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.ops import radius as jradius
from dig_tpu.ops import triplets as jtrip
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.ops import radius as tradius
from dig_tpu_torch.ops import triplets as ttrip

CUTOFF = 5.0


def _graphs(K, seed=0):
    mols = synthetic_molecules(12, seed=seed, min_atoms=12, max_atoms=29,
                               box=6.0)
    jb = next(iter(JLoader(mols, 6, shuffle=True, seed=seed)))
    tb = next(iter(TLoader(mols, 6, shuffle=True, seed=seed, device="cpu")))
    jg = jax.jit(jradius.radius_graph_nk, static_argnums=(3, 4))(
        jb.nodes["pos"], jb.node_graph, jb.node_mask, CUTOFF, K)
    tg = tradius.radius_graph_nk(tb.nodes["pos"], tb.node_graph, tb.node_mask,
                                 CUTOFF, K)
    return jb, tb, jg, tg


@pytest.mark.parametrize("K", [8, 16])
def test_radius_and_triplet_tables_equal(K):
    jb, tb, jg, tg = _graphs(K)
    for f in jg._fields:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    jt, tt = jax.jit(jtrip.build_triplets_nk)(jg), ttrip.build_triplets_nk(tg)
    for f in jt._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert np.array_equal(a, b), f
    # the case is truncated and symmetrised: the top-k keeps fewer than
    # the in-cutoff pairs, and the symmetrisation masks some kept slots
    d2, valid = tradius._pairwise_same_graph(tb.nodes["pos"], tb.node_graph,
                                             tb.node_mask)
    deg = (valid & (d2 < CUTOFF ** 2)).sum(dim=1)
    in_topk = int(deg.clamp(max=K).sum())
    assert in_topk < int(deg.sum())
    assert int(tg.edge_mask.sum()) < in_topk


def test_symmetrised_graph_is_mutual():
    """Every kept edge j -> i has its reverse kept, at rev_edge."""
    _, _, _, tg = _graphs(8, seed=1)
    N, K = tg.nbr_idx.shape
    e = torch.nonzero(tg.edge_mask).reshape(-1)
    rev = tg.rev_edge.reshape(-1)[e].long()
    assert bool(tg.edge_mask[rev].all())
    assert torch.equal(tg.senders[rev].long(), e // K)
    assert torch.equal(rev // K, tg.senders[e].long())


def _trip_pair(K=8):
    _, _, jg, tg = _graphs(K)
    return jax.jit(jtrip.build_triplets_nk)(jg), ttrip.build_triplets_nk(tg)


def test_expand_kj_raw_to_second_order():
    """Forward rows everywhere (garbage included), the adjoint (mask-free in
    its cotangent, over the mutual slots) and the adjoint's adjoint, against
    the JAX closed pair."""
    jt, tt = _trip_pair()
    N, K = tt.nk_nbr.shape
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N * K, 5)).astype(np.float32)
    ct = rng.normal(size=(N * K * K, 5)).astype(np.float32)
    w = rng.normal(size=(N * K, 5)).astype(np.float32)

    def j_f(xv):
        return jtrip.expand_kj_raw(xv, jt)

    out_j, vjp = jax.vjp(j_f, jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(ct))
    # second order: d/d ct of <adjoint(ct), w> is the raw gather of w
    g2_j = jax.grad(lambda c: jnp.sum(vjp(c)[0] * w))(jnp.asarray(ct))

    xt = torch.tensor(x, requires_grad=True)
    out_t = ttrip.expand_kj_raw(xt, tt)
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    ctt = torch.tensor(ct, requires_grad=True)
    (g_t,) = torch.autograd.grad(out_t, xt, ctt, create_graph=True)
    (g2_t,) = torch.autograd.grad((g_t * torch.tensor(w)).sum(), ctt)
    for a, b in ((g_t.detach(), g_j), (g2_t, g2_j)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_expand_kj_raw_matches_expand_kj_where_masked():
    """At real triplets the raw gather equals expand_kj, and with a
    cotangent that is zero at masked triplets the two adjoints agree."""
    _, tt = _trip_pair(16)
    N, K = tt.nk_nbr.shape
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(N * K, 4)).astype(np.float32),
                     requires_grad=True)
    ct = torch.where(tt.mask[:, None],
                     torch.tensor(rng.normal(size=(N * K * K, 4))
                                  .astype(np.float32)), 0)
    raw, masked = ttrip.expand_kj_raw(x, tt), ttrip.expand_kj(x, tt)
    assert torch.equal(torch.where(tt.mask[:, None], raw, 0), masked)
    (g_raw,) = torch.autograd.grad(raw, x, ct)
    (g_masked,) = torch.autograd.grad(masked, x, ct)
    torch.testing.assert_close(g_raw, g_masked, rtol=1e-6, atol=1e-6)
