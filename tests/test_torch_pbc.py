"""The port's periodic radius graph (``ops/pbc.py``) against the JAX
package's, on the CPU.

Batches of seeded ``synthetic_crystals`` (4-12 atoms in cells of 9-12 A)
through both packages' ``MoleculeLoader``. The edge lists are compared in
order, not as sets: senders, receivers and the mask equal exactly; the
displacement vectors and distances to 1e-5 of their largest entry
(products with the cell in another order); so is ``wrap_positions``. The
overflow counts are equal. dE/dpos through the displacements: the
gradient of a seeded function of the edge vectors, 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.ops import pbc as J
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.datasets import synthetic_crystals
from dig_tpu_torch.ops import pbc as T

TOL = 1e-5


def _batches(num=3, seed=0, **kw):
    mols = synthetic_crystals(num, seed=seed, **kw)
    pad = num * 12
    return (next(iter(JLoader(mols, num, n_node_pad=pad))),
            next(iter(TLoader(mols, num, n_node_pad=pad, device="cpu"))))


def _args(g, jax_side):
    names = (g.nodes["pos"], g.globals["cell"], g.node_graph, g.node_mask)
    return [jnp.asarray(np.asarray(a)) for a in names] if jax_side else names


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_offsets_and_wrap_match_jax():
    np.testing.assert_array_equal(T.pbc_offsets(1), J.pbc_offsets(1))
    np.testing.assert_array_equal(T.pbc_offsets(2), J.pbc_offsets(2))
    jb, tb = _batches(seed=1)
    pos, cell, ng, _ = _args(tb, False)
    shifted = pos + 3.0 * cell[ng.long(), 1]        # outside the cell
    got = T.wrap_positions(shifted, cell, ng)
    jp, jc, jng, _ = _args(jb, True)
    want = J.wrap_positions(jnp.asarray(shifted.numpy()), jc, jng)
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("cutoff,max_edges,images", [
    (6.0, 2048, 1), (6.0, 40, 1), (5.0, 4096, 2)],
    ids=["all", "capped", "two_shells"])
def test_edge_lists_equal_in_order(cutoff, max_edges, images):
    jb, tb = _batches(seed=2)
    got = T.radius_graph_pbc_flat(*_args(tb, False), cutoff, max_edges,
                                  images=images)
    want = J.radius_graph_pbc_flat(*_args(jb, True), cutoff, max_edges,
                                   images=images)
    for name in ("senders", "receivers", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.senders.dtype == torch.int32
    assert int(got.edge_mask.sum()) > 0
    assert _rel(got.edge_vec.numpy(), want.edge_vec) < TOL
    assert _rel(got.edge_dist.numpy(), want.edge_dist) < TOL
    over_t = int(T.pbc_overflow(*_args(tb, False), cutoff, max_edges,
                                images=images))
    over_j = int(J.pbc_overflow(*_args(jb, True), cutoff, max_edges,
                                images=images))
    assert over_t == over_j
    assert (over_t > 0) == (max_edges == 40)


def test_position_gradient_through_displacements_matches_jax():
    jb, tb = _batches(seed=4)
    w = np.random.default_rng(0).normal(size=(1024, 3)).astype(np.float32)
    pos, cell, ng, nm = _args(tb, False)
    pos = pos.clone().requires_grad_()
    pg = T.radius_graph_pbc_flat(pos, cell, ng, nm, 6.0, 1024)
    loss = torch.sum(pg.edge_vec * torch.tensor(w)) + torch.sum(
        torch.where(pg.edge_mask, pg.edge_dist, 0.0) ** 2)
    (g_t,) = torch.autograd.grad(loss, pos)
    jp, jc, jng, jnm = _args(jb, True)

    def jloss(p):
        q = J.radius_graph_pbc_flat(p, jc, jng, jnm, 6.0, 1024)
        return jnp.sum(q.edge_vec * w) + jnp.sum(
            jnp.where(q.edge_mask, q.edge_dist, 0.0) ** 2)
    g_j = jax.grad(jloss)(jp)
    assert _rel(g_t.numpy(), g_j) < TOL
