"""Port's BucketedMoleculeLoader and bucketed force step vs the JAX
package, on the CPU.

* The loader's batches are bit-identical to the JAX loader's: every node,
  edge and global array and every mask, shuffled over two epochs and
  unshuffled with its padded tail, including a bucket left empty (one
  masked template molecule).
* ``make_bucketed_step_fns`` (one model, one parameter set, applied per
  bucket at its slot size) against the loss of ``bench.py:241-256``
  written in JAX over the same batches: the JAX model per bucket shares
  one parameter tree, as bench.py's ``models[s]`` do. Two Adam steps.
  The loss is a sum over atoms divided by the graph count, so gradients
  run to 1e3: they agree to 1e-4 of each tensor's largest value (float32
  sums in another order through two derivative levels). Loss and
  parameters agree to 1e-3 relative and absolute, the tolerance of
  ``tests/test_torch_force.py`` (Adam's first steps move each parameter
  by about lr = 5e-4 whatever the gradient's size).
"""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu.datasets import BucketedMoleculeLoader as JBucketed
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.models import SphereNet as JSphereNet
from dig_tpu_torch.convert import spherenet_from_flax
from dig_tpu_torch.datasets import BucketedMoleculeLoader as TBucketed
from dig_tpu_torch.models import SphereNet as TSphereNet
from dig_tpu_torch.train import make_bucketed_step_fns

SLOTS = {6: 2, 10: 2}
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8)
SLOT = dict(pallas_triplet=True, pallas_fuse_basis=True, pallas_slot=True)
TOL = 1e-3


def _mols(seed=0, n=12):
    return synthetic_molecules(n, seed=seed, min_atoms=4, max_atoms=10,
                               box=6.0, with_forces=True)


def _assert_same(jb, tb):
    for field in ("senders", "receivers", "node_graph", "node_mask",
                  "edge_mask", "graph_mask", "n_node", "n_edge"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      np.asarray(getattr(jb, field)), field)
    for kind in ("nodes", "edges", "globals"):
        j, t = getattr(jb, kind), getattr(tb, kind)
        assert set(j) == set(t), kind
        for key in j:
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]),
                                          f"{kind}[{key}]")


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_bit_identical(shuffle):
    mols = _mols()
    jl = JBucketed(mols, SLOTS, shuffle=shuffle, seed=3)
    tl = TBucketed(mols, SLOTS, shuffle=shuffle, seed=3, device="cpu")
    for _ in range(2):                               # two epochs
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) > 0
        for jb, tb in zip(jbs, tbs):
            assert list(jb) == list(tb) == sorted(SLOTS)
            for s in SLOTS:
                _assert_same(jb[s], tb[s])


def test_loader_empty_bucket_is_masked_template():
    """Unshuffled, the tail holds only small molecules: the large bucket
    is emitted as one masked template molecule, as in the JAX loader."""
    small = synthetic_molecules(7, seed=1, min_atoms=4, max_atoms=6)
    large = synthetic_molecules(2, seed=2, min_atoms=8, max_atoms=10)
    mols = large[:1] + small + large[1:]
    jbs = list(JBucketed(mols, SLOTS))
    tbs = list(TBucketed(mols, SLOTS, device="cpu"))
    assert len(jbs) == len(tbs) == 4
    for jb, tb in zip(jbs, tbs):
        for s in SLOTS:
            _assert_same(jb[s], tb[s])
    tail = tbs[-1][10]
    assert not tail.graph_mask.any() and not tail.node_mask.any()
    assert int(tail.n_node[0]) == len(large[0]["z"])


def test_loader_rejects_oversized_molecule():
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        TBucketed(_mols(), {6: 2, 8: 2}, device="cpu")


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _bucketed_batches():
    mols = _mols(seed=4, n=16)
    jbs = list(JBucketed(mols, SLOTS, shuffle=True, seed=0))
    tbs = list(TBucketed(mols, SLOTS, shuffle=True, seed=0, device="cpu"))
    return jbs, tbs


@functools.lru_cache(maxsize=None)
def _jax_bucketed_steps(steps):
    """bench.py's force step over the same batches: the loss, gradients and
    updated parameters of each step, from the initial parameters."""
    jbs, _ = _bucketed_batches()
    models = {s: JSphereNet(**KW, block_size=s) for s in SLOTS}
    params = models[10].init(jax.random.PRNGKey(0), jbs[0][10])
    opt = optax.adam(5e-4)
    opt_state = opt.init(params)

    def loss_fn(p, b):                               # bench.py:241-256
        num = den = 0.0
        for s, g in b.items():
            def esum(pos, g=g, s=s):
                g_ = g.replace(nodes={**g.nodes, "pos": pos})
                e = models[s].apply(p, g_)[:, 0]
                return jnp.sum(jnp.where(g.graph_mask, e, 0.0)), e

            (_, e), gpos = jax.value_and_grad(esum, has_aux=True)(
                g.nodes["pos"])
            num += jnp.sum(jnp.abs(e - g.globals["y"][:, 0]) * g.graph_mask)
            num += 100.0 * jnp.sum(jnp.abs(-gpos - g.nodes["force"])
                                   * g.node_mask[:, None])
            den += jnp.sum(g.graph_mask)
        return num / jnp.maximum(den, 1.0)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    init, out = _flat(params["params"]), []
    for b in jbs[:steps]:
        loss, grads = value_and_grad(params, b)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out.append((float(loss), _flat(grads["params"]),
                    _flat(params["params"])))
    return init, out


@pytest.mark.parametrize("flags", [None, SLOT], ids=["unfused", "slot"])
def test_bucketed_force_steps_match_bench_loss(flags):
    _, tbs = _bucketed_batches()
    init, traj = _jax_bucketed_steps(2)
    port = lambda flat: spherenet_from_flax(
        flat, TSphereNet(device="cpu", block_size=10, **KW, **(flags or {})))
    tm = port(init)
    step, eval_step = make_bucketed_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=5e-4), p=100.0)
    close = lambda a, b, msg: np.testing.assert_allclose(
        a, b, rtol=TOL, atol=TOL, err_msg=msg)
    for tb, (loss_j, grads_j, params_j) in zip(tbs, traj):
        close(float(step(tb)["loss"]), loss_j, "loss")
        g_ref, p_ref = port(grads_j), port(params_j)
        for (name, p), g, q in zip(tm.named_parameters(), g_ref.parameters(),
                                   p_ref.parameters()):
            a, b = p.grad.numpy(), g.detach().numpy()
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name
            close(p.detach().numpy(), q.detach().numpy(), name)
    out = eval_step(tbs[0])
    for s, o in out.items():
        assert o["y_pred"].shape == (SLOTS[s], 1)
        assert o["force_pred"].shape == (SLOTS[s] * s, 3)
        assert torch.isfinite(o["force_pred"]).all()
