"""Port's SchNetDense and bucketed dense train step vs the JAX package's.

Flax weights are carried into the port with ``schnet_dense_from_flax``;
both run float32 on the CPU (the JAX cfconv in Pallas interpret mode).
Energies match to 1e-4, and after two Adam steps of the ``bench.py``
bucketed L1 step the loss, gradients and parameters match to 2e-4
(float32 sums in another order, amplified through 2 layers).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu.datasets import BucketedDenseMoleculeLoader as JLoader
from dig_tpu.datasets import DenseMoleculeLoader as JDenseLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.models import SchNetDense as JSchNetDense
from dig_tpu_torch.convert import schnet_dense_from_flax
from dig_tpu_torch.datasets import BucketedDenseMoleculeLoader as TLoader
from dig_tpu_torch.datasets import DenseMoleculeLoader as TDenseLoader
from dig_tpu_torch.models import SchNetDense as TSchNetDense
from dig_tpu_torch.train import make_dense_step_fns

KW = dict(cutoff=3.0, num_layers=2, hidden_channels=16, num_filters=16,
          num_gaussians=8)
COUNTS = {8: 3, 12: 4}


def _batches(seed=0):
    mols = synthetic_molecules(40, seed=seed, min_atoms=4, max_atoms=12,
                               box=4.0)
    jb = next(iter(JLoader(mols, COUNTS, max_per_slot=2, shuffle=True,
                           seed=seed)))
    tb = next(iter(TLoader(mols, COUNTS, max_per_slot=2, shuffle=True,
                           seed=seed, device="cpu")))
    return jb, tb


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _pair(use_kernel, example, seed=0):
    jm = JSchNetDense(use_pallas=use_kernel, **KW)
    params = jm.init(jax.random.PRNGKey(seed), example)
    tm = TSchNetDense(use_kernel=use_kernel, device="cpu", **KW)
    schnet_dense_from_flax(_flat(params["params"]), tm)
    return jm, params, tm


@pytest.mark.parametrize("use_kernel", [True, False])
def test_energies_match_packed_readout(use_kernel):
    jb, tb = _batches()
    jm, params, tm = _pair(use_kernel, jb[8])
    for k in COUNTS:
        e_j = np.asarray(jm.apply(params, jb[k]))
        e_t = tm(tb[k]).detach().numpy()
        assert e_t.shape == e_j.shape == (COUNTS[k], 2, 1)
        np.testing.assert_allclose(e_t, e_j, rtol=1e-4, atol=1e-4)


def test_energies_match_unpacked_and_branches_agree():
    mols = synthetic_molecules(5, seed=3, max_atoms=10)
    jb = next(iter(JDenseLoader(mols, 5, n_max=10)))
    tb = next(iter(TDenseLoader(mols, 5, n_max=10, device="cpu")))
    jm, params, tm = _pair(False, jb, seed=1)
    e_j = np.asarray(jm.apply(params, jb))
    np.testing.assert_allclose(tm(tb).detach().numpy(), e_j, rtol=1e-4,
                               atol=1e-4)
    tm.use_kernel = True            # one parameter set serves both branches
    np.testing.assert_allclose(tm(tb).detach().numpy(), e_j, rtol=1e-4,
                               atol=1e-4)


def test_convert_rejects_incomplete_tree():
    jb, _ = _batches()
    params = JSchNetDense(use_pallas=True, **KW).init(jax.random.PRNGKey(0),
                                                      jb[8])
    flat = _flat(params["params"])
    tm = TSchNetDense(use_kernel=True, device="cpu", **KW)
    extra = dict(flat, stray=np.zeros(1))
    with pytest.raises(KeyError, match="unused"):
        schnet_dense_from_flax(extra, tm)
    del flat["Dense_0/kernel"]
    with pytest.raises(KeyError, match="Dense_0/kernel"):
        schnet_dense_from_flax(flat, tm)


def _jax_bench_step(model, keys, opt):
    """The step of bench.py:787-800."""
    def train_step(params, opt_state, b):
        def loss_fn(p):
            num = den = 0.0
            for k in keys:
                e = model.apply(p, b[k])
                y = b[k].globals["y"][..., :1]
                mm = b[k].globals["mol_mask"][..., None]
                num += jnp.sum(jnp.abs(e - y) * mm)
                den += jnp.sum(mm)
            return num / jnp.maximum(den, 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads
    return jax.jit(train_step)


def test_bucketed_train_step_matches_bench_step():
    jb, tb = _batches(seed=1)
    jm, params, tm = _pair(True, jb[8], seed=2)
    opt = optax.adam(5e-4)
    opt_state = opt.init(params)
    step_j = _jax_bench_step(jm, sorted(jb), opt)
    t_opt = torch.optim.Adam(tm.parameters(), lr=5e-4)
    step_t, eval_t = make_dense_step_fns(tm, t_opt, loss="l1")
    for _ in range(2):
        params, opt_state, loss_j, grads_j = step_j(params, opt_state, jb)
        loss_t = step_t(tb)["loss"]
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4,
                                   atol=2e-4)
        want_g = schnet_dense_from_flax(
            _flat(grads_j["params"]),
            TSchNetDense(use_kernel=True, device="cpu", **KW))
        want_p = schnet_dense_from_flax(
            _flat(params["params"]),
            TSchNetDense(use_kernel=True, device="cpu", **KW))
        for (name, p), g_ref, p_ref in zip(tm.named_parameters(),
                                          want_g.parameters(),
                                          want_p.parameters()):
            np.testing.assert_allclose(p.grad.numpy(), g_ref.detach().numpy(),
                                       rtol=2e-4, atol=2e-4, err_msg=name)
            np.testing.assert_allclose(p.detach().numpy(),
                                       p_ref.detach().numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=name)
    out = eval_t(tb)
    for k in COUNTS:
        e_j = np.asarray(jm.apply(params, jb[k]))
        np.testing.assert_allclose(out[k]["y_pred"].numpy(), e_j, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["einsum", "cfconv"])
def test_forces_match_jax(use_kernel):
    """The counterpart of ``tests/test_dense_parity.py``'s
    ``test_dense_force_gradients``: F = -d(sum E)/dpos of a transplanted
    model (cutoff 3, 2 layers x 16, 8 Gaussians) against the JAX einsum
    model's, through the port's einsum branch and through the cfconv op
    with ``pos_grads=True`` (its plain version here; the backward with the
    distance gradient), 1e-5 of the largest force (float32 sums in another
    order); finite, and 0 on the padding slots."""
    mols = synthetic_molecules(4, seed=1, max_atoms=10)
    jb = next(iter(JDenseLoader(mols, 4, n_max=10)))
    tb = next(iter(TDenseLoader(mols, 4, n_max=10, device="cpu")))
    kw = dict(cutoff=3.0, num_layers=2, hidden_channels=16, num_filters=16,
              num_gaussians=8)
    jm = JSchNetDense(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb)
    f_j = -np.asarray(jax.grad(lambda pos: jnp.sum(
        jm.apply(params, jb.replace(pos=pos))))(jb.pos))
    tm = schnet_dense_from_flax(
        _flat(params["params"]),
        TSchNetDense(use_kernel=use_kernel, pos_grads=True, device="cpu",
                     **kw))
    pos = tb.pos.clone().requires_grad_()
    (g,) = torch.autograd.grad(tm(tb.replace(pos=pos)).sum(), pos)
    f_t = -g.numpy()
    nm = tb.node_mask.numpy()
    assert np.all(np.isfinite(f_t)) and np.abs(f_t).max() > 0
    assert np.all(f_t[~nm] == 0.0)
    np.testing.assert_allclose(f_t, f_j, rtol=0,
                               atol=1e-5 * np.abs(f_j).max())
