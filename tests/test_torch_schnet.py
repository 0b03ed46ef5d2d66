"""Port's flat SchNet (compacted radius graph, ``segment_eb`` through the
sorted-CSR segment sum) vs the JAX package's, on the CPU.

* Energies of the JAX ``SchNet`` after ``schnet_from_flax``, with and
  without ``segment_eb`` (the port's CSR branch runs the kernel's plain
  version on the CPU; the JAX one takes ``jax.ops.segment_sum`` there).
* Two Adam steps of ``make_step_fns(energy_and_force=True)`` (force =
  -dE/dpos inside the loss, p = 100) against the JAX trainer: loss,
  ``e_loss``, ``f_loss``, gradients and parameters.
* The port's flat SchNet against the port's SchNetDense after moving the
  state dict across (the port's counterpart of
  ``tests/test_dense_parity.py``): energies and forces.
* ``Run3D`` for two tiny epochs with ``energy_and_force=True``: finite
  losses, a checkpoint that restores, and the ``max_edges`` warning.

Inputs: seeded ``synthetic_morse_molecules`` (5-10 atoms, forces included),
2 layers x 16. Tolerances: energies 1e-5 (float32, sums in another order
through 2 layers); the force steps 1e-4 (two derivative levels, the loss
scaled by p = 100, Adam's division by the root of the second moment; PR 3's
SphereNet force test uses 1e-3); flat vs dense 2e-4, as
``tests/test_dense_parity.py`` (the dense layout sums over a padded
``[G, n, n]`` pair table in another order).
"""
import functools
import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_morse_molecules
from dig_tpu.models import SchNet as JSchNet
from dig_tpu.train import make_step_fns as j_make_step_fns
from dig_tpu.train import make_train_state
from dig_tpu.train.trainer import _masked_mean
from dig_tpu_torch.convert import schnet_from_flax
from dig_tpu_torch.datasets import DenseMoleculeLoader as TDenseLoader
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.models import SchNet as TSchNet
from dig_tpu_torch.models import SchNetDense as TSchNetDense
from dig_tpu_torch.ops import segment_csr
from dig_tpu_torch.threed import Run3D, ThreeDEvaluator
from dig_tpu_torch.train import (Checkpointer, energy_force, evaluate,
                                 make_step_fns)

KW = dict(cutoff=5.0, num_layers=2, hidden_channels=16, num_filters=16,
          num_gaussians=8, max_edges=512)
EB = 256            # covers the densest 32 receiver rows + 127 slack
P = 100.0
TOL = 1e-4


def _mols(seed, n):
    mols = synthetic_morse_molecules(n, seed=seed, min_atoms=5, max_atoms=10)
    return [dict(m, y=m["y"][:1]) for m in mols]


def _batches(seed=0, n=8, batch_size=4):
    mols = _mols(seed, n)
    jl = JLoader(mols, batch_size, shuffle=True, seed=seed)
    tl = TLoader(mols, batch_size, shuffle=True, seed=seed, device="cpu")
    return list(jl), list(tl)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _port(flat, segment_eb=0):
    return schnet_from_flax(flat, TSchNet(device="cpu", segment_eb=segment_eb,
                                          **KW))


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("segment_eb", [0, EB])
def test_energies_match_jax(segment_eb):
    jbs, tbs = _batches()
    params = JSchNet(segment_eb=segment_eb, **KW).init(
        jax.random.PRNGKey(0), jbs[0])
    tm = _port(_flat(params["params"]), segment_eb)
    for jb, tb in zip(jbs, tbs):
        want = np.asarray(JSchNet(segment_eb=segment_eb, **KW).apply(params,
                                                                     jb))
        got = tm(tb).detach().numpy()
        assert got.shape == want.shape == (4, 1)
        _close(got, want, tol=1e-5)
    assert segment_csr.launches == 0


@functools.lru_cache(maxsize=None)
def _jax_trajectory(steps=2):
    """Two Adam steps of the JAX trainer with energy_and_force: the initial
    parameters, then per step the aux dict, the gradients and the updated
    parameters; the eval step's energies and forces after the last."""
    jbs, _ = _batches(seed=1)
    jm = JSchNet(**KW)
    opt = optax.adam(1e-3)
    state = make_train_state(jm, opt, jbs[0], seed=2)
    step_j, eval_j = j_make_step_fns(jm, opt, energy_and_force=True, p=P,
                                     loss="l1", donate=False)

    def loss(params, g):                 # the JAX trainer's compute_loss
        def esum(pos):
            e = jm.apply(params, g.replace(nodes={**g.nodes, "pos": pos}))
            return jnp.sum(jnp.where(g.graph_mask[:, None], e, 0.0)), e
        (_, e), gpos = jax.value_and_grad(esum, has_aux=True)(g.nodes["pos"])
        e_loss = _masked_mean(jnp.abs(e - g.globals["y"]), g.graph_mask)
        f_loss = _masked_mean(jnp.abs(-gpos - g.nodes["force"]), g.node_mask)
        return e_loss + P * f_loss
    grad_j = jax.jit(jax.grad(loss))
    init, out = _flat(state.params["params"]), []
    for jb in jbs[:steps]:
        grads = _flat(grad_j(state.params, jb)["params"])
        state, aux = step_j(state, jb)
        out.append(({k: float(v) for k, v in aux.items()}, grads,
                    _flat(state.params["params"])))
    ev = eval_j(state, jbs[0])
    return init, out, (np.asarray(ev["y_pred"]), np.asarray(ev["force_pred"]))


@pytest.mark.parametrize("segment_eb", [0, EB])
def test_two_adam_force_steps_match_jax(segment_eb):
    init, traj, (e_want, f_want) = _jax_trajectory()
    _, tbs = _batches(seed=1)
    tm = _port(init, segment_eb)
    step_t, eval_t = make_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=1e-3),
        energy_and_force=True, p=P, loss="l1")
    for tb, (aux_j, grads_j, params_j) in zip(tbs, traj):
        aux_t = step_t(tb)
        for key, want in aux_j.items():
            _close(float(aux_t[key]), want, key)
        g_ref, p_ref = _port(grads_j), _port(params_j)
        for (name, p), g, q in zip(tm.named_parameters(), g_ref.parameters(),
                                   p_ref.parameters()):
            _close(p.grad.numpy(), g.detach().numpy(), f"grad {name}")
            _close(p.detach().numpy(), q.detach().numpy(), name)
    out = eval_t(tbs[0])
    _close(out["y_pred"].numpy(), e_want, "energies")
    _close(out["force_pred"].numpy(), f_want, "forces")
    assert torch.isfinite(out["force_pred"]).all()


def test_flat_matches_dense_after_transplant():
    """The two layouts share parameter names: a state dict moves across
    unchanged and both compute the same energies and forces."""
    mols = _mols(3, 6)
    flat = next(iter(TLoader(mols, 6, device="cpu")))
    dense = next(iter(TDenseLoader(mols, 6, n_max=10, device="cpu")))
    tm = TSchNet(device="cpu", generator=torch.Generator().manual_seed(4),
                 **KW)
    kw = {k: v for k, v in KW.items() if k != "max_edges"}
    dm = TSchNetDense(device="cpu", **kw)
    dm.load_state_dict(tm.state_dict())
    e_f, f_f = energy_force(tm, flat, create_graph=False)
    pos = dense.pos.clone().requires_grad_()
    e_d = dm(dense.replace(pos=pos))
    (g,) = torch.autograd.grad(e_d.sum(), pos)
    _close(e_f.detach().numpy(), e_d.detach().numpy(), "energies", 2e-4)
    nm = dense.node_mask
    _close(f_f[flat.node_mask].numpy(), -g[nm].numpy(), "forces", 2e-4)


def test_convert_rejects_incomplete_tree():
    jbs, _ = _batches()
    flat = _flat(JSchNet(**KW).init(jax.random.PRNGKey(0), jbs[0])["params"])
    with pytest.raises(KeyError, match="unused"):
        _port(dict(flat, stray=np.zeros(1)))
    del flat["SchNetInteraction_1/Dense_2/kernel"]
    with pytest.raises(KeyError, match="SchNetInteraction_1/Dense_2/kernel"):
        _port(flat)


def test_run3d_energy_and_force_two_epochs(tmp_path, capsys):
    model = TSchNet(device="cpu", segment_eb=EB, **KW)
    res = Run3D().run(_mols(5, 8), _mols(6, 4), _mols(7, 4), model,
                      ThreeDEvaluator(), epochs=2, batch_size=4,
                      vt_batch_size=4, lr=1e-3, lr_decay_step_size=1,
                      energy_and_force=True, p=P, slot_size=10,
                      save_dir=str(tmp_path / "ckpt"), quiet=True,
                      device="cpu")
    assert math.isfinite(res["best_valid"]) and math.isfinite(
        res["best_test"])
    state = Checkpointer(str(tmp_path / "ckpt")).restore()
    fresh = TSchNet(device="cpu", segment_eb=EB,
                    generator=torch.Generator().manual_seed(9), **KW)
    fresh.load_state_dict(state["model"])
    _, eval_step = make_step_fns(fresh, torch.optim.Adam(fresh.parameters()),
                                 energy_and_force=True)
    valid = TLoader(_mols(6, 4), 4, slot_size=10, device="cpu")
    mae = evaluate(eval_step, valid, ThreeDEvaluator())
    assert mae == pytest.approx(res["best_valid"], rel=1e-6)
    assert "WARNING" not in capsys.readouterr().out

    # a cap below the batches' in-cutoff pairs is reported once
    small = TSchNet(device="cpu", segment_eb=EB,
                    **dict(KW, max_edges=16))
    Run3D().run(_mols(5, 4), _mols(6, 4), _mols(7, 4), small,
                ThreeDEvaluator(), epochs=1, batch_size=4, vt_batch_size=4,
                energy_and_force=True, quiet=True, device="cpu")
    out = capsys.readouterr().out
    assert out.count("> model.max_edges=16") == 1
