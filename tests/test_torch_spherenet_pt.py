"""Port's SphereNet / DimeNet++ on the [N, K] table with the packed basis
(``pallas_triplet`` and ``pallas_fuse_basis`` without the slot kernel:
``basis_pt`` once per forward, ``fused_triplet_pt`` over ``expand_kj_raw``
rows in every layer) vs the JAX package's, on the CPU.

Configurations: SphereNet and DimeNet++ on the unblocked table
(``block_size=0``, flat batches), and SphereNet on the blocked table with
``pallas_slot`` off (slots of 10 atoms). Flax weights go into the port with
``spherenet_from_flax``; the JAX models run their Pallas kernels in
interpret mode, the port its plain versions. Inputs: ``MoleculeLoader``
batches of seeded synthetic molecules (5-10 atoms in a 6 A box, forces
included), 2 layers x 32, K = 8.

Tolerances: float32 energies 1e-4 (sums in another order through 2
layers); one energy+force Adam step 1e-3 for the loss and the parameters
and for the gradients relative to each parameter's largest gradient entry
(two derivative levels, the loss scaled by p = 100, Adam's division by
the root of the second moment), as ``tests/test_torch_spherenet_nk.py``.
"""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.models import DimeNetPP as JDimeNetPP
from dig_tpu.models import SphereNet as JSphereNet
from dig_tpu.train import make_step_fns as j_make_step_fns
from dig_tpu.train.trainer import TrainState
from dig_tpu_torch.convert import spherenet_from_flax
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.models import DimeNetPP as TDimeNetPP
from dig_tpu_torch.models import SphereNet as TSphereNet
from dig_tpu_torch.train import make_step_fns

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8)
PT = dict(pallas_triplet=True, pallas_fuse_basis=True)
MODELS = {"SphereNet": (JSphereNet, TSphereNet),
          "DimeNetPP": (JDimeNetPP, TDimeNetPP)}
CASES = {"spherenet_unblocked": ("SphereNet", 0),
         "dimenetpp_unblocked": ("DimeNetPP", 0),
         "spherenet_blocked": ("SphereNet", A)}
P = 100.0
TOL = 1e-3


def _batches(block, seed=3, n=8, batch_size=4):
    mols = synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=A,
                               box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    slot = dict(slot_size=A) if block else {}
    jl = JLoader(mols, batch_size, shuffle=True, seed=seed, **slot)
    tl = TLoader(mols, batch_size, shuffle=True, seed=seed, device="cpu",
                 **slot)
    return list(jl), list(tl)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _params(case):
    name, block = CASES[case]
    (jb, _), _ = _batches(block)
    return jax.jit(MODELS[name][0](**KW, block_size=block).init)(
        jax.random.PRNGKey(0), jb)


def _port(case, flat):
    name, block = CASES[case]
    tm = spherenet_from_flax(flat, MODELS[name][1](
        device="cpu", **KW, block_size=block, **PT))
    assert tm.pt_fused and not (tm.slot_fused or tm.product_fused)
    return tm


@pytest.mark.parametrize("case", list(CASES))
def test_energies_match_jax(case):
    name, block = CASES[case]
    (jb, _), (tb, _) = _batches(block)
    params = _params(case)
    want = np.asarray(jax.jit(MODELS[name][0](**KW, block_size=block,
                                              **PT).apply)(params, jb))
    got = _port(case, _flat(params["params"]))(tb).detach().numpy()
    assert got.shape == want.shape == (4, 1)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_force_adam_step_matches_jax(case):
    """One energy+force Adam step (the second-order tower through the
    packed basis): loss terms, gradients and updated parameters."""
    name, block = CASES[case]
    JM, TM = MODELS[name]
    (_, jb), (_, tb) = _batches(block, seed=5)
    params = _params(case)
    jm = JM(**KW, block_size=block, **PT)
    opt = optax.adam(5e-4)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=jnp.zeros((), jnp.int32))
    step_j, _ = j_make_step_fns(jm, opt, energy_and_force=True, p=P,
                                loss="l1", donate=False)
    new_state, aux_j = step_j(state, jb)
    tm = _port(case, _flat(params["params"]))
    step_t, eval_t = make_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=5e-4),
        energy_and_force=True, p=P, loss="l1")
    aux_t = step_t(tb)
    assert set(aux_t) == set(aux_j)
    for key, want in aux_j.items():
        _close(float(aux_t[key]), float(want), TOL, key)
    p_ref = _port(case, _flat(new_state.params["params"]))
    for (pname, p), q in zip(tm.named_parameters(), p_ref.parameters()):
        assert p.grad is not None and float(p.grad.abs().max()) > 0, pname
        _close(p.detach().numpy(), q.detach().numpy(), TOL, pname)
    out = eval_t(tb)
    assert torch.isfinite(out["force_pred"]).all()
    assert float(out["force_pred"].abs().max()) > 0
