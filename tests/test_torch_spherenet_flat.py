"""Port's SphereNet / DimeNet++ on the flat layout (``nk_degree=0``: the
compacted radius graph, ``build_triplets``, the unfused triplet chain,
``UpdateV`` through the sorted-CSR segment sum when ``segment_eb > 0``) vs
the JAX package's, on the CPU.

Flax weights go into the port with ``spherenet_from_flax`` (the flat model
has the slot model's parameters). Inputs: one or two ``MoleculeLoader``
batches of seeded synthetic molecules (5-10 atoms in a 6 A box, forces
included), 2 layers x 32, every in-cutoff pair kept (``max_edges`` and
``max_in_degree`` above what the batches need).

Tolerances: float32 energies 1e-4 and energy gradients 1e-4 (sums in
another order through 2 layers); one energy+force Adam step 1e-3 (loss,
gradients, parameters, as PR 3's ``tests/test_torch_force.py``: two
derivative levels, the loss scaled by p = 100).
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
from dig_tpu.train import make_train_state
from dig_tpu.train.trainer import _masked_mean
from dig_tpu_torch.convert import spherenet_from_flax
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.models import DimeNetPP as TDimeNetPP
from dig_tpu_torch.models import SphereNet as TSphereNet
from dig_tpu_torch.train import make_step_fns

KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, max_edges=384,
          max_in_degree=10)
EB = 256            # covers the densest 32 receiver rows + 127 slack
MODELS = {"SphereNet": (JSphereNet, TSphereNet),
          "DimeNetPP": (JDimeNetPP, TDimeNetPP)}
P = 100.0


def _batches(seed=3, n=8, batch_size=4):
    mols = synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=10,
                               box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    jl = JLoader(mols, batch_size, shuffle=True, seed=seed)
    tl = TLoader(mols, batch_size, shuffle=True, seed=seed, device="cpu")
    return list(jl), list(tl)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _port(TM, flat, segment_eb=EB):
    return spherenet_from_flax(flat, TM(device="cpu", segment_eb=segment_eb,
                                        **KW))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("segment_eb", [0, EB])
@pytest.mark.parametrize("name", ["SphereNet", "DimeNetPP"])
def test_energies_and_gradients_match_jax(name, segment_eb):
    JM, TM = MODELS[name]
    (jb, _), (tb, _) = _batches()
    jm = JM(segment_eb=segment_eb, **KW)
    params = jm.init(jax.random.PRNGKey(0), jb)

    def energy(p):
        return jnp.sum(jnp.where(jb.graph_mask[:, None], jm.apply(p, jb),
                                 0.0))
    e_j = np.asarray(jm.apply(params, jb))
    g_j = _flat(jax.grad(energy)(params)["params"])
    tm = _port(TM, _flat(params["params"]), segment_eb)
    e_t = tm(tb)
    assert e_t.shape == e_j.shape == (4, 1)
    _close(e_t.detach().numpy(), e_j, 1e-4, "energies")
    torch.sum(torch.where(tb.graph_mask[:, None], e_t, 0.0)).backward()
    g_ref = _port(TM, g_j)
    for (pname, p), g in zip(tm.named_parameters(), g_ref.parameters()):
        _close(p.grad.numpy(), g.detach().numpy(), 1e-4, pname)


@functools.lru_cache(maxsize=None)
def _jax_force_step(name):
    """One Adam step of the JAX make_step_fns(energy_and_force=True): the
    initial parameters, the aux dict, the gradients and the updated
    parameters (flat flax trees)."""
    JM = MODELS[name][0]
    jbs, _ = _batches(seed=5)
    jm = JM(segment_eb=EB, **KW)
    opt = optax.adam(5e-4)
    state = make_train_state(jm, opt, jbs[0], seed=2)
    step_j, _ = j_make_step_fns(jm, opt, energy_and_force=True, p=P,
                                loss="l1", donate=False)

    def loss(params, g):                 # the JAX trainer's compute_loss
        def esum(pos):
            e = jm.apply(params, g.replace(nodes={**g.nodes, "pos": pos}))
            return jnp.sum(jnp.where(g.graph_mask[:, None], e, 0.0)), e
        (_, e), gpos = jax.value_and_grad(esum, has_aux=True)(g.nodes["pos"])
        e_loss = _masked_mean(jnp.abs(e - g.globals["y"]), g.graph_mask)
        f_loss = _masked_mean(jnp.abs(-gpos - g.nodes["force"]), g.node_mask)
        return e_loss + P * f_loss
    init = _flat(state.params["params"])
    grads = _flat(jax.jit(jax.grad(loss))(state.params, jbs[0])["params"])
    state, aux = step_j(state, jbs[0])
    return (init, {k: float(v) for k, v in aux.items()}, grads,
            _flat(state.params["params"]))


@pytest.mark.parametrize("name", ["SphereNet", "DimeNetPP"])
def test_force_step_matches_jax(name):
    init, aux_j, grads_j, params_j = _jax_force_step(name)
    TM = MODELS[name][1]
    _, tbs = _batches(seed=5)
    tm = _port(TM, init)
    step_t, eval_t = make_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=5e-4),
        energy_and_force=True, p=P, loss="l1")
    aux_t = step_t(tbs[0])
    for key, want in aux_j.items():
        _close(float(aux_t[key]), want, 1e-3, key)
    g_ref, p_ref = _port(TM, grads_j), _port(TM, params_j)
    for (pname, p), g, q in zip(tm.named_parameters(), g_ref.parameters(),
                                p_ref.parameters()):
        _close(p.grad.numpy(), g.detach().numpy(), 1e-3, f"grad {pname}")
        _close(p.detach().numpy(), q.detach().numpy(), 1e-3, pname)
    out = eval_t(tbs[1])
    assert torch.isfinite(out["force_pred"]).all()
    assert float(out["force_pred"].abs().max()) > 0


def test_pallas_flags_fall_back_on_the_flat_layout():
    """As in the JAX model, the pallas_* flags do not apply to the flat
    layout: the unfused chain runs and gives the same energies."""
    (_, _), (tb, _) = _batches()
    gen = lambda: torch.Generator().manual_seed(1)
    plain = TSphereNet(device="cpu", generator=gen(), **KW)
    flagged = TSphereNet(device="cpu", generator=gen(), pallas_triplet=True,
                         **KW)
    assert not flagged.slot_fused
    np.testing.assert_array_equal(flagged(tb).detach().numpy(),
                                  plain(tb).detach().numpy())
