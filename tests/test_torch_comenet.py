"""The port's ComENet and ComENetOCP against the JAX package's, on the CPU,
on the three layouts: flat (``segment_argmin`` frame picks), NK-blocked
(per-row argmin over the K lanes, ``nk_gather``) and periodic
(``use_pbc``, ``radius_graph_pbc_flat``).

Flax weights go into the port with ``comenet_from_flax``. Inputs: seeded
synthetic molecules of 5-10 atoms in a 6 A box (slots of 10 atoms for the
NK table, K = 9 keeps every pair) and seeded synthetic crystals of 4-12
atoms; 2 blocks x 32 channels, middle 16, one output layer, n = 2,
k = 3. The JAX side is
jitted once per layout.

Tolerances: energies 1e-5 and dE/dpos 1e-5 of the largest entry (float32
sums in another order); one Adam step of energy+force training (the force
loss's double backward through the guarded atan2 and the frame picks),
the loss and the updated parameters 1e-4, the gradients 1e-3 of each
parameter's largest gradient entry (two derivative levels, the force
term scaled by p = 100).
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
from dig_tpu.models import ComENet as JComENet
from dig_tpu.models import ComENetOCP as JComENetOCP
from dig_tpu.train.trainer import _masked_mean
from dig_tpu_torch.convert import comenet_from_flax
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.datasets import synthetic_crystals, synthetic_molecules
from dig_tpu_torch.models import ComENet, ComENetOCP
from dig_tpu_torch.train import energy_force, make_step_fns

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, middle_channels=16,
          num_radial=3, num_spherical=2, num_output_layers=1)
LAYOUTS = {"flat": (dict(max_edges=512), JComENet, ComENet),
           "nk_blocked": (dict(nk_degree=9, block_size=A), JComENet,
                          ComENet),
           "periodic": (dict(cutoff=6.0, max_edges=2048), JComENetOCP,
                        ComENetOCP)}
P = 100.0


@functools.lru_cache(maxsize=None)
def _data(layout):
    if layout == "periodic":
        mols = synthetic_crystals(3, seed=5)
        kw = dict(n_node_pad=36)
    else:
        mols = synthetic_molecules(4, seed=3, min_atoms=5, max_atoms=A,
                                   box=6.0, with_forces=True)
        kw = dict(slot_size=A) if layout == "nk_blocked" else {}
    mols = [dict(m, y=np.asarray(m["y"])[:1],
                 force=m.get("force", np.zeros((len(m["z"]), 3),
                                               np.float32)))
            for m in mols]
    return (next(iter(JLoader(mols, len(mols), **kw))),
            next(iter(TLoader(mols, len(mols), device="cpu", **kw))))


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


@functools.lru_cache(maxsize=None)
def _jax(layout):
    """The JAX model, its parameters, energies and dE/dpos."""
    kw, JM, _ = LAYOUTS[layout]
    jb, _ = _data(layout)
    jm = JM(**{**KW, **kw})
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb)

    def esum(p, pos):
        e = jm.apply(p, jb.replace(nodes={**jb.nodes, "pos": pos}))
        return jnp.sum(jnp.where(jb.graph_mask[:, None], e, 0.0)), e
    (_, e), gpos = jax.jit(jax.value_and_grad(esum, argnums=1,
                                              has_aux=True))(
        params, jb.nodes["pos"])
    return jm, params, np.asarray(e), -np.asarray(gpos)


def _port(layout, params):
    kw, _, TM = LAYOUTS[layout]
    return comenet_from_flax(_flat(params["params"]),
                             TM(device="cpu", **{**KW, **kw}))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_energies_and_forces_match_jax(layout):
    _, params, e_j, f_j = _jax(layout)
    _, tb = _data(layout)
    tm = _port(layout, params)
    e_t, f_t = energy_force(tm, tb, create_graph=False)
    assert e_t.shape == e_j.shape == (tb.num_graphs, 1)
    assert _rel(e_t.detach().numpy(), e_j) < 1e-5
    assert bool(torch.isfinite(f_t).all()) and float(f_t.abs().max()) > 0
    assert _rel(f_t.numpy(), f_j) < 1e-5


def test_layouts_share_parameters():
    shapes = lambda m: {k: v.shape for k, v in m.state_dict().items()}
    base = shapes(ComENet(device="cpu", **KW))
    for kw, _, TM in LAYOUTS.values():
        assert shapes(TM(device="cpu", **{**KW, **kw})) == base


def test_periodic_model_is_the_pbc_flag():
    assert ComENetOCP(device="cpu", **KW).use_pbc
    assert not ComENet(device="cpu", **KW).use_pbc
    assert ComENet(device="cpu", use_pbc=True, **KW).use_pbc


@pytest.mark.parametrize("layout", ["nk_blocked", "periodic"])
def test_force_training_step_matches_jax(layout):
    """One Adam step of |E - y| + 100 |F - F_ref| (the JAX trainer's
    loss, Adam applied with optax): the force loss differentiates the
    frames, the angles and the periodic displacements twice."""
    jm, params, _, _ = _jax(layout)
    jb, tb = _data(layout)

    def loss(p):
        def esum(pos):
            e = jm.apply(p, jb.replace(nodes={**jb.nodes, "pos": pos}))
            return jnp.sum(jnp.where(jb.graph_mask[:, None], e, 0.0)), e
        (_, e), gpos = jax.value_and_grad(esum, has_aux=True)(
            jb.nodes["pos"])
        e_loss = _masked_mean(jnp.abs(e - jb.globals["y"]), jb.graph_mask)
        f_loss = _masked_mean(jnp.abs(-gpos - jb.nodes["force"]),
                              jb.node_mask)
        return e_loss + P * f_loss, {"loss": e_loss + P * f_loss,
                                     "e_loss": e_loss, "f_loss": f_loss}
    (_, aux_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    params_j = optax.apply_updates(params, updates)

    tm = _port(layout, params)
    step_t, _ = make_step_fns(tm, torch.optim.Adam(tm.parameters(), lr=1e-3),
                              energy_and_force=True, p=P, loss="l1")
    aux_t = step_t(tb)
    for key in ("loss", "e_loss", "f_loss"):
        assert abs(float(aux_t[key]) - float(aux_j[key])) <= 1e-4 * max(
            abs(float(aux_j[key])), 1.0), key
    g_ref = _port(layout, grads)
    p_ref = _port(layout, params_j)
    for (name, p), g, q in zip(tm.named_parameters(), g_ref.parameters(),
                               p_ref.parameters()):
        g = g.detach().numpy()
        assert bool(torch.isfinite(p.grad).all()), name
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(g).max(), 1e-6),
                                   err_msg=f"grad {name}")
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
