"""Port's energy+force training (``make_step_fns(energy_and_force=True)``:
force = -dE/dpos inside the loss, so each step differentiates the model
twice) vs the JAX package's, float32, on the CPU.

Flax weights go into the port with ``spherenet_from_flax``. The JAX
trajectory runs the unfused model; the port runs both its branches, the
slot branch through the autograd tower of ``fused_triplet_slot`` (its
plain version on the CPU). Inputs are slot-aligned ``MoleculeLoader``
batches of seeded synthetic molecules with seeded forces.

Tolerance: loss, ``e_loss``, ``f_loss``, gradients, parameters and
predicted forces agree to 1e-3 (relative and absolute). The JAX package
holds its own slot and unfused force gradients to 5e-3
(``tests/test_pallas_triplet_slot.py``); here the sums run in another
order through two derivative levels of two layers, with the loss scaled
by p = 100, and Adam divides by the root of the second moment.
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
from dig_tpu_torch.train import energy_force, make_step_fns

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8,
          block_size=A)
SLOT = dict(pallas_triplet=True, pallas_fuse_basis=True, pallas_slot=True)
MODELS = {"SphereNet": (JSphereNet, TSphereNet),
          "DimeNetPP": (JDimeNetPP, TDimeNetPP)}
P = 100.0
TOL = 1e-3


def _batches(seed=5, n=8, batch_size=4):
    mols = synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=A,
                               box=6.0, with_forces=True)
    jl = JLoader(mols, batch_size, slot_size=A, shuffle=True, seed=seed)
    tl = TLoader(mols, batch_size, slot_size=A, shuffle=True, seed=seed,
                 device="cpu")
    return list(jl), list(tl)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _port(TM, flat, flags=None):
    return spherenet_from_flax(flat, TM(device="cpu", **KW, **(flags or {})))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(name, steps):
    """``steps`` Adam steps of the JAX make_step_fns(energy_and_force=True):
    the initial parameters, then per step the aux dict, the gradients and
    the updated parameters (flat flax trees); the eval step's energies and
    forces on the first batch after the last step."""
    JM = MODELS[name][0]
    jbs, _ = _batches()
    jm = JM(**KW)
    opt = optax.adam(5e-4)
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


@pytest.mark.parametrize("name, flags, steps", [
    ("SphereNet", None, 2), ("SphereNet", SLOT, 2), ("DimeNetPP", SLOT, 1)],
    ids=["spherenet_unfused", "spherenet_slot", "dimenetpp_slot"])
def test_force_adam_steps_match_jax(name, flags, steps):
    init, traj, (e_want, f_want) = _jax_trajectory(name, steps)
    TM = MODELS[name][1]
    _, tbs = _batches()
    tm = _port(TM, init, flags)
    step_t, eval_t = make_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=5e-4),
        energy_and_force=True, p=P, loss="l1")
    for tb, (aux_j, grads_j, params_j) in zip(tbs, traj):
        aux_t = step_t(tb)
        assert set(aux_t) == {"loss", "e_loss", "f_loss"}
        for key, want in aux_j.items():
            _close(float(aux_t[key]), want, key)
        g_ref, p_ref = _port(TM, grads_j), _port(TM, params_j)
        for (pname, p), g, q in zip(tm.named_parameters(),
                                    g_ref.parameters(), p_ref.parameters()):
            _close(p.grad.numpy(), g.detach().numpy(), f"grad {pname}")
            _close(p.detach().numpy(), q.detach().numpy(), pname)
    if steps == len(traj):
        out = eval_t(tbs[0])
        assert set(out) == {"y_pred", "graph_mask", "force_pred",
                            "node_mask"}
        _close(out["y_pred"].numpy(), e_want, "energies")
        _close(out["force_pred"].numpy(), f_want, "forces")


def _bench_like():
    """Four molecules as bench.py's force bench draws them (12-29 atoms in
    a 6 A box, normal-random forces from default_rng(0)), one batch in
    slots of 29 atoms for each framework."""
    mols = synthetic_molecules(4, seed=0, min_atoms=12, max_atoms=29,
                               box=6.0)
    rng = np.random.default_rng(0)
    for m in mols:
        m["force"] = rng.normal(size=m["pos"].shape).astype(np.float32)
    return (next(iter(JLoader(mols, 4, slot_size=29))),
            next(iter(TLoader(mols, 4, slot_size=29, device="cpu"))))


def test_bf16_force_gradient_drift_matches_jax():
    """bf16 force training drifts far from float32 in the JAX package too.

    At the force bench's inputs (2 layers x 32, n=3, k=6, K=16, slots of
    29 atoms) the gradient of ``e_loss + 100 f_loss`` in bf16 lies 0.4-0.6
    (relative norm) from the float32 one in both JAX branches: the force
    loss sums second derivatives over every atom, and bf16 rounding at the
    forward and both backward levels does not cancel there. The port's two
    bf16 branches must drift no further than 1.5 times the JAX package's
    further branch, and the JAX drift must stay large (above 0.2), so the
    port's bf16 force gradients are held to the reference's own spread."""
    kw = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
              out_emb_channels=64, num_spherical=3, num_radial=6,
              nk_degree=16, block_size=29)
    jb, tb = _bench_like()
    params = JSphereNet(**kw).init(jax.random.PRNGKey(0), jb)
    flat = _flat(params["params"])

    def j_grad(**mk):
        jm = JSphereNet(**kw, **mk)

        def loss(p):
            def esum(pos):
                e = jm.apply(p, jb.replace(nodes={**jb.nodes, "pos": pos}))
                return jnp.sum(jnp.where(jb.graph_mask[:, None], e, 0.0)), e
            (_, e), gpos = jax.value_and_grad(esum, has_aux=True)(
                jb.nodes["pos"])
            return (_masked_mean(jnp.abs(e - jb.globals["y"]), jb.graph_mask)
                    + P * _masked_mean(jnp.abs(-gpos - jb.nodes["force"]),
                                       jb.node_mask))
        g = _flat(jax.jit(jax.grad(loss))(params)["params"])
        return torch.cat([p.detach().reshape(-1) for p in spherenet_from_flax(
            g, TSphereNet(device="cpu", **kw)).parameters()])

    def t_grad(flags):
        tm = spherenet_from_flax(flat, TSphereNet(
            device="cpu", **kw, **(flags or {}),
            compute_dtype=torch.bfloat16))
        step, _ = make_step_fns(tm, torch.optim.SGD(tm.parameters(), lr=0.0),
                                energy_and_force=True, p=P)
        step(tb)
        return torch.cat([p.grad.reshape(-1) for p in tm.parameters()])

    truth = j_grad()
    dist = lambda g: float((g - truth).norm() / truth.norm())
    jax_d = {"unfused": dist(j_grad(compute_dtype=jnp.bfloat16)),
             "slot": dist(j_grad(compute_dtype=jnp.bfloat16, **SLOT))}
    port_d = {"unfused": dist(t_grad(None)), "slot": dist(t_grad(SLOT))}
    print(f"bf16 force-gradient distance from float32: JAX {jax_d}, "
          f"port {port_d}")
    assert min(jax_d.values()) > 0.2
    assert max(port_d.values()) <= 1.5 * max(jax_d.values())


def test_force_loss_reaches_basis_weights():
    """The force loss alone reaches the composed basis weights (lin_sbf*,
    lin_t*) through the slot kernel's second order exactly as through the
    unfused branch: the tower keeps the saved weights' graph."""
    (jb, _), (tb, _) = _batches()
    flat = _flat(JSphereNet(**KW).init(jax.random.PRNGKey(0), jb)["params"])
    grads = {}
    for key, flags in (("unfused", None), ("slot", SLOT)):
        tm = _port(TSphereNet, flat, flags)
        _, force = energy_force(tm, tb)
        f_loss = torch.sum(torch.abs(force - tb.nodes["force"])
                           * tb.node_mask[:, None])
        ue = tm.update_es[0]
        lins = [ue.lin_sbf1, ue.lin_sbf2, ue.lin_t1, ue.lin_t2]
        grads[key] = torch.autograd.grad(f_loss, [l.weight for l in lins])
    for a, b in zip(grads["slot"], grads["unfused"]):
        assert float(b.abs().max()) > 0
        _close(a.numpy(), b.numpy())
