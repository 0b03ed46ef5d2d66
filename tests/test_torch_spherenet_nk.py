"""Port's SphereNet / DimeNet++ on the [N, K] layout with the fused triplet
product (``pallas_triplet`` without ``pallas_fuse_basis``:
``fused_triplet_product`` / ``fused_angle_product`` over ``expand_kj_raw``
rows), on the unblocked (``block_size=0``) and the blocked table, vs the
JAX package's, on the CPU.

Flax weights go into the port with ``spherenet_from_flax``; the JAX fused
models run their Pallas kernel in interpret mode, the port's its plain
versions. Inputs: ``MoleculeLoader`` batches of seeded synthetic molecules
(5-10 atoms in a 6 A box, forces included; flat batches for the unblocked
table, slots of 10 atoms for the blocked one), 2 layers x 32, K = 8.

``remat=True`` (``UpdateE`` recomputed in the backward) is held against
the JAX remat model in energy and in force training.

Tolerances: float32 energies 1e-4 (sums in another order through 2
layers); Adam steps 1e-3 for loss and parameters and for the gradients
relative to each parameter's largest gradient entry (as
``tests/test_torch_force.py``: two derivative levels, the loss scaled by
p = 100, Adam's division by the root of the second moment).
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
from dig_tpu.train.trainer import _masked_mean
from dig_tpu_torch.convert import spherenet_from_flax
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.models import DimeNetPP as TDimeNetPP
from dig_tpu_torch.models import SphereNet as TSphereNet
from dig_tpu_torch.train import make_step_fns

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8)
LAYOUTS = {"unblocked": dict(block_size=0), "blocked": dict(block_size=A)}
FUSED = dict(pallas_triplet=True)
MODELS = {"SphereNet": (JSphereNet, TSphereNet),
          "DimeNetPP": (JDimeNetPP, TDimeNetPP)}
P = 100.0
TOL = 1e-3


def _batches(layout, seed=3, n=8, batch_size=4):
    mols = synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=A,
                               box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    slot = dict(slot_size=A) if layout == "blocked" else {}
    jl = JLoader(mols, batch_size, shuffle=True, seed=seed, **slot)
    tl = TLoader(mols, batch_size, shuffle=True, seed=seed, device="cpu",
                 **slot)
    return list(jl), list(tl)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _port(TM, flat, **kw):
    return spherenet_from_flax(flat, TM(device="cpu", **KW, **kw))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _params(name):
    """One flax parameter set per model (the same for every layout and
    branch: the fused branch applies the same Dense modules)."""
    (jb, _), _ = _batches("unblocked")
    return jax.jit(MODELS[name][0](**KW).init)(jax.random.PRNGKey(0), jb)


@pytest.mark.parametrize("layout", ["unblocked", "blocked"])
@pytest.mark.parametrize("name", ["SphereNet", "DimeNetPP"])
def test_energies_match_jax(name, layout):
    """The fused and the unfused branch of one flax parameter set against
    the JAX model's same branch."""
    JM, TM = MODELS[name]
    (jb, _), (tb, _) = _batches(layout)
    lay = LAYOUTS[layout]
    params = _params(name)
    flat = _flat(params["params"])
    for flags in ({}, FUSED):
        want = np.asarray(jax.jit(JM(**KW, **lay, **flags).apply)(params, jb))
        tm = _port(TM, flat, **lay, **flags)
        assert tm.product_fused == bool(flags) and not tm.slot_fused
        got = tm(tb).detach().numpy()
        assert got.shape == want.shape == (4, 1)
        _close(got, want, 1e-4, str(flags))


def test_branches_share_parameters():
    """spherenet_from_flax needs nothing new: the fused and the unfused
    model hold the same parameters under the same names."""
    a = TSphereNet(device="cpu", **KW)
    b = TSphereNet(device="cpu", **KW, **FUSED)
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(name, force, steps, basis_grads, remat=False):
    """``steps`` Adam steps (optax) on the unblocked fused model from
    ``_params(name)``, the loss of the JAX trainer's ``compute_loss``: per
    step the aux dict, the gradients and the updated parameters (flat flax
    trees). One jitted value-and-gradient gives all three."""
    JM = MODELS[name][0]
    jbs, _ = _batches("unblocked", seed=5)
    jm = JM(**KW, **FUSED, pallas_basis_grads=basis_grads, remat=remat)
    opt = optax.adam(5e-4)
    params = _params(name)
    opt_state = opt.init(params)

    def loss(p, g):
        if not force:
            total = _masked_mean(jnp.abs(jm.apply(p, g) - g.globals["y"]),
                                 g.graph_mask)
            return total, {"loss": total}

        def esum(pos):
            e = jm.apply(p, g.replace(nodes={**g.nodes, "pos": pos}))
            return jnp.sum(jnp.where(g.graph_mask[:, None], e, 0.0)), e
        (_, e), gpos = jax.value_and_grad(esum, has_aux=True)(g.nodes["pos"])
        e_loss = _masked_mean(jnp.abs(e - g.globals["y"]), g.graph_mask)
        f_loss = _masked_mean(jnp.abs(-gpos - g.nodes["force"]), g.node_mask)
        total = e_loss + P * f_loss
        return total, {"loss": total, "e_loss": e_loss, "f_loss": f_loss}
    grad_j = jax.jit(jax.value_and_grad(loss, has_aux=True))
    out = []
    for jb in jbs[:steps]:
        (_, aux), grads = grad_j(params, jb)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out.append(({k: float(v) for k, v in aux.items()},
                    _flat(grads["params"]), _flat(params["params"])))
    return out


@pytest.mark.parametrize("name, force, basis_grads, remat, steps", [
    ("SphereNet", True, True, False, 2), ("DimeNetPP", False, False, False, 2),
    ("SphereNet", True, True, True, 1)],
    ids=["spherenet_force", "dimenetpp_energy_no_basis_grads",
         "spherenet_force_remat"])
def test_two_adam_steps_match_jax(name, force, basis_grads, remat, steps):
    """SphereNet energy+force (the second-order tower) and DimeNet++
    energy training without basis cotangents, on the unblocked fused
    model: loss, gradients and parameters of two steps; and one force step
    of both packages' ``remat=True`` models (``UpdateE`` recomputed in the
    backward, the double backward through the recomputation)."""
    traj = _jax_trajectory(name, force, steps, basis_grads, remat)
    TM = MODELS[name][1]
    _, tbs = _batches("unblocked", seed=5)
    tm = _port(TM, _flat(_params(name)["params"]), **FUSED,
               pallas_basis_grads=basis_grads, remat=remat)
    step_t, eval_t = make_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=5e-4),
        energy_and_force=force, p=P, loss="l1")
    for tb, (aux_j, grads_j, params_j) in zip(tbs, traj):
        aux_t = step_t(tb)
        assert set(aux_t) == set(aux_j)
        for key, want in aux_j.items():
            _close(float(aux_t[key]), want, TOL, key)
        g_ref, p_ref = _port(TM, grads_j), _port(TM, params_j)
        for (pname, p), g, q in zip(tm.named_parameters(), g_ref.parameters(),
                                    p_ref.parameters()):
            g = g.detach().numpy()
            # 1e-3 of the parameter's largest gradient entry: the force
            # loss's gradients reach a few hundred here
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=TOL,
                                       atol=TOL * max(np.abs(g).max(), 1.0),
                                       err_msg=f"grad {pname}")
            _close(p.detach().numpy(), q.detach().numpy(), TOL, pname)
    if force:
        out = eval_t(tbs[0])
        assert torch.isfinite(out["force_pred"]).all()
        assert float(out["force_pred"].abs().max()) > 0


def test_remat_matches_jax_remat():
    """The counterpart of ``tests/test_nk_blocked.py``'s
    ``test_spherenet_remat_matches``: the sum of the energies and its
    parameter gradients of the blocked, unfused ``remat=True`` model
    against the JAX remat model's (1e-4; gradients relative to each
    parameter's largest entry), and the port's remat model against its
    model without remat, bit for bit (the recomputation runs the same
    operations on the same inputs)."""
    (jb, _), (tb, _) = _batches("blocked")
    lay = LAYOUTS["blocked"]
    params = _params("SphereNet")
    jm = JSphereNet(**KW, **lay, remat=True)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jnp.sum(
        jnp.where(jb.graph_mask[:, None], jm.apply(p, jb), 0.0))))(params)
    res = []
    for remat in (True, False):
        tm = _port(TSphereNet, _flat(params["params"]), **lay, remat=remat)
        loss = torch.where(tb.graph_mask[:, None], tm(tb), 0.0).sum()
        loss.backward()
        res.append((loss.detach(), [p.grad for p in tm.parameters()]))
    _close(float(res[0][0]), float(loss_j), 1e-4)
    g_ref = _port(TSphereNet, _flat(grads_j["params"]), **lay)
    for p_grad, g in zip(res[0][1], g_ref.parameters()):
        g = g.detach().numpy()
        np.testing.assert_allclose(p_grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-6))
    assert torch.equal(res[0][0], res[1][0])
    assert all(torch.equal(a, b) for a, b in zip(res[0][1], res[1][1]))


def test_force_training_refused_without_basis_grads():
    """As the JAX trainer: energy_and_force needs the basis cotangents."""
    tm = TSphereNet(device="cpu", **KW, **FUSED, pallas_basis_grads=False)
    assert tm.product_fused
    with pytest.raises(ValueError, match="pallas_basis_grads"):
        make_step_fns(tm, torch.optim.Adam(tm.parameters()),
                      energy_and_force=True)


@pytest.mark.parametrize("flags", [
    dict(pallas_fuse_basis=True),
    dict(pallas_fuse_basis=True, pallas_slot=True)])
def test_fused_basis_without_the_slot_kernel_is_the_pt_branch(flags):
    """pallas_fuse_basis on the unblocked table (pallas_slot or not) is the
    packed-basis branch, fused_triplet_pt, as in the JAX model: energies
    against the JAX model's with the same flags (interpret mode)."""
    (jb, _), (tb, _) = _batches("unblocked")
    params = _params("SphereNet")
    want = np.asarray(jax.jit(JSphereNet(**KW, **FUSED, **flags).apply)(
        params, jb))
    tm = _port(TSphereNet, _flat(params["params"]), **FUSED, **flags)
    assert tm.pt_fused and not (tm.slot_fused or tm.product_fused)
    _close(tm(tb).detach().numpy(), want, 1e-4)
