"""Port's SphereNet / DimeNet++ and energy train step vs the JAX package's.

Flax weights are carried into the port with ``spherenet_from_flax``; both
run on the CPU on one slot-aligned ``MoleculeLoader`` batch. The JAX slot
model runs its Pallas kernel in interpret mode; the port's slot branch on
the CPU runs the plain version of ``fused_triplet_slot``.

Tolerances: float32 energies 1e-4 (sums in another order through 2
layers); two Adam steps: loss, gradients and parameters 2e-4 (the same,
plus Adam's division by the root of the second moment); bf16 energies
5e-2 of the largest energy (each framework rounds the linears' inputs
and outputs to bf16, a 2^-8 relative step, at slightly different places).
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

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8,
          block_size=A)
SLOT = dict(pallas_triplet=True, pallas_fuse_basis=True, pallas_slot=True)
MODELS = {"SphereNet": (JSphereNet, TSphereNet),
          "DimeNetPP": (JDimeNetPP, TDimeNetPP)}


def _batches(seed=3, n=8, batch_size=4):
    mols = synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=A,
                               box=6.0)
    jl = JLoader(mols, batch_size, slot_size=A, shuffle=True, seed=seed)
    tl = TLoader(mols, batch_size, slot_size=A, shuffle=True, seed=seed,
                 device="cpu")
    return list(jl), list(tl)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _port(TM, flat, flags=None, **kw):
    return spherenet_from_flax(flat, TM(device="cpu", **KW, **(flags or {}),
                                        **kw))


@pytest.mark.parametrize("name", ["SphereNet", "DimeNetPP"])
def test_energies_match_jax_both_branches(name):
    JM, TM = MODELS[name]
    (jb, _), (tb, _) = _batches()
    params = JM(**KW).init(jax.random.PRNGKey(0), jb)
    flat = _flat(params["params"])
    e_unfused = np.asarray(JM(**KW).apply(params, jb))
    e_slot = np.asarray(JM(**KW, **SLOT).apply(params, jb))   # interpret
    for flags, want in ((None, e_unfused), (SLOT, e_slot)):
        got = _port(TM, flat, flags)(tb).detach().numpy()
        assert got.shape == want.shape == (4, 1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_energies_match_jax():
    (jb, _), (tb, _) = _batches()
    params = JSphereNet(**KW).init(jax.random.PRNGKey(1), jb)
    flat = _flat(params["params"])
    want = np.asarray(JSphereNet(**KW, compute_dtype=jnp.bfloat16).apply(
        params, jb))
    scale = np.abs(want).max()
    for flags in (None, SLOT):
        got = _port(TSphereNet, flat, flags,
                    compute_dtype=torch.bfloat16)(tb)
        assert got.dtype == torch.float32        # the readout is float32
        assert np.abs(got.detach().numpy() - want).max() <= 5e-2 * scale


@functools.lru_cache(maxsize=None)
def _jax_trajectory():
    """Two Adam steps of the JAX make_step_fns: the initial parameters,
    then per step the loss, the gradients and the updated parameters (flat
    flax trees), and the energies after the last step."""
    jbs, _ = _batches(seed=5)
    jm = JSphereNet(**KW)
    opt = optax.adam(5e-4)
    state = make_train_state(jm, opt, jbs[0], seed=2)
    step_j, _ = j_make_step_fns(jm, opt, loss="l1", donate=False)

    def loss(params, g):
        err = jnp.abs(jm.apply(params, g) - g.globals["y"])
        return _masked_mean(err, g.graph_mask)
    grad_j = jax.jit(jax.grad(loss))
    init, steps = _flat(state.params["params"]), []
    for jb in jbs:
        grads = _flat(grad_j(state.params, jb)["params"])
        state, aux = step_j(state, jb)
        steps.append((float(aux["loss"]), grads,
                      _flat(state.params["params"])))
    return init, steps, np.asarray(jm.apply(state.params, jbs[0]))


@pytest.mark.parametrize("flags", [None, SLOT], ids=["unfused", "slot"])
def test_two_adam_steps_match_jax(flags):
    init, steps, e_final = _jax_trajectory()
    _, tbs = _batches(seed=5)
    tm = _port(TSphereNet, init, flags)
    step_t, eval_t = make_step_fns(
        tm, torch.optim.Adam(tm.parameters(), lr=5e-4), loss="l1")
    for tb, (loss_j, grads_j, params_j) in zip(tbs, steps):
        loss_t = step_t(tb)["loss"]
        np.testing.assert_allclose(float(loss_t), loss_j, rtol=2e-4,
                                   atol=2e-4)
        g_ref, p_ref = _port(TSphereNet, grads_j), _port(TSphereNet, params_j)
        for (name, p), g, q in zip(tm.named_parameters(), g_ref.parameters(),
                                   p_ref.parameters()):
            np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(),
                                       rtol=2e-4, atol=2e-4, err_msg=name)
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=name)
    np.testing.assert_allclose(eval_t(tbs[0])["y_pred"].numpy(), e_final,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["SphereNet", "DimeNetPP"])
def test_slot_forces_match_unfused_branch(name):
    """-dE/dpos through the slot branch (the kernel's first order with
    dpt) equals the unfused branch's on the same weights, to the energies'
    1e-4."""
    JM, TM = MODELS[name]
    (jb, _), (tb, _) = _batches()
    flat = _flat(JM(**KW).init(jax.random.PRNGKey(0), jb)["params"])
    forces = []
    for flags in (None, SLOT):
        pos = tb.nodes["pos"].clone().requires_grad_()
        e = _port(TM, flat, flags)(tb.replace_nodes(pos=pos))
        (g,) = torch.autograd.grad(e[tb.graph_mask].sum(), pos)
        forces.append(-g.numpy())
    assert np.abs(forces[0]).max() > 0
    np.testing.assert_allclose(forces[1], forces[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("basis_grads, err", [(False, ValueError)])
def test_energy_and_force_raises(basis_grads, err):
    """Without basis gradients force training is refused, as in the JAX
    trainer."""
    tm = TSphereNet(device="cpu", **KW, **SLOT,
                    pallas_basis_grads=basis_grads)
    with pytest.raises(err, match="pallas_basis_grads"):
        make_step_fns(tm, torch.optim.Adam(tm.parameters()),
                      energy_and_force=True)


@pytest.mark.parametrize("flags, item", [
    (dict(remat=True), "remat"),
])
def test_unported_layouts_raise(flags, item):
    """The options that raised while they were not ported (``remat``) now
    build, and the model gives the energies of the same model without the
    option, bit for bit; the parity with the JAX remat model is in
    tests/test_torch_spherenet_nk.py."""
    model = TSphereNet(device="cpu", **{**KW, **flags})
    assert getattr(model, item)
    _, (tb, _) = _batches()
    assert torch.equal(model(tb), TSphereNet(device="cpu", **KW)(tb))


def test_fused_basis_without_pallas_slot_matches_jax():
    """pallas_fuse_basis on the slot-aligned table without pallas_slot is
    the packed-basis branch (fused_triplet_pt), as in the JAX model: its
    energies against the JAX model's (interpret mode)."""
    flags = dict(pallas_triplet=True, pallas_fuse_basis=True)
    (jb, _), (tb, _) = _batches()
    params = JSphereNet(**KW).init(jax.random.PRNGKey(0), jb)
    want = np.asarray(JSphereNet(**KW, **flags).apply(params, jb))
    tm = _port(TSphereNet, _flat(params["params"]), flags)
    assert tm.pt_fused and not tm.slot_fused
    np.testing.assert_allclose(tm(tb).detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("flags", [None, SLOT], ids=["unfused", "slot"])
def test_segment_eb_is_ignored_on_the_slot_layout(flags):
    """On the NK layout UpdateV is a reshape-sum and segment_eb is accepted
    and ignored, as in the JAX UpdateV: the same energies as without it,
    and as the JAX model with it."""
    (jb, _), (tb, _) = _batches()
    params = JSphereNet(**KW).init(jax.random.PRNGKey(0), jb)
    flat = _flat(params["params"])
    want = np.asarray(JSphereNet(**KW, segment_eb=64).apply(params, jb))
    without = _port(TSphereNet, flat, flags)(tb).detach().numpy()
    got = _port(TSphereNet, flat, flags, segment_eb=64)(tb).detach().numpy()
    np.testing.assert_array_equal(got, without)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_convert_rejects_incomplete_tree():
    (jb, _), _ = _batches()
    flat = _flat(JSphereNet(**KW).init(jax.random.PRNGKey(0),
                                       jb)["params"])
    with pytest.raises(KeyError, match="unused"):
        _port(TSphereNet, dict(flat, stray=np.zeros(1)))
    del flat["UpdateE_1/Dense_3/kernel"]
    with pytest.raises(KeyError, match="UpdateE_1/Dense_3/kernel"):
        _port(TSphereNet, flat)
