"""Port's fused_triplet_slot (on the CPU: its plain version) vs the JAX
package's, float32.

The JAX op runs its Pallas kernel in interpret mode; its XLA oracle
``fused_triplet_slot_ref`` is checked too. Inputs come from numpy seeds.
Forward and all four gradients agree to 1e-5 relative to the largest
reference value (float32 sums in another order). Second order (reverse
over reverse, the force-training structure, through the port's autograd
tower): 1e-4 relative to the largest reference value, one more level of
float32 sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.pallas_triplet_slot import _run_bwd, _run_bwd2
from dig_tpu.ops.pallas_triplet_slot import basis_pt_k as j_basis_pt_k
from dig_tpu.ops.pallas_triplet_slot import fused_triplet_slot as j_slot
from dig_tpu.ops.pallas_triplet_slot import fused_triplet_slot_ref as j_ref
from dig_tpu_torch.ops.triplet_slot import (
    basis_pt_k, fused_triplet_slot, fused_triplet_slot_bwd2_reference,
    fused_triplet_slot_bwd_reference, fused_triplet_slot_reference)

TOL = 1e-5
TOL2 = 1e-4


def _inputs(has_t, A=5, K=4, G=3, C=8, ns=3, nr=2, seed=0):
    rng = np.random.default_rng(seed)
    E = G * A * K
    R = ns * nr + ns + (ns * ns if has_t else 0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        x=f(E, C), pt=f(K, R, E), ws=f(ns * nr, C),
        wt=f((ns * ns * nr) if has_t else 1, C),
        m2T=(rng.random((K, E)) > 0.3).astype(np.float32),
        lj=rng.integers(0, A, size=(1, E)).astype(np.int32),
        ct=f(E, C)), (A, K, (ns, nr, has_t))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_grads(fn, d, A, K, cfg):
    def loss(x, pt, ws, wt):
        out = fn(x, pt, ws, wt, jnp.asarray(d["m2T"]), jnp.asarray(d["lj"]),
                 A, K, cfg)
        return jnp.sum(out * d["ct"]), out
    (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        *(jnp.asarray(d[k]) for k in ("x", "pt", "ws", "wt")))
    return np.asarray(out), [np.asarray(t) for t in g]


@pytest.mark.parametrize("has_t", [True, False])
def test_matches_jax_kernel_and_oracle(has_t):
    d, (A, K, cfg) = _inputs(has_t)
    ts = {k: torch.tensor(v) for k, v in d.items()}
    xs = [ts[k].clone().requires_grad_() for k in ("x", "pt", "ws", "wt")]
    out = fused_triplet_slot(*xs, ts["m2T"], ts["lj"], A, K, cfg)
    grads = torch.autograd.grad(out, xs, ts["ct"])
    for fn in (j_slot, j_ref):
        out_j, grads_j = _jax_grads(fn, d, A, K, cfg)
        assert _rel(out.detach().numpy(), out_j) < TOL
        for name, a, b in zip(["dx", "dpt", "dws", "dwt"], grads, grads_j):
            assert _rel(a.numpy(), b) < TOL, name


def test_reference_rounds_like_bf16_kernel():
    """bf16: the plain version equals the f32 contraction of the rounded
    operands (sbf, tbf, x) up to the one final rounding of the output."""
    d, (A, K, cfg) = _inputs(True, seed=1)
    ts = {k: torch.tensor(v) for k, v in d.items()}
    bf = {k: ts[k].to(torch.bfloat16) for k in ("x", "pt", "ws", "wt",
                                                 "m2T")}
    out16 = fused_triplet_slot_reference(bf["x"], bf["pt"], bf["ws"],
                                         bf["wt"], bf["m2T"], ts["lj"], A, K,
                                         cfg)
    assert out16.dtype == torch.bfloat16
    out32 = fused_triplet_slot_reference(*(bf[k].float() for k in (
        "x", "pt", "ws", "wt", "m2T")), ts["lj"], A, K, cfg)
    # 1e-2: sbf/tbf rounded to bf16 (2^-9 relative each) against f32 ones
    assert _rel(out16.float().numpy(), out32.numpy()) < 1e-2


def test_basis_pt_k_matches_jax():
    rng = np.random.default_rng(2)
    K, E = 4, 30
    th = rng.uniform(0.1, 3.0, (K, E)).astype(np.float32)
    ph = rng.uniform(0.1, 6.2, (K, E)).astype(np.float32)
    dk = rng.uniform(0.05, 1.0, (K, E)).astype(np.float32)
    for has_t in (True, False):
        want = np.asarray(j_basis_pt_k(3, 6, th, ph, dk, has_t))
        got = basis_pt_k(3, 6, torch.tensor(th), torch.tensor(ph),
                         torch.tensor(dk), has_t).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _second_order_inputs(has_t, seed=3):
    d, (A, K, cfg) = _inputs(has_t, seed=seed)
    rng = np.random.default_rng(seed + 100)
    # weights of a loss on the first-order gradients (dx, dpt, dws, dwt)
    w = [rng.normal(size=d[k].shape).astype(np.float32)
         for k in ("x", "pt", "ws", "wt")]
    return d, w, (A, K, cfg)


def _jax_second_order(fn, d, w, A, K, cfg, which):
    """Gradients of sum_i <w_i, d out/d input_i . ct> over the first-order
    gradients named in ``which``, w.r.t. (x, pt, ws, wt)."""
    m2T, lj, ct = (jnp.asarray(d[k]) for k in ("m2T", "lj", "ct"))

    def h(x, pt, ws, wt):
        g = jax.grad(lambda *a: jnp.sum(fn(*a, m2T, lj, A, K, cfg) * ct),
                     argnums=(0, 1, 2, 3))(x, pt, ws, wt)
        return sum(jnp.sum(g[i] * w[i]) for i in which)
    return [np.asarray(t) for t in jax.grad(h, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(d[k]) for k in ("x", "pt", "ws", "wt")))]


@pytest.mark.parametrize("which", [(0, 1), (0, 1, 2, 3)],
                         ids=["dx_dpt", "all"])
@pytest.mark.parametrize("has_t", [True, False])
def test_reverse_over_reverse_matches_jax(has_t, which):
    """A loss on the first-order gradients (as force training puts one on
    dx and dpt; ``all`` adds dws and dwt), differentiated again through
    the port's tower, against the JAX op (interpret mode) and its
    oracle."""
    d, w, (A, K, cfg) = _second_order_inputs(has_t)
    ts = {k: torch.tensor(v) for k, v in d.items()}
    xs = [ts[k].clone().requires_grad_() for k in ("x", "pt", "ws", "wt")]
    out = fused_triplet_slot(*xs, ts["m2T"], ts["lj"], A, K, cfg)
    g = torch.autograd.grad(out, xs, ts["ct"], create_graph=True,
                            allow_unused=True)
    h = sum((g[i] * torch.tensor(w[i])).sum() for i in which
            if g[i] is not None)
    got = [torch.zeros_like(x) if t is None else t for t, x in zip(
        torch.autograd.grad(h, xs, allow_unused=True), xs)]
    for fn in (j_slot, j_ref):
        want = _jax_second_order(fn, d, w, A, K, cfg, which)
        for name, a, b in zip(["x", "pt", "ws", "wt"], got, want):
            if name == "wt" and not has_t:
                continue
            assert np.abs(b).max() > 0, name
            assert _rel(a.numpy(), b) < TOL2, name


@pytest.mark.parametrize("absent", [(), (2, 3), (0, 1)],
                         ids=["all", "no_u4_u5", "no_u1_u2"])
@pytest.mark.parametrize("has_t", [True, False])
def test_plain_vjps_match_jax_run_bwd(has_t, absent):
    """The plain first- and second-order VJPs, which the card compares its
    kernels with, against the JAX op's own _run_bwd and _run_bwd2
    (interpret mode); an absent cotangent is zero on the JAX side."""
    d, w, (A, K, cfg) = _second_order_inputs(has_t, seed=4)
    ts = {k: torch.tensor(v) for k, v in d.items()}
    names = ("x", "pt", "ws", "wt", "m2T", "lj", "ct")
    jargs = [jnp.asarray(d[k]) for k in names]
    got1 = fused_triplet_slot_bwd_reference(*(ts[k] for k in names), A, K,
                                            cfg)
    for a, b in zip(got1[:3], _run_bwd(*jargs, A, K, cfg)[:3]):
        assert _rel(a.numpy(), np.asarray(b)) < TOL
    us = [None if i in absent else torch.tensor(u) for i, u in enumerate(w)]
    ju = [jnp.zeros_like(jnp.asarray(u)) if i in absent else jnp.asarray(u)
          for i, u in enumerate(w)]
    got2 = fused_triplet_slot_bwd2_reference(*(ts[k] for k in names), *us,
                                             A, K, cfg)
    want2 = _run_bwd2(*jargs, *ju, A, K, cfg)
    for name, a, b in zip(["xb", "ptb", "wsb", "wtb", "ctb"], got2, want2):
        assert a.dtype == torch.float32
        if name == "wtb" and not has_t:
            continue
        assert _rel(a.numpy(), np.asarray(b)) < TOL2, name


def test_second_order_reaches_saved_weights():
    """The tower saves the op's own inputs, so a second-order pass carries
    gradients to ws and wt (the composed lin_sbf / lin_t weights), equal
    to the plain version's double backward; a third order raises."""
    d, w, (A, K, cfg) = _second_order_inputs(True, seed=5)
    ts = {k: torch.tensor(v) for k, v in d.items()}

    def second(fn):
        xs = [ts[k].clone().requires_grad_() for k in ("x", "pt", "ws",
                                                        "wt")]
        out = fn(*xs, ts["m2T"], ts["lj"], A, K, cfg)
        dx, dpt = torch.autograd.grad(out, xs[:2], ts["ct"],
                                      create_graph=True)
        h = (dx * torch.tensor(w[0])).sum() + (dpt * torch.tensor(w[1])).sum()
        return xs, torch.autograd.grad(h, xs, create_graph=True)

    xs, got = second(fused_triplet_slot)
    _, want = second(fused_triplet_slot_reference)
    for name, a, b in zip(["x", "pt", "ws", "wt"], got, want):
        a, b = a.detach().numpy(), b.detach().numpy()
        assert np.abs(b).max() > 0, name
        assert _rel(a, b) < TOL2, name
    # the second-order level is not differentiable again
    with pytest.raises(RuntimeError,
                       match="once_differentiable|does not require grad"):
        torch.autograd.grad(got[2].sum(), xs[0])


def test_cuda_path_rejects_mixed_types():
    """The kernel path checks its operands before any launch."""
    from dig_tpu_torch.ops.triplet_slot import _kernel_inputs
    d, (A, K, cfg) = _inputs(True)
    ts = {k: torch.tensor(v) for k, v in d.items()}
    args = [ts["x"].to(torch.bfloat16), ts["pt"], ts["ws"], ts["wt"],
            ts["m2T"], ts["lj"]]
    with pytest.raises(TypeError, match="one type"):
        _kernel_inputs(*args, A, K, cfg)
    with pytest.raises(ValueError, match="C in"):
        _kernel_inputs(ts["x"], ts["pt"], ts["ws"], ts["wt"], ts["m2T"],
                       ts["lj"], A, K, cfg)
