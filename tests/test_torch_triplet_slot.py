"""Port's fused_triplet_slot (on the CPU: its plain version) vs the JAX
package's, float32.

The JAX op runs its Pallas kernel in interpret mode; its XLA oracle
``fused_triplet_slot_ref`` is checked too. Inputs come from numpy seeds.
Forward and all four gradients agree to 1e-5 relative to the largest
reference value (float32 sums in another order). A double backward
through the port's op raises: it is first order until the force slice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.pallas_triplet_slot import (basis_pt_k as j_basis_pt_k,
                                             fused_triplet_slot as j_slot,
                                             fused_triplet_slot_ref as j_ref)
from dig_tpu_torch.ops.triplet_slot import (basis_pt_k, fused_triplet_slot,
                                            fused_triplet_slot_reference)

TOL = 1e-5


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


def test_double_backward_raises():
    d, (A, K, cfg) = _inputs(True)
    ts = {k: torch.tensor(v) for k, v in d.items()}
    x = ts["x"].clone().requires_grad_()
    out = fused_triplet_slot(x, ts["pt"], ts["ws"], ts["wt"], ts["m2T"],
                             ts["lj"], A, K, cfg)
    with pytest.raises(NotImplementedError, match="force-training"):
        torch.autograd.grad(out.sum(), x, create_graph=True)


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
