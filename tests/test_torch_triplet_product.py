"""Port's fused_triplet_product / fused_angle_product (on the CPU: their
plain versions) vs the JAX package's, float32.

The JAX ops run their Pallas kernels in interpret mode (with a tile that
does not divide E, so the ragged tail is padded there); the XLA oracle
``fused_triplet_product_ref`` is checked too. Inputs come from numpy
seeds; the triplet rows at masked slots hold values, as the raw
``expand_kj_raw`` gather leaves them. Forward and all five first-order
gradients agree to 1e-5 relative to the largest reference value (float32
sums in another order); second order (reverse over reverse, and the plain
second-order VJP against ``_run_bwd2``) to 1e-4, one more level of float32
sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.pallas_triplet import _run_bwd, _run_bwd2
from dig_tpu.ops.pallas_triplet import fused_angle_product as j_angle
from dig_tpu.ops.pallas_triplet import fused_triplet_product as j_product
from dig_tpu.ops.pallas_triplet import fused_triplet_product_ref as j_ref
from dig_tpu_torch.ops.triplet_product import (
    fused_angle_product, fused_triplet_product,
    fused_triplet_product_bwd2_reference, fused_triplet_product_bwd_reference,
    fused_triplet_product_reference)

TOL = 1e-5
TOL2 = 1e-4
E, K, C, S1, S2 = 13, 4, 8, 6, 10
TILE = 8                       # JAX tile: 13 edges pad to 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(xg=f(E * K, C), sbf=f(E * K, S1), tbf=f(E * K, S2),
                ws=0.3 * f(S1, C), wt=0.3 * f(S2, C),
                m2d=(rng.random((E, K)) > 0.3).astype(np.float32),
                ct=f(E, C))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _names(has_t):
    return ("xg", "sbf", "tbf", "ws", "wt") if has_t else ("xg", "sbf", "ws")


def _port(has_t, basis_grads=True):
    if has_t:
        return lambda xg, sbf, tbf, ws, wt, m2d: fused_triplet_product(
            xg, sbf, tbf, ws, wt, m2d, K, basis_grads=basis_grads)
    return lambda xg, sbf, ws, m2d: fused_angle_product(
        xg, sbf, ws, m2d, K, basis_grads=basis_grads)


def _jax_ops(has_t, basis_grads=True):
    """The JAX op (interpret mode) and its oracle, with the port's
    argument order."""
    if has_t:
        op = lambda xg, sbf, tbf, ws, wt, m2d: j_product(
            xg, sbf, tbf, ws, wt, m2d, K, TILE, basis_grads)
        ref = lambda xg, sbf, tbf, ws, wt, m2d: j_ref(xg, sbf, tbf, ws, wt,
                                                      K, m2d)
    else:
        op = lambda xg, sbf, ws, m2d: j_angle(xg, sbf, ws, m2d, K, TILE,
                                              basis_grads)
        ref = lambda xg, sbf, ws, m2d: j_ref(xg, sbf, None, ws, None, K, m2d)
    return jax.jit(op), jax.jit(ref)


def _torch_vjp(fn, d, names):
    xs = [torch.tensor(d[k], requires_grad=True) for k in names]
    out = fn(*xs, torch.tensor(d["m2d"]))
    return out, torch.autograd.grad(out, xs, torch.tensor(d["ct"]))


@pytest.mark.parametrize("has_t", [True, False])
def test_forward_and_vjps_match_jax(has_t):
    d = _inputs()
    names = _names(has_t)
    out, grads = _torch_vjp(_port(has_t), d, names)
    assert out.shape == (E, C) and out.dtype == torch.float32
    for fn in _jax_ops(has_t):
        args = [jnp.asarray(d[k]) for k in names]
        out_j, vjp = jax.vjp(lambda *a: fn(*a, jnp.asarray(d["m2d"])), *args)
        assert _rel(out.detach().numpy(), out_j) < TOL
        for name, a, b in zip(names, grads, vjp(jnp.asarray(d["ct"]))):
            assert _rel(a.numpy(), b) < TOL, name


@pytest.mark.parametrize("has_t", [True, False])
def test_masked_rows_get_zero_cotangents(has_t):
    """Every cotangent row at a masked triplet is exactly 0, whatever the
    (garbage) triplet rows hold there, at the first and second order."""
    d = _inputs(seed=1)
    names = _names(has_t)
    xs = [torch.tensor(d[k], requires_grad=True) for k in names]
    out = _port(has_t)(*xs, torch.tensor(d["m2d"]))
    g = torch.autograd.grad(out, xs, torch.tensor(d["ct"]),
                            create_graph=True)
    h = sum((gi * torch.randn(gi.shape, generator=torch.Generator()
                              .manual_seed(i))).sum()
            for i, gi in enumerate(g))
    g2 = torch.autograd.grad(h, xs)
    masked = torch.tensor(d["m2d"]).reshape(-1) == 0
    assert bool(masked.any())
    for name, a, b in zip(names, (t.detach() for t in g), g2):
        if a.shape[0] == E * K:                  # the triplet rows
            assert float(a[masked].abs().max()) == 0.0, name
            assert float(b[masked].abs().max()) == 0.0, name


@pytest.mark.parametrize("has_t", [True, False])
def test_basis_grads_false(has_t):
    """Zero basis cotangents, the other gradients as with basis_grads and
    as JAX's; a second derivative through it raises."""
    d = _inputs(seed=2)
    names = _names(has_t)
    _, g_on = _torch_vjp(_port(has_t), d, names)
    _, g_off = _torch_vjp(_port(has_t, False), d, names)
    op, _ = _jax_ops(has_t, False)
    args = [jnp.asarray(d[k]) for k in names]
    _, vjp = jax.vjp(lambda *a: op(*a, jnp.asarray(d["m2d"])), *args)
    for name, a, b, w in zip(names, g_off, g_on, vjp(jnp.asarray(d["ct"]))):
        if name in ("sbf", "tbf"):
            assert float(a.abs().max()) == 0.0 == float(np.abs(w).max())
        else:
            assert torch.equal(a, b), name
            assert _rel(a.numpy(), w) < TOL, name
    xs = [torch.tensor(d[k], requires_grad=True) for k in names]
    out = _port(has_t, False)(*xs, torch.tensor(d["m2d"]))
    g = torch.autograd.grad(out, xs, torch.tensor(d["ct"]),
                            create_graph=True)
    with pytest.raises(RuntimeError,
                       match="once_differentiable|does not require grad"):
        torch.autograd.grad(g[0].sum(), xs[-1])


def _second_order_inputs(seed):
    d = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    u = {k: rng.normal(size=d[k].shape).astype(np.float32)
         for k in ("xg", "sbf", "tbf", "ws", "wt")}
    return d, u


@pytest.mark.parametrize("absent", [(), (3, 4), (0, 1, 2)],
                         ids=["all", "no_u4_u5", "no_u1_u2_u3"])
@pytest.mark.parametrize("has_t", [True, False])
def test_plain_vjps_match_jax_run_bwd(has_t, absent):
    """The plain first- and second-order VJPs, which the card holds its
    kernels to, against the JAX op's own _run_bwd and _run_bwd2
    (interpret mode); an absent cotangent is zero on the JAX side."""
    d, u = _second_order_inputs(seed=3)
    t = {k: torch.tensor(v) for k, v in d.items()}
    tbf, wt = (t["tbf"], t["wt"]) if has_t else (None, None)
    jtbf, jwt = ((jnp.asarray(d["tbf"]), jnp.asarray(d["wt"])) if has_t
                 else (None, None))
    j = {k: jnp.asarray(v) for k, v in d.items()}
    for basis in (True, False):
        got = fused_triplet_product_bwd_reference(
            t["xg"], t["sbf"], tbf, t["ws"], wt, t["m2d"], t["ct"], K, basis)
        want = jax.jit(_run_bwd, static_argnums=(7, 8, 9))(
            j["xg"], j["sbf"], jtbf, j["ws"], jwt, j["m2d"], j["ct"], K, TILE,
            basis)
        for name, a, b in zip(["dxg", "dsbf", "dtbf", "dws", "dwt"], got,
                              want):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == torch.float32
                assert _rel(a.numpy(), b) < TOL, name
    keys = ("xg", "sbf", "tbf", "ws", "wt")
    us = [None if i in absent or (not has_t and k in ("tbf", "wt"))
          else torch.tensor(u[k]) for i, k in enumerate(keys)]
    ju = [None if not has_t and k in ("tbf", "wt")
          else jnp.zeros_like(jnp.asarray(u[k])) if i in absent
          else jnp.asarray(u[k]) for i, k in enumerate(keys)]
    got = fused_triplet_product_bwd2_reference(
        t["xg"], t["sbf"], tbf, t["ws"], wt, t["m2d"], t["ct"], *us, K)
    want = jax.jit(_run_bwd2, static_argnums=(12, 13))(
        j["xg"], j["sbf"], jtbf, j["ws"], jwt, j["m2d"], j["ct"], *ju, K, TILE)
    for name, a, b in zip(["xb", "sb", "tb", "wsb", "wtb", "ctb"], got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(a.numpy(), b) < TOL2, name


def _force_style(seed=7):
    """Inputs of a force-training-shaped loss (tests/test_pallas_triplet.py
    ``_force_style_loss``): a position-like input feeds the bases and xg,
    the inner gradient is taken with respect to it and the outer with
    respect to the weights."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    T = E * K
    return dict(xg0=f(T, C), sbf0=f(T, S1), tbf0=f(T, S2),
                m2d=(rng.random((E, K)) > 0.3).astype(np.float32),
                wdown=f(C), p_s=f(T, S1), p_t=f(T, S2), pos=f(T, 1),
                ws=0.3 * f(S1, C), wt=0.3 * f(S2, C))


def _energy(lib, op, d, pos, ws, wt):
    sbf = d["sbf0"] * lib.sin(pos * d["p_s"])
    tbf = d["tbf0"] + 0.1 * lib.cos(pos * d["p_t"]).sum(-1, keepdims=True)
    xg = d["xg0"] * (1.0 + 0.01 * pos.sum())
    return (op(xg, sbf, tbf, ws, wt, d["m2d"]) * d["wdown"]).sum()


def test_reverse_over_reverse_matches_jax():
    """The gradient with respect to (ws, wt, pos) of 0.1 E + |dE/dpos|^2,
    through the port's tower, against the JAX op (interpret mode) and its
    oracle."""
    d = _force_style()
    tj = {k: jnp.asarray(v) for k, v in d.items()}
    tt = {k: torch.tensor(v) for k, v in d.items()}

    def j_loss(op):
        def loss(ws, wt, pos):
            e = _energy(jnp, op, tj, pos, ws, wt)
            force = -jax.grad(lambda p: _energy(jnp, op, tj, p, ws, wt))(pos)
            return 0.1 * e + jnp.sum(force ** 2)
        return loss

    port = _port(True)
    ws, wt, pos = (tt[k].clone().requires_grad_() for k in ("ws", "wt", "pos"))
    e = _energy(torch, port, tt, pos, ws, wt)
    (gpos,) = torch.autograd.grad(e, pos, create_graph=True)
    got = torch.autograd.grad(0.1 * e + (gpos ** 2).sum(), (ws, wt, pos))
    for op in _jax_ops(True):
        want = jax.jit(jax.grad(j_loss(op), argnums=(0, 1, 2)))(
            tj["ws"], tj["wt"], tj["pos"])
        for name, a, b in zip(["ws", "wt", "pos"], got, want):
            assert np.abs(np.asarray(b)).max() > 0, name
            assert _rel(a.numpy(), b) < TOL2, name


def test_second_order_reaches_saved_weights():
    """The tower saves the op's own inputs: a loss on the first-order
    cotangents of xg and sbf reaches ws and wt, equal to autograd through
    the plain forward."""
    d, u = _second_order_inputs(seed=5)

    def second(fn):
        xs = [torch.tensor(d[k], requires_grad=True) for k in _names(True)]
        out = fn(*xs, torch.tensor(d["m2d"]))
        g = torch.autograd.grad(out, xs[:2], torch.tensor(d["ct"]),
                                create_graph=True)
        h = sum((gi * torch.tensor(u[k])).sum()
                for gi, k in zip(g, ("xg", "sbf")))
        return torch.autograd.grad(h, xs)

    got = second(_port(True))
    want = second(lambda *a: fused_triplet_product_reference(*a[:5], K,
                                                             a[5]))
    for name, a, b in zip(_names(True), got, want):
        assert float(b.abs().max()) > 0, name
        assert _rel(a.numpy(), b.numpy()) < TOL2, name


def test_kernel_inputs_are_checked():
    """The kernel path checks its operands before any launch."""
    from dig_tpu_torch.ops.triplet_product import _kernel_inputs
    d = {k: torch.tensor(v) for k, v in _inputs().items()}
    args = [d[k] for k in ("xg", "sbf", "tbf", "ws", "wt", "m2d")]
    with pytest.raises(TypeError, match="one type"):
        _kernel_inputs(args[0].bfloat16(), *args[1:], K)
    with pytest.raises(ValueError, match="multiple of K"):
        _kernel_inputs(*args, 5)
    with pytest.raises(ValueError, match="mask2d"):
        _kernel_inputs(*args[:5], args[5][:-1], K)
    wide = torch.zeros(E * K, 160)
    with pytest.raises(ValueError, match="up to 128"):
        _kernel_inputs(wide, args[1], args[2], torch.zeros(S1, 160),
                       torch.zeros(S2, 160), args[5], K)
