"""Port's fused_triplet_pt and basis_pt (on the CPU: the plain versions) vs
the JAX package's, float32.

The JAX op runs its Pallas kernels in interpret mode at the sizes of
``tests/test_pallas_basis_kernel.py`` (E = 40 and a ragged 37, K = 4,
C = 16, n = 3, k = 4, the JAX tile 16 edges), torsion on and off; its XLA
oracle ``fused_triplet_pt_ref`` is checked too. Inputs come from numpy
seeds; the triplet rows at masked slots hold values, as the raw
``expand_kj_raw`` gather leaves them. ``basis_pt`` agrees to 1e-6 of the
largest value (the same closed forms). The forward, the VJP (dxg, dpt,
dws, dwt), the plain second-order VJP against ``_run_bwd2`` and a
reverse-over-reverse gradient agree to 1e-4 relative to the largest
reference value (float32 sums in another order, at up to two derivative
levels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.pallas_triplet_pt import _run_bwd, _run_bwd2
from dig_tpu.ops.pallas_triplet_pt import basis_pt as j_basis_pt
from dig_tpu.ops.pallas_triplet_pt import fused_triplet_pt as j_pt
from dig_tpu.ops.pallas_triplet_pt import fused_triplet_pt_ref as j_ref
from dig_tpu_torch.ops.triplet_pt import (
    basis_pt, fused_triplet_pt, fused_triplet_pt_bwd2_ref,
    fused_triplet_pt_bwd_ref, fused_triplet_pt_ref, pt_rows)

TOL = 1e-4
NS, NR, K, C, TILE = 3, 4, 4, 16, 16


def _inputs(has_t, E=40, seed=0):
    """Per-triplet geometry and the op's operands, numpy float32."""
    rng = np.random.default_rng(seed)
    T = E * K
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        th=rng.uniform(0.1, 3.0, T).astype(np.float32),
        ph=rng.uniform(-3.0, 3.0, T).astype(np.float32),
        dk=rng.uniform(0.1, 0.95, T).astype(np.float32),
        xg=f(T, C), ws=0.3 * f(NS * NR, C),
        wt=(0.3 * f(NS * NS * NR, C) if has_t
            else np.zeros((1, C), np.float32)),
        m2=(rng.random((E, K)) > 0.25).astype(np.float32), ct=f(E, C))


def _pt(d, has_t):
    return np.asarray(j_basis_pt(NS, NR, jnp.asarray(d["th"]),
                                 jnp.asarray(d["ph"]), jnp.asarray(d["dk"]),
                                 has_t))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("has_t", [True, False])
def test_basis_pt_matches_jax(has_t):
    d = _inputs(has_t)
    got = basis_pt(NS, NR, *(torch.tensor(d[k]) for k in ("th", "ph", "dk")),
                   has_t)
    want = _pt(d, has_t)
    assert got.shape == want.shape == (pt_rows(NS, NR, has_t), 40 * K)
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("E", [40, 37])
@pytest.mark.parametrize("has_t", [True, False])
def test_forward_and_vjp_match_jax(has_t, E):
    """The op through the port's tower against the JAX op (interpret mode)
    and its oracle: the output and the four gradients."""
    d = _inputs(has_t, E, seed=1)
    d["pt"] = _pt(d, has_t)
    cfg = (NS, NR, has_t)
    names = ("xg", "pt", "ws", "wt")
    xs = [torch.tensor(d[k], requires_grad=True) for k in names]
    out = fused_triplet_pt(*xs, torch.tensor(d["m2"]), K, TILE, cfg)
    assert out.shape == (E, C) and out.dtype == torch.float32
    grads = torch.autograd.grad(out, xs, torch.tensor(d["ct"]),
                                allow_unused=True)
    for fn in (lambda *a: j_pt(*a, jnp.asarray(d["m2"]), K, TILE, cfg),
               lambda *a: j_ref(*a, jnp.asarray(d["m2"]), K, cfg)):
        out_j, vjp = jax.vjp(fn, *(jnp.asarray(d[k]) for k in names))
        assert _rel(out.detach().numpy(), out_j) < TOL
        for name, a, b in zip(names, grads, vjp(jnp.asarray(d["ct"]))):
            if name == "wt" and not has_t:        # the unused dummy
                assert float(a.abs().max()) == 0.0 == float(jnp.abs(b).max())
                continue
            assert _rel(a.numpy(), b) < TOL, name


def _second_order_inputs(has_t, seed):
    d = _inputs(has_t, seed=seed)
    d["pt"] = _pt(d, has_t)
    rng = np.random.default_rng(seed + 100)
    u = [rng.normal(size=d[k].shape).astype(np.float32)
         for k in ("xg", "pt", "ws", "wt")]
    return d, u


@pytest.mark.parametrize("absent", [(), (2, 3), (0, 1)],
                         ids=["all", "no_u4_u5", "no_u1_u2"])
@pytest.mark.parametrize("has_t", [True, False])
def test_plain_vjps_match_jax_run_bwd(has_t, absent):
    """The plain first- and second-order VJPs, which the card holds its
    kernels to, against the JAX op's own _run_bwd and _run_bwd2
    (interpret mode); an absent cotangent is zero on the JAX side."""
    d, u = _second_order_inputs(has_t, seed=2)
    cfg = (NS, NR, has_t)
    t = {k: torch.tensor(v) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    args = [t[k] for k in ("xg", "pt", "ws", "wt", "m2", "ct")]
    jargs = [j[k] for k in ("xg", "pt", "ws", "wt", "m2", "ct")]
    got = fused_triplet_pt_bwd_ref(*args, K, cfg)
    want = jax.jit(_run_bwd, static_argnums=(6, 7, 8))(*jargs, K, TILE, cfg)
    for name, a, b in zip(["dxg", "dpt", "dws", "dwt"], got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel(a.numpy(), b) < TOL, name
    no_dpt = fused_triplet_pt_bwd_ref(*args, K, cfg, need_dpt=False)
    assert no_dpt[1] is None
    assert all(torch.equal(a, b) for a, b in zip(no_dpt[::2], got[::2]))
    us = [None if i in absent else torch.tensor(v) for i, v in enumerate(u)]
    ju = [jnp.zeros_like(jnp.asarray(v)) if i in absent else jnp.asarray(v)
          for i, v in enumerate(u)]
    got = fused_triplet_pt_bwd2_ref(*args, *us, K, cfg)
    want = jax.jit(_run_bwd2, static_argnums=(10, 11, 12))(*jargs, *ju, K,
                                                           TILE, cfg)
    for name, a, b in zip(["xb", "ptb", "wsb", "wtb", "ctb"], got, want):
        if name == "wtb" and not has_t:
            assert float(a.abs().max()) == 0.0
            continue
        assert _rel(a.numpy(), b) < TOL, name


@pytest.mark.parametrize("has_t", [True, False])
def test_masked_triplets_get_zero_cotangents(has_t):
    """Garbage at masked triplets (huge pt values, other rows' xg) leaves
    the output unchanged; the dxg rows and dpt columns of masked triplets
    are exactly 0 at the first and the second order."""
    d, u = _second_order_inputs(has_t, seed=3)
    cfg = (NS, NR, has_t)
    masked = torch.tensor(d["m2"]).reshape(-1) == 0
    assert bool(masked.any())
    m2 = torch.tensor(d["m2"])

    def run(pt):
        xs = [torch.tensor(d["xg"], requires_grad=True),
              pt.clone().requires_grad_(),
              torch.tensor(d["ws"], requires_grad=True)]
        out = fused_triplet_pt(*xs, torch.tensor(d["wt"]), m2, K, TILE, cfg)
        g = torch.autograd.grad(out, xs, torch.tensor(d["ct"]),
                                create_graph=True)
        h = sum((gi * torch.tensor(ui)).sum() for gi, ui in zip(g, u))
        return out, g, torch.autograd.grad(h, xs)

    pt = torch.tensor(d["pt"])
    out, g, g2 = run(pt)
    out_bad, _, _ = run(torch.where(masked[None, :], 1e6, pt))
    assert torch.equal(out, out_bad)
    for name, a, b in zip(("xg", "pt"), g, g2):
        rows = (lambda x: x[masked]) if name == "xg" else \
            (lambda x: x[:, masked])
        assert float(rows(a.detach()).abs().max()) == 0.0, name
        assert float(rows(b).abs().max()) == 0.0, name


def _force_loss(op, lib, d, has_t):
    """0.1 E + |dE/d(th, ph, dk)|^2 with E = sum(out * wdown): the inner
    gradient with respect to the per-triplet geometry (the basis's
    position-dependent inputs), the outer with respect to the weights."""
    def energy(th, ph, dk, ws, wt):
        pt = (j_basis_pt if lib is jnp else basis_pt)(NS, NR, th, ph, dk,
                                                       has_t)
        return (op(d["xg"], pt, ws, wt, d["m2"]) * d["wdown"]).sum()
    return energy


@pytest.mark.parametrize("has_t", [True, False])
def test_reverse_over_reverse_matches_jax(has_t):
    """The gradient with respect to (ws, wt) of the force-style loss
    through basis_pt and the port's tower, against the JAX op (interpret
    mode)."""
    d = _inputs(has_t, E=24, seed=4)
    d["wdown"] = np.random.default_rng(5).normal(size=C).astype(np.float32)
    cfg = (NS, NR, has_t)
    tj = {k: jnp.asarray(v) for k, v in d.items()}
    tt = {k: torch.tensor(v) for k, v in d.items()}
    e_j = _force_loss(lambda *a: j_pt(*a, K, TILE, cfg), jnp, tj, has_t)
    e_t = _force_loss(lambda *a: fused_triplet_pt(*a, K, TILE, cfg), torch,
                      tt, has_t)

    def j_loss(ws, wt):
        geo = (tj["th"], tj["ph"], tj["dk"])
        force = jax.grad(e_j, argnums=(0, 1, 2))(*geo, ws, wt)
        return 0.1 * e_j(*geo, ws, wt) + sum(jnp.sum(f ** 2) for f in force)

    ws, wt = (tt[k].clone().requires_grad_() for k in ("ws", "wt"))
    geo = [tt[k].clone().requires_grad_() for k in ("th", "ph", "dk")]
    e = e_t(*geo, ws, wt)
    force = torch.autograd.grad(e, geo, create_graph=True, allow_unused=True)
    loss = 0.1 * e + sum((f ** 2).sum() for f in force if f is not None)
    got = torch.autograd.grad(loss, (ws, wt), allow_unused=True)
    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(tj["ws"], tj["wt"])
    assert np.abs(np.asarray(want[0])).max() > 0
    assert _rel(got[0].numpy(), want[0]) < TOL
    if has_t:
        assert _rel(got[1].numpy(), want[1]) < TOL
    else:                                         # the unused dummy
        assert got[1] is None or float(got[1].abs().max()) == 0.0
        assert float(jnp.abs(want[1]).max()) == 0.0


def test_jax_positional_call_form():
    """JAX's call form ``(xg, pt, ws, wt, m2d, 4, 16, cfg)``
    (tests/test_pallas_basis_kernel.py) with the plain forward as the
    oracle, and a ragged edge count."""
    d = _inputs(True, E=37, seed=6)
    d["pt"] = _pt(d, True)
    t = [torch.tensor(d[k]) for k in ("xg", "pt", "ws", "wt", "m2")]
    got = fused_triplet_pt(*t, 4, 16, (NS, NR, True))
    want = j_pt(*(jnp.asarray(d[k]) for k in ("xg", "pt", "ws", "wt", "m2")),
                4, 16, (NS, NR, True))
    assert torch.equal(got, fused_triplet_pt_ref(*t, 4, (NS, NR, True)))
    assert _rel(got.numpy(), want) < TOL


def test_kernel_inputs_are_checked():
    """The kernel path checks its operands before any launch."""
    from dig_tpu_torch.ops.triplet_pt import _kernel_inputs
    d = _inputs(True)
    d["pt"] = _pt(d, True)
    a = [torch.tensor(d[k]) for k in ("xg", "pt", "ws", "wt", "m2")]
    cfg = (NS, NR, True)
    with pytest.raises(TypeError, match="one type"):
        _kernel_inputs(a[0], a[1].bfloat16(), *a[2:], K, cfg)
    with pytest.raises(ValueError, match="multiple of K"):
        _kernel_inputs(*a, 3, cfg)
    with pytest.raises(ValueError, match="pt has shape"):
        _kernel_inputs(a[0], a[1][:-1], *a[2:], K, cfg)
    with pytest.raises(ValueError, match="wt has shape"):
        _kernel_inputs(a[0], a[1][:NS * NR + NS], *a[2:], K, (NS, NR, False))
    wide = torch.zeros(a[0].shape[0], 160)
    with pytest.raises(ValueError, match="up to 128"):
        _kernel_inputs(wide, a[1], torch.zeros(NS * NR, 160),
                       torch.zeros(NS * NS * NR, 160), a[4], K, cfg)
