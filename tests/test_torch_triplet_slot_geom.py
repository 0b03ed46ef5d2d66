"""Port's fused_triplet_slot_geom (on the CPU: its plain version) vs the JAX
package's, and the generated row code of its kernels, float32.

The JAX op runs its Pallas kernel in interpret mode, at the shape of
tests/test_pallas_triplet_slot.py:138 (A = 5, K = 4, G = 3, C = 8, n = 3,
k = 2). Tolerances, as the largest error over the largest reference value:
forward 1e-5 (float32 sums in another order); first order 2e-4 and
reverse over reverse through geo 1e-3 (the bounds of the JAX package's own
comparison of this op with the pt chain: the rows' derivatives come from
other expressions on each side, autograd of the closed forms against the
kernel bodies' trace-time vjp). Against the port's pt chain (basis_pt_k
into fused_triplet_slot, the same closed forms differentiated by the same
autograd): 1e-5, 1e-5 and 1e-4.

The generated row code (ops/basis.py basis_row_code: the row and
gradient functions, and the fused jet that also gives the second
derivatives) is compiled with g++ as plain C++ in double and held to torch
autograd of packed_basis_rows in double at 1e-6 of the largest value of each derivative order: a wrong
derivative is an O(1) error, while both sides evaluate the same closed
forms. The same text in float is held to the float64 values at 1e-4, at
d_kj / cutoff in [0.3, 1], where the closed forms do not cancel.
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.pallas_triplet_slot import \
    fused_triplet_slot_geom as j_geom
from dig_tpu_torch.ops.basis import basis_row_code, packed_basis_rows
from dig_tpu_torch.ops.triplet_slot import (basis_pt_k, fused_triplet_slot,
                                            fused_triplet_slot_geom)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _inputs(has_t, A=5, K=4, G=3, C=8, ns=3, nr=2, seed=7, dk_masked=None):
    rng = np.random.default_rng(seed)
    E = G * A * K
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    m2T = (rng.random((K, E)) > 0.3).astype(np.float32)
    th = rng.uniform(0.1, 3.0, (K, E)).astype(np.float32)
    ph = rng.uniform(0.0, 6.2, (K, E)).astype(np.float32)
    dk = rng.uniform(0.1, 1.0, (K, E)).astype(np.float32)
    if dk_masked is not None:
        dk[m2T == 0] = dk_masked
    geo = np.stack([th, ph, dk] if has_t else [th, dk], axis=1)
    d = dict(x=f(E, C), geo=geo, ws=f(ns * nr, C),
             wt=f((ns * ns * nr) if has_t else 1, C), m2T=m2T,
             lj=rng.integers(0, A, size=(1, E)).astype(np.int32),
             w_out=f(E, C))
    return d, (A, K, (ns, nr, has_t))


def _torch_levels(fn, d, A, K, cfg):
    """(out, first-order grads of <out, w_out> w.r.t. (x, geo, ws, wt),
    grads of sum(dgeo^2) w.r.t. (x, geo)) through the port's tower."""
    ts = {k: torch.tensor(v) for k, v in d.items()}
    xs = [ts[k].clone().requires_grad_() for k in ("x", "geo", "ws", "wt")]
    out = fn(*xs, ts["m2T"], ts["lj"], A, K, cfg)
    g = torch.autograd.grad((out * ts["w_out"]).sum(), xs, create_graph=True,
                            allow_unused=True)
    h = torch.autograd.grad((g[1] ** 2).sum(), xs[:2], allow_unused=True)
    first = [np.zeros(x.shape, np.float32) if t is None
             else t.detach().numpy() for t, x in zip(g, xs)]
    return out.detach().numpy(), first, [t.numpy() for t in h]


def _jax_levels(d, A, K, cfg):
    m2T, lj, w_out = (jnp.asarray(d[k]) for k in ("m2T", "lj", "w_out"))

    def f(x, geo, ws, wt):
        return jnp.sum(j_geom(x, geo, ws, wt, m2T, lj, A, K, cfg) * w_out)

    args = [jnp.asarray(d[k]) for k in ("x", "geo", "ws", "wt")]
    out = j_geom(*args, m2T, lj, A, K, cfg)
    first = jax.grad(f, argnums=(0, 1, 2, 3))(*args)

    def h(x, geo):
        return jnp.sum(jax.grad(lambda g: f(x, g, *args[2:]))(geo) ** 2)
    second = jax.grad(h, argnums=(0, 1))(*args[:2])
    return (np.asarray(out), [np.asarray(t) for t in first],
            [np.asarray(t) for t in second])


def _pt_chain(x, geo, ws, wt, m2T, lj, A, K, cfg):
    ns, nr, has_t = cfg
    pt = basis_pt_k(ns, nr, geo[:, 0], geo[:, 1] if has_t else None,
                    geo[:, -1], has_t)
    return fused_triplet_slot(x, pt, ws, wt, m2T, lj, A, K, cfg)


@pytest.mark.parametrize("has_t", [True, False])
def test_matches_jax_geom_op(has_t):
    d, (A, K, cfg) = _inputs(has_t)
    out, first, second = _torch_levels(fused_triplet_slot_geom, d, A, K, cfg)
    out_j, first_j, second_j = _jax_levels(d, A, K, cfg)
    assert _rel(out, out_j) < 1e-5
    for name, a, b in zip(["dx", "dgeo", "dws", "dwt"], first, first_j):
        if name == "dwt" and not has_t:
            continue
        assert _rel(a, b) < 2e-4, name
    for name, a, b in zip(["ddx", "ddgeo"], second, second_j):
        assert np.abs(b).max() > 0, name
        assert _rel(a, b) < 1e-3, name


@pytest.mark.parametrize("has_t", [True, False])
def test_matches_port_pt_chain(has_t):
    """Where every rounding is the identity (f32) the geometry op and the
    pt chain compute the same function: the rows are the same closed
    forms, differentiated by the same autograd (evaluated in float64 and
    rounded on one side, in float32 on the other, which at these distances
    agree to float32 rounding)."""
    d, (A, K, cfg) = _inputs(has_t, seed=11)
    got = _torch_levels(fused_triplet_slot_geom, d, A, K, cfg)
    want = _torch_levels(_pt_chain, d, A, K, cfg)
    assert _rel(got[0], want[0]) < 1e-5
    for a, b in zip(got[1], want[1]):
        if np.abs(b).max() > 0:
            assert _rel(a, b) < 1e-5
    for a, b in zip(got[2], want[2]):
        assert _rel(a, b) < 1e-4


def test_masked_lanes_at_zero_distance():
    """Masked triplets with d_kj = 0 (padding): the rows are evaluated at
    d_kj / cutoff = 1 there, so every derivative level is finite and the
    geometry gradient is exactly 0 at a masked triplet."""
    d, (A, K, cfg) = _inputs(True, seed=3, dk_masked=0.0)
    out, first, second = _torch_levels(fused_triplet_slot_geom, d, A, K, cfg)
    for t in [out] + first + second:
        assert np.isfinite(t).all()
    masked = np.broadcast_to((d["m2T"] == 0)[:, None, :], first[1].shape)
    assert np.all(first[1][masked] == 0)
    assert np.all(second[1][masked] == 0)
    assert np.abs(first[1][~masked]).max() > 0


def test_dimenetpp_rows_match_jax():
    """n = 7 without torsion (DimeNet++'s 49 rows), forward and first
    order against the JAX op."""
    d, (A, K, cfg) = _inputs(False, ns=7, nr=2, seed=5)
    d["geo"][:, 1] = np.maximum(d["geo"][:, 1], 0.3)   # d_kj / cutoff
    out, first, _ = _torch_levels(fused_triplet_slot_geom, d, A, K, cfg)
    m2T, lj = jnp.asarray(d["m2T"]), jnp.asarray(d["lj"])
    args = [jnp.asarray(d[k]) for k in ("x", "geo", "ws", "wt")]
    assert _rel(out, j_geom(*args, m2T, lj, A, K, cfg)) < 1e-5
    first_j = jax.grad(lambda *a: jnp.sum(
        j_geom(*a, m2T, lj, A, K, cfg) * d["w_out"]), argnums=(0, 1, 2))(
            *args)
    for name, a, b in zip(["dx", "dgeo", "dws"], first, first_j):
        assert _rel(a, b) < 2e-4, name


_EVAL_SRC = r'''
#include "geom_rows.cuh"
typedef REAL F;
extern "C" void eval_rows(int npts, const F* th, const F* ph, const F* x,
                          F* val, F* grad, F* hess) {
  for (int i = 0; i < npts; ++i)
    for (int r = 0; r < geom_rows::ROWS; ++r) {
      F g[3], gj[3], h[6];
      const F v = geom_rows::row<F>(r, th[i], ph[i], x[i]);
      geom_rows::row_grad<F>(r, th[i], ph[i], x[i], g);
      geom_rows::row_jet<F>(r, th[i], ph[i], x[i], gj, h);
      val[r * npts + i] = v;
      for (int j = 0; j < 3; ++j) grad[(r * 3 + j) * npts + i] = g[j];
      for (int j = 0; j < 6; ++j) hess[(r * 6 + j) * npts + i] = h[j];
    }
}
'''

# the fused jet: value, gradient and second derivatives from one call
_EVAL_JET_SRC = r'''
#include "geom_rows.cuh"
typedef REAL F;
extern "C" void eval_rows(int npts, const F* th, const F* ph, const F* x,
                          F* val, F* grad, F* hess) {
  for (int i = 0; i < npts; ++i)
    for (int r = 0; r < geom_rows::ROWS; ++r) {
      F g[3], h[6];
      val[r * npts + i] = geom_rows::row_jet<F>(r, th[i], ph[i], x[i], g, h);
      for (int j = 0; j < 3; ++j) grad[(r * 3 + j) * npts + i] = g[j];
      for (int j = 0; j < 6; ++j) hess[(r * 6 + j) * npts + i] = h[j];
    }
}
'''


def _compiled_rows(tmp_path, cfg, real, src=_EVAL_SRC):
    code = basis_row_code(*cfg)
    d = tmp_path / f"{real}_{cfg[0]}_{cfg[1]}_{int(cfg[2])}"
    d.mkdir()
    (d / "geom_rows.cuh").write_text(code)
    (d / "eval_rows.cpp").write_text(src)
    lib = d / "rows.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", f"-DREAL={real}",
                    "-I", str(d), "-o", str(lib), str(d / "eval_rows.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _autograd_rows(cfg, th, ph, x):
    """Values [R, P], gradients [R, 3, P] and second derivatives [R, 6, P]
    of packed_basis_rows in float64, by autograd."""
    ins = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in (th, ph, x)]
    rows = packed_basis_rows(cfg[0], cfg[1], *ins, cfg[2])
    R, P = len(rows), len(th)
    val = torch.stack([r.detach() for r in rows]).numpy()
    grad, hess = np.zeros((R, 3, P)), np.zeros((R, 6, P))
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    for r, row in enumerate(rows):
        if not row.requires_grad:
            continue
        gs = torch.autograd.grad(row.sum(), ins, create_graph=True,
                                 allow_unused=True)
        for i, g in enumerate(gs):
            if g is not None:
                grad[r, i] = g.detach().numpy()
        for q, (i, j) in enumerate(pairs):
            if gs[i] is not None and gs[i].requires_grad:
                h = torch.autograd.grad(gs[i].sum(), ins[j], retain_graph=True,
                                        allow_unused=True)[0]
                if h is not None:
                    hess[r, q] = h.numpy()
    return val, grad, hess


def _check_row_code(tmp_path, cfg, src):
    """The generated rows through ``src`` (g++, double and float) against
    autograd of packed_basis_rows in double."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the generated code is checked "
                    "as plain C++ with it")
    rng = np.random.default_rng(0)
    P = 400
    th = rng.uniform(0.05, 3.1, P)
    ph = rng.uniform(-3.1, 3.1, P)
    x = rng.uniform(0.05, 1.0, P)
    want = _autograd_rows(cfg, th, ph, x)
    R = want[0].shape[0]
    for real, np_t, lo, tol in (("double", np.float64, 0.05, 1e-6),
                                ("float", np.float32, 0.3, 1e-4)):
        sel = x >= lo
        ins = [np.ascontiguousarray(a[sel], np_t) for a in (th, ph, x)]
        n = int(sel.sum())
        outs = [np.zeros((R, n), np_t), np.zeros((R, 3, n), np_t),
                np.zeros((R, 6, n), np_t)]
        lib = _compiled_rows(tmp_path, cfg, real, src)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.eval_rows(ctypes.c_int(n), *map(ptr, ins + outs))
        for name, a, b in zip(["rows", "gradients", "second derivatives"],
                              outs, want):
            assert _rel(a, b[..., sel]) < tol, (real, name)


@pytest.mark.parametrize("cfg", [(3, 2, True), (3, 6, False)],
                         ids=["n3k2_torsion", "n3k6"])
def test_generated_row_code_matches_autograd(tmp_path, cfg):
    _check_row_code(tmp_path, cfg, _EVAL_SRC)


@pytest.mark.parametrize("cfg", [(3, 2, True), (3, 6, False), (3, 6, True)],
                         ids=["n3k2_torsion", "n3k6", "n3k6_torsion"])
def test_generated_row_jet_matches_autograd(tmp_path, cfg):
    """row_jet, the second order's fused evaluation (one set of common
    subexpressions for the value, gradient and second derivatives)."""
    _check_row_code(tmp_path, cfg, _EVAL_JET_SRC)
