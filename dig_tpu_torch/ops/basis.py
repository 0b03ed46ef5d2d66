"""Radial and angular bases. Port of ``dig_tpu/ops/basis.py``.

SchNet's Gaussian smearing and cosine cutoff, and the DimeNet/SphereNet
bases: spherical Bessel functions normalised over their zeros and real
spherical harmonics Y_l^m, built symbolically with sympy once per
(num_spherical, num_radial) and lambdified to torch callables. The sympy
construction is a copy of the JAX package's (the port imports nothing of
it); only the module map differs (``_TORCH_MODULES``).
"""
from __future__ import annotations

import functools
import importlib
import math
import re
from typing import Callable, List, Tuple

import numpy as np
import torch


class _LazyModule:
    """A module imported at its first attribute access: sympy and scipy
    take seconds to import, and most importers of this module (every
    process that imports the package) never build a closed form."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


sym = _LazyModule("sympy")
sp = _LazyModule("scipy.special")


def brentq(*args, **kwargs):
    from scipy.optimize import brentq as _brentq
    return _brentq(*args, **kwargs)


def _Jn(r: float, n: int) -> float:
    """Spherical Bessel j_n evaluated via the half-integer Bessel J."""
    return np.sqrt(np.pi / (2 * r)) * sp.jv(n + 0.5, r)


@functools.lru_cache(maxsize=None)
def _Jn_zeros(n: int, k: int) -> Tuple[Tuple[float, ...], ...]:
    """First k positive zeros of j_0..j_{n-1} by interlacing bracketing."""
    zeros = np.zeros((n, k))
    zeros[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    roots = np.zeros(k + n - 1)
    for order in range(1, n):
        for j in range(k + n - 1 - order):
            roots[j] = brentq(_Jn, points[j], points[j + 1], (order,))
        points = roots.copy()
        zeros[order][:k] = roots[:k]
    return tuple(tuple(row) for row in zeros)


@functools.lru_cache(maxsize=None)
def _spherical_bessel_exprs(n: int) -> Tuple[sym.Expr, ...]:
    """Closed forms of j_0..j_{n-1} via the Rayleigh recursion."""
    x = sym.symbols("x")
    exprs = [sym.sin(x) / x]
    a = sym.sin(x) / x
    for i in range(1, n):
        b = sym.diff(a, x) / x
        exprs.append(sym.simplify(b * (-x) ** i))
        a = sym.simplify(b)
    return tuple(exprs)


@functools.lru_cache(maxsize=None)
def bessel_basis_exprs(n: int, k: int) -> Tuple[Tuple[sym.Expr, ...], ...]:
    """Normalized spherical-Bessel basis b_{l,m}(x) on x in (0, 1]."""
    zeros = np.array(_Jn_zeros(n, k))
    x = sym.symbols("x")
    forms = _spherical_bessel_exprs(n)
    out = []
    for order in range(n):
        row = []
        for i in range(k):
            norm = 1.0 / math.sqrt(0.5 * _Jn(zeros[order, i], order + 1) ** 2)
            row.append(sym.simplify(norm * forms[order].subs(x, zeros[order, i] * x)))
        out.append(tuple(row))
    return tuple(out)


def _sph_harm_prefactor(l: int, m: int) -> float:
    return math.sqrt(
        (2 * l + 1) * math.factorial(l - abs(m))
        / (4 * np.pi * math.factorial(l + abs(m)))
    )


@functools.lru_cache(maxsize=None)
def _assoc_legendre_exprs(L: int, zero_m_only: bool):
    z = sym.symbols("z")
    P: List[List[sym.Expr]] = [[sym.Integer(0)] * (j + 1) for j in range(L)]
    P[0][0] = sym.Integer(1)
    if L > 1:
        P[1][0] = z
        for j in range(2, L):
            P[j][0] = sym.simplify(
                ((2 * j - 1) * z * P[j - 1][0] - (j - 1) * P[j - 2][0]) / j)
        if not zero_m_only:
            for i in range(1, L):
                P[i][i] = sym.simplify((1 - 2 * i) * P[i - 1][i - 1])
                if i + 1 < L:
                    P[i + 1][i] = sym.simplify((2 * i + 1) * z * P[i][i])
                for j in range(i + 2, L):
                    P[j][i] = sym.simplify(
                        ((2 * j - 1) * z * P[j - 1][i]
                         - (i + j - 1) * P[j - 2][i]) / (j - i))
    return P


@functools.lru_cache(maxsize=None)
def real_sph_harm_exprs(L: int, zero_m_only: bool = True):
    """Real spherical harmonics Y_l^m(theta, phi) as sympy expressions.

    Returns list-of-lists: Y[l] has 2l+1 entries (m = 0, 1..l, -l..-1 layout
    matching the reference's indexing Y[l][m+l] after reordering; here we
    return m-major order [m=0, m=1.., m=-1..] consistent with reference
    ``real_sph_harm`` output Y[i][j] / Y[i][-j]).
    """
    theta, phi = sym.symbols("theta phi")
    z = sym.symbols("z")
    P = _assoc_legendre_exprs(L, zero_m_only)
    P = [[e.subs(z, sym.cos(theta)) if not isinstance(e, int) else e
          for e in row] for row in P]

    Y = [[sym.Integer(0)] * (2 * j + 1) for j in range(L)]
    for i in range(L):
        Y[i][0] = sym.simplify(_sph_harm_prefactor(i, 0) * P[i][0])
    if not zero_m_only:
        # cos(m phi) / sin(m phi) expansions
        S = [sym.Integer(0)]
        C = [sym.Integer(1)]
        xs, ys = sym.symbols("xs ys")
        for i in range(1, L):
            S.append(xs * S[i - 1] + ys * C[i - 1])
            C.append(xs * C[i - 1] - ys * S[i - 1])
        sub = {xs: sym.sin(theta) * sym.cos(phi), ys: sym.sin(theta) * sym.sin(phi)}
        S = [s.subs(sub) for s in S]
        C = [c.subs(sub) for c in C]
        for i in range(1, L):
            for j in range(1, i + 1):
                Y[i][j] = sym.simplify(
                    math.sqrt(2) * _sph_harm_prefactor(i, j) * C[j] * P[i][j])
                Y[i][-j] = sym.simplify(
                    math.sqrt(2) * _sph_harm_prefactor(i, -j) * S[j] * P[i][j])
    return Y


_TORCH_MODULES = [{"sin": torch.sin, "cos": torch.cos, "sqrt": torch.sqrt,
                   "pi": math.pi}, "math"]


def _lambdify(args, expr) -> Callable:
    if isinstance(expr, (int, float)) or expr.is_number:
        const = float(expr)
        return lambda *a: torch.full_like(a[0], const)
    return sym.lambdify(args, expr, modules=_TORCH_MODULES)


@functools.lru_cache(maxsize=None)
def make_bessel_funcs(num_spherical: int, num_radial: int):
    """b_{l, m}(x) callables, x = dist / cutoff in (0, 1]."""
    x = sym.symbols("x")
    exprs = bessel_basis_exprs(num_spherical, num_radial)
    return [[_lambdify([x], e) for e in row] for row in exprs]


@functools.lru_cache(maxsize=None)
def make_sph_funcs_m0(num_spherical: int):
    """Y_l^0(theta) callables (angle basis)."""
    theta = sym.symbols("theta")
    Y = real_sph_harm_exprs(num_spherical, zero_m_only=True)
    return [_lambdify([theta], Y[l][0]) for l in range(num_spherical)]


@functools.lru_cache(maxsize=None)
def make_sph_funcs_full(num_spherical: int):
    """Y_l^m(theta, phi) callables, l-major, each row in the storage order
    of ``real_sph_harm_exprs`` ([m=0, +1..+l, -l..-1]), the order the
    torsion basis consumes. l=0 is the constant 1/sqrt(4 pi)."""
    theta, phi = sym.symbols("theta phi")
    Y = real_sph_harm_exprs(num_spherical, zero_m_only=False)
    c0 = float(sym.simplify(Y[0][0]))
    funcs = [lambda t, p, c=c0: torch.full_like(t, c)]
    for l in range(1, num_spherical):
        for pos in range(2 * l + 1):
            funcs.append(_lambdify([theta, phi], Y[l][pos]))
    return funcs


def packed_basis_rows(num_spherical: int, num_radial: int, theta, phi, dk,
                      has_t: bool):
    """The rows of the packed basis tables (``ops.triplet_pt.basis_pt``,
    ``ops.triplet_slot.basis_pt_k``), each shaped as the per-triplet
    scalars: the Bessel functions of ``dk`` (l-major, n*k), Y_l^0(theta)
    (n), then, with ``has_t``, Y_l^m(theta, phi) (n*n)."""
    rows = [f(dk) for row in make_bessel_funcs(num_spherical, num_radial)
            for f in row]
    rows += [f(theta) for f in make_sph_funcs_m0(num_spherical)]
    if has_t:
        rows += [f(theta, phi) for f in make_sph_funcs_full(num_spherical)]
    return rows


@functools.lru_cache(maxsize=None)
def _packed_row_jets(num_spherical: int, num_radial: int, has_t: bool):
    """The sympy expressions behind :func:`packed_basis_rows`, in its row
    order, in the symbols (theta, phi, x), each with its gradient
    d/d(theta, phi, x) and its second derivatives (tt, tp, tx, pp, px,
    xx): a list of (row, [3], [6])."""
    rows = [e for row in bessel_basis_exprs(num_spherical, num_radial)
            for e in row]
    y0 = real_sph_harm_exprs(num_spherical, zero_m_only=True)
    rows += [y0[l][0] for l in range(num_spherical)]
    if has_t:
        y = real_sph_harm_exprs(num_spherical, zero_m_only=False)
        rows += [y[l][pos] for l in range(num_spherical)
                 for pos in range(2 * l + 1)]
    args = sym.symbols("theta phi x")
    jets = []
    for e in map(sym.sympify, rows):
        d1 = [sym.diff(e, a) for a in args]
        d2 = [sym.diff(e, args[i], args[j])
              for i in range(3) for j in range(i, 3)]
        jets.append((e, d1, d2))
    return jets


_LITERAL = re.compile(r"(?<![\w.])(\d+\.\d*(?:[eE][-+]?\d+)?|\d+[eE][-+]?\d+)")


def _c_expr(e) -> str:
    """``e`` as C++ in the real type ``R``: every floating literal wrapped
    as ``R(...)`` (17 digits, so R = double keeps them exact and R = float
    rounds them as a float literal would), small integer powers written as
    products, sin / cos / sqrt through the header's overloads."""
    from sympy.codegen.ast import float64, real
    from sympy.codegen.rewriting import (create_expand_pow_optimization,
                                         optimize)
    expand = create_expand_pow_optimization(16, base_req=lambda b: True)
    text = sym.ccode(optimize(e, [expand]), type_aliases={real: float64},
                     user_functions={"sin": "gsin", "cos": "gcos",
                                     "sqrt": "gsqrt"})
    if "pow" in text:
        raise ValueError(f"unexpanded power in the row code: {text}")
    return _LITERAL.sub(r"R(\1)", text)


def _c_case(r: int, exprs, out_names) -> List[str]:
    """One ``case r:`` of a generated switch: the common subexpressions of
    ``exprs`` as temporaries, then ``out_names[i] = exprs[i]``."""
    subs, reduced = sym.cse(exprs, symbols=sym.numbered_symbols("t"))
    lines = [f"    case {r}: {{"]
    lines += [f"      const R {s} = {_c_expr(e)};" for s, e in subs]
    lines += [f"      {o} = {_c_expr(e)};" for o, e in zip(out_names, reduced)]
    lines += ["      break;", "    }"]
    return lines


@functools.lru_cache(maxsize=None)
def basis_row_code(num_spherical: int, num_radial: int, has_t: bool) -> str:
    """C++ source of the packed basis rows (:func:`packed_basis_rows`'s
    order: Bessel l-major, Y_l^0, then with ``has_t`` Y_l^m) and of their
    first and second derivatives in (theta, phi, x = d_kj / cutoff), for
    the in-kernel basis of ``ops.triplet_slot.fused_triplet_slot_geom``.

    Printed from the same sympy closed forms the torch rows are lambdified
    from (derivatives by ``sym.diff``, common subexpressions by
    ``sym.cse``, integer powers written as products), as code templated on
    the real type R: the text compiles as CUDA device code (R = float in
    the kernels) and as plain C++. It defines, in ``namespace geom_rows``,
    ``ROWS`` and the functions ``row<R>(r, theta, phi, x)``,
    ``row_grad<R>(r, ..., g)`` (the value, and g = d/d(theta, phi, x)) and
    ``row_jet<R>(r, ..., g, h)`` (the value, g and h = the second
    derivatives (tt, tp, tx, pp, px, xx) from one set of common
    subexpressions: the second order's one evaluation of a row)."""
    jets = _packed_row_jets(num_spherical, num_radial, has_t)
    sig = "int r, R theta, R phi, R x"
    val, grad, jet = [], [], []
    g_names = ["g[0]", "g[1]", "g[2]"]
    h_names = [f"h[{i}]" for i in range(6)]
    for r, (e, d1, d2) in enumerate(jets):
        val += _c_case(r, [e], ["v"])
        grad += _c_case(r, [e] + d1, ["v"] + g_names)
        jet += _c_case(r, [e] + d1 + d2, ["v"] + g_names + h_names)
    head = [
        "// Generated by dig_tpu_torch/ops/basis.py (basis_row_code) from the",
        "// sympy closed forms of the packed basis rows: num_spherical="
        f"{num_spherical},",
        f"// num_radial={num_radial}, has_t={int(has_t)}. Do not edit.",
        "#pragma once",
        "#include <math.h>",
        "#ifdef __CUDACC__",
        "#define GEOM_ROW_FN __host__ __device__ inline",
        "#else",
        "#define GEOM_ROW_FN inline",
        "#endif",
        "namespace geom_rows {",
        f"constexpr int NUM_SPHERICAL = {num_spherical};",
        f"constexpr int NUM_RADIAL = {num_radial};",
        f"constexpr int HAS_T = {int(has_t)};",
        f"constexpr int ROWS = {len(jets)};",
        "GEOM_ROW_FN float gsin(float v) { return sinf(v); }",
        "GEOM_ROW_FN double gsin(double v) { return sin(v); }",
        "GEOM_ROW_FN float gcos(float v) { return cosf(v); }",
        "GEOM_ROW_FN double gcos(double v) { return cos(v); }",
        "GEOM_ROW_FN float gsqrt(float v) { return sqrtf(v); }",
        "GEOM_ROW_FN double gsqrt(double v) { return sqrt(v); }",
    ]
    tmpl = "template <typename R>"
    body = (
        [tmpl, f"GEOM_ROW_FN R row({sig}) {{", "  R v = R(0);",
         "  switch (r) {"] + val + ["  }", "  return v;", "}"]
        + [tmpl, f"GEOM_ROW_FN R row_grad({sig}, R* g) {{", "  R v = R(0);",
           "  g[0] = g[1] = g[2] = R(0);", "  switch (r) {"]
        + grad + ["  }", "  return v;", "}"]
        + [tmpl, f"GEOM_ROW_FN R row_jet({sig}, R* g, R* h) {{",
           "  R v = R(0);", "  g[0] = g[1] = g[2] = R(0);",
           "  for (int i = 0; i < 6; ++i) h[i] = R(0);", "  switch (r) {"]
        + jet + ["  }", "  return v;", "}", "}  // namespace geom_rows", ""])
    return "\n".join(head + body)


@functools.lru_cache(maxsize=None)
def basis_row_ops(num_spherical: int, num_radial: int, has_t: bool):
    """Operations of :func:`basis_row_code`'s functions summed over the
    rows, as sympy counts them after common subexpressions (a sine, a
    division or a product each one): ``{"row": .., "grad": .., "jet":
    ..}``. A lower bound on the work of one evaluation of all rows, for the
    kernels' bounds."""
    count = {"row": 0, "grad": 0, "jet": 0}
    for e, d1, d2 in _packed_row_jets(num_spherical, num_radial, has_t):
        for key, exprs in (("row", [e]), ("grad", [e] + d1),
                           ("jet", [e] + d1 + d2)):
            subs, reduced = sym.cse(exprs)
            count[key] += int(sum(sym.count_ops(t) for _, t in subs)
                              + sum(sym.count_ops(t) for t in reduced))
    return count


def bessel_table(num_spherical: int, num_radial: int, x: torch.Tensor):
    """All (l, m) Bessel basis functions: ``[..., n_s, n_r]``."""
    fs = make_bessel_funcs(num_spherical, num_radial)
    rows = [torch.stack([f(x) for f in row], dim=-1) for row in fs]
    return torch.stack(rows, dim=-2)


def sph_m0_table(num_spherical: int, theta: torch.Tensor):
    """Y_l^0 for all l: ``[..., n_s]``."""
    return torch.stack([f(theta) for f in make_sph_funcs_m0(num_spherical)],
                       dim=-1)


def sph_full_table(num_spherical: int, theta: torch.Tensor,
                   phi: torch.Tensor):
    """All Y_l^m: ``[..., n_s**2]`` (l-major, reference order)."""
    return torch.stack([f(theta, phi)
                        for f in make_sph_funcs_full(num_spherical)], dim=-1)


class Envelope:
    """Polynomial cutoff envelope u(x) = 1/x + a x^(p-1) + b x^p +
    c x^(p+1) (DimeNet eq. 8)."""

    def __init__(self, exponent: int):
        self.p = exponent + 1
        self.a = -(self.p + 1) * (self.p + 2) / 2
        self.b = self.p * (self.p + 2)
        self.c = -self.p * (self.p + 1) / 2

    def __call__(self, x):
        p, a, b, c = self.p, self.a, self.b, self.c
        x_p0 = x ** (p - 1)
        x_p1 = x_p0 * x
        x_p2 = x_p1 * x
        return 1.0 / x + a * x_p0 + b * x_p1 + c * x_p2


def gaussian_rbf(dist: torch.Tensor, start: float, stop: float,
                 num_gaussians: int) -> torch.Tensor:
    """SchNet Gaussian smearing: ``[..., num_gaussians]``."""
    offset = torch.linspace(start, stop, num_gaussians, dtype=dist.dtype,
                            device=dist.device)
    coeff = -0.5 / float((stop - start) / (num_gaussians - 1)) ** 2
    d = dist[..., None] - offset
    return torch.exp(coeff * d * d)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """0.5 (cos(pi d / c) + 1) smooth cutoff."""
    return 0.5 * (torch.cos(dist * (math.pi / cutoff)) + 1.0)
