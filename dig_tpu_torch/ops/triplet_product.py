"""Fused triplet interaction on the [N, K] neighbour-table layout, for
SphereNet (``fused_triplet_product``) and DimeNet++ (``fused_angle_product``,
no torsion). Port of ``dig_tpu/ops/pallas_triplet.py``.

    out[e] = sum_k mask2d[e, k] * xg[e*K + k] * (sbf[e*K + k] @ ws)
                                              * (tbf[e*K + k] @ wt)

``xg [T, C]`` (T = E*K; raw ``expand_kj_raw`` rows may hold garbage where
the mask is 0), ``sbf [T, S1]``, ``tbf [T, S2]``, ``ws [S1, C]``,
``wt [S2, C]`` and ``mask2d [E, K]`` in one type; the output ``[E, C]`` in
``xg``'s. Every product and sum is float32 and each output is rounded to
its type once, as the TPU kernel computes (its XLA oracle
``fused_triplet_product_ref`` instead rounds the two basis projections to
the input type; in float32 the two agree). The backward zeroes every
cotangent row at a masked triplet, which licenses ``expand_kj_raw``'s
mask-free adjoint.

Differentiable to second order with ``basis_grads=True``, as the JAX op's
custom_vjp tower (``fused_triplet_product`` -> ``_bwd_t_op`` /
``_bwd_a_op`` -> ``_run_bwd2``): the backward of :class:`_TripletProduct`
is the Function :class:`_TripletProductBwd`, whose own backward is the
second-order VJP. ``basis_grads=False`` gives zero basis cotangents (valid
only where the bases reach no differentiated input: energy training) and
is first order only. On a CUDA tensor every level launches a hand-written
kernel of ``csrc/triplet_product.cu`` or raises; on a CPU tensor each runs
its plain version (``fused_triplet_product_reference``,
``fused_triplet_product_bwd_reference``,
``fused_triplet_product_bwd2_reference``: the algebra of the TPU kernels
``_fwd_kernel``, ``_bwd_kernel`` and ``_bwd2_kernel``). ``launches_fwd``,
``launches_bwd`` and ``launches_bwd2`` count kernel launches
(``launches_bwd_basis`` the backward launches that computed the basis
cotangents). As in ``ops/triplet_slot.py``, a backward computes them only
when the backward pass now running will use them, so a force step's outer
pass (``loss.backward(inputs=params)``) leaves them out.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .triplet_slot import _grad_wanted

launches_fwd = 0
launches_bwd = 0
launches_bwd2 = 0
launches_bwd_basis = 0   # of launches_bwd: those that computed dsbf / dtbf

_SHAPES = "C must be at most 128"


def reset_launch_counts() -> None:
    global launches_fwd, launches_bwd, launches_bwd2, launches_bwd_basis
    launches_fwd = 0
    launches_bwd = 0
    launches_bwd2 = 0
    launches_bwd_basis = 0


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _f(t):
    return None if t is None else t.float()


def _mm(a, b):
    """``a @ b`` in float32, 0 when either factor is absent."""
    return 0.0 if a is None or b is None else a @ b


def _masked_ct(ct, mask2d, K):
    """``ct[e] * mask2d[e, k]`` on triplet rows ``[T, C]``, float32."""
    return (ct.float().repeat_interleave(K, dim=0)
            * mask2d.float().reshape(-1, 1))


def fused_triplet_product_reference(xg, sbf, tbf, ws, wt, K: int,
                                    mask2d=None) -> torch.Tensor:
    """Plain forward ``[E, C]`` in ``xg``'s type; ``tbf``/``wt`` None
    without torsion; ``mask2d`` defaults to all ones."""
    prod = xg.float() * (sbf.float() @ ws.float())
    if tbf is not None:
        prod = prod * (tbf.float() @ wt.float())
    E = xg.shape[0] // K
    prod = prod.reshape(E, K, xg.shape[1])
    if mask2d is not None:
        prod = prod * mask2d.float()[:, :, None]
    return prod.sum(dim=1).to(xg.dtype)


def fused_triplet_product_bwd_reference(xg, sbf, tbf, ws, wt, mask2d, ct,
                                        K: int, basis_grads: bool = True):
    """Plain first-order VJP ``(dxg, dsbf, dtbf, dws, dwt)`` against the
    output cotangent ``ct [E, C]``, in the types of ``_run_bwd``: each in
    its input's type (``dws``/``dwt`` summed in float32 first). Without
    ``basis_grads`` ``dsbf``/``dtbf`` are zeros; without torsion ``dtbf``
    and ``dwt`` are None."""
    has_t = tbf is not None
    x, sb_, ws_ = xg.float(), sbf.float(), ws.float()
    cm = _masked_ct(ct, mask2d, K)
    s = sb_ @ ws_
    if has_t:
        tb_, wt_ = tbf.float(), wt.float()
        t = tb_ @ wt_
        dxg = cm * s * t
        gs = cm * x * t
        gt = cm * x * s
    else:
        dxg = cm * s
        gs = cm * x
    dtbf = dwt = None
    if basis_grads:
        dsbf = (gs @ ws_.t()).to(sbf.dtype)
        if has_t:
            dtbf = (gt @ wt_.t()).to(tbf.dtype)
    else:
        dsbf = torch.zeros_like(sbf)
        dtbf = torch.zeros_like(tbf) if has_t else None
    dws = (sb_.t() @ gs).to(ws.dtype)
    if has_t:
        dwt = (tb_.t() @ gt).to(wt.dtype)
    return dxg.to(xg.dtype), dsbf, dtbf, dws, dwt


def fused_triplet_product_bwd2_reference(xg, sbf, tbf, ws, wt, mask2d, ct,
                                         u1, u2, u3, u4, u5, K: int):
    """Plain second-order VJP: the cotangents ``u1..u5`` of ``(dxg, dsbf,
    dtbf, dws, dwt)`` pulled back to ``(xb, sb, tb, wsb, wtb, ctb)``, the
    gradients with respect to ``(xg, sbf, tbf, ws, wt, ct)``, in the types
    of ``_run_bwd2`` (each in its input's type). Any ``u`` may be None (its
    terms vanish); without torsion ``u3``, ``u5``, ``tb`` and ``wtb`` are
    None. The algebra of ``_bwd2_kernel``'s docstring."""
    has_t = tbf is not None
    T, C = xg.shape
    x, sb_, ws_ = xg.float(), sbf.float(), ws.float()
    u1, u2, u4 = _f(u1), _f(u2), _f(u4)
    cm = _masked_ct(ct, mask2d, K)
    if u1 is None:
        u1 = torch.zeros_like(x)
    s = sb_ @ ws_
    P = _mm(u2, ws_) + _mm(sb_, u4)
    tb = wtb = None
    if has_t:
        tb_, wt_, u3, u5 = tbf.float(), wt.float(), _f(u3), _f(u5)
        t = tb_ @ wt_
        Q = _mm(u3, wt_) + _mm(tb_, u5)
        g_s = cm * x * s
        g_t = cm * x * t
        core = t * P + s * Q
        A = cm * (t * u1 + x * Q)
        B = cm * (s * u1 + x * P)
        tb = (B @ wt_.t() + _mm(g_s, None if u5 is None else u5.t())
              ).to(tbf.dtype)
        integ = u1 * s * t + x * core
        wtb = (tb_.t() @ B + _mm(None if u3 is None else u3.t(), g_s)
               ).to(wt.dtype)
    else:
        g_t = cm * x
        core = P
        A = cm * u1
        integ = u1 * s + x * core
    xb = (cm * core).to(xg.dtype)
    sb = (A @ ws_.t() + _mm(g_t, None if u4 is None else u4.t())
          ).to(sbf.dtype)
    wsb = (sb_.t() @ A + _mm(None if u2 is None else u2.t(), g_t)
           ).to(ws.dtype)
    E = T // K
    ctb = (integ * mask2d.float().reshape(-1, 1)).reshape(E, K, C).sum(
        dim=1).to(ct.dtype)
    return xb, sb, tb, wsb, wtb, ctb


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _build.load("triplet_product")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.triplet_product_blocks.argtypes = [I] * 7
        lib.triplet_product_blocks.restype = I
        lib.triplet_product_fwd.argtypes = [P] * 7 + [I] * 6 + [P]
        lib.triplet_product_fwd.restype = I
        lib.triplet_product_bwd.argtypes = [P] * 12 + [I] * 7 + [P]
        lib.triplet_product_bwd.restype = I
        lib.triplet_product_bwd2.argtypes = [P] * 18 + [I] * 6 + [P]
        lib.triplet_product_bwd2.restype = I
        lib._argtypes_set = True
    return lib


def _check(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"fused_triplet_product: {name} on {t.device}, xg "
                         f"on {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_triplet_product: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")


def _kernel_inputs(xg, sbf, tbf, ws, wt, mask2d, K):
    """Validate shapes, devices and types; return the kernel's operands
    (xg, sbf, tbf and mask2d in their shared type, ws and wt float32)."""
    T, C = xg.shape
    if K <= 0 or T % K or T == 0:
        raise ValueError(f"fused_triplet_product: {T} triplet rows is not a "
                         f"positive multiple of K={K}")
    E, S1 = T // K, sbf.shape[-1]
    want = {"sbf": (sbf, (T, S1)), "ws": (ws, (S1, C)),
            "mask2d": (mask2d, (E, K))}
    if tbf is not None:
        want["tbf"] = (tbf, (T, tbf.shape[-1]))
        want["wt"] = (wt, (tbf.shape[-1], C))
    for name, (t, shape) in want.items():
        _check(name, t, shape, xg.device)
    same = [t.dtype for t in (sbf, tbf, mask2d) if t is not None]
    if xg.dtype not in (torch.float32, torch.bfloat16) or \
            any(d != xg.dtype for d in same):
        raise TypeError(f"fused_triplet_product kernel takes xg, sbf, tbf and "
                        f"mask2d of one type, float32 or bfloat16; got "
                        f"{xg.dtype} and {same}")
    if C > 128:
        raise ValueError(f"fused_triplet_product kernel takes C up to 128; "
                         f"got C={C}")
    c = lambda t: None if t is None else t.contiguous()
    return (c(xg), c(sbf), c(tbf), ws.float().contiguous(),
            None if wt is None else wt.float().contiguous(), c(mask2d))


def _widths(xg, sbf, tbf, K):
    T, C = xg.shape
    return T // K, C, sbf.shape[1], (0 if tbf is None else tbf.shape[1])


def triplet_product_forward_kernel(xg, sbf, tbf, ws, wt, mask2d, K):
    """Launch the forward kernel on validated operands; ``[E, C]`` in
    ``xg``'s type."""
    global launches_fwd
    E, C, S1, S2 = _widths(xg, sbf, tbf, K)
    out = torch.empty((E, C), dtype=xg.dtype, device=xg.device)
    rc = _library().triplet_product_fwd(
        *map(_build.ptr, (xg, sbf, tbf, ws, wt, mask2d, out)), E, K, C, S1,
        S2, int(xg.dtype == torch.bfloat16), _build.stream(xg.device))
    _build.check(rc, "triplet_product forward kernel", _SHAPES)
    launches_fwd += 1
    return out


def _weight_split(dw, S1, S2, C):
    return dw[:S1 * C].view(S1, C), (dw[S1 * C:].view(S2, C) if S2 else None)


def _scratch(lib, E, K, C, S1, S2, bf16, second_order, dev):
    """The weight partials of a backward (``second_order`` 0) or
    second-order launch, one row a block, and their sum."""
    blocks = lib.triplet_product_blocks(E, K, C, S1, S2, bf16, second_order)
    if blocks <= 0:
        _build.check(blocks, "triplet_product backward kernel's grid",
                     _SHAPES)
    return (torch.empty((blocks, (S1 + S2) * C), dtype=torch.float32,
                        device=dev),
            torch.empty((S1 + S2) * C, dtype=torch.float32, device=dev))


def triplet_product_backward_kernel(xg, sbf, tbf, ws, wt, mask2d, ct, K,
                                    basis_grads):
    """Launch the backward kernel on validated operands (``ct`` float32
    ``[E, C]``); returns ``(dxg, dsbf, dtbf, dws, dwt)``: the rows in
    ``xg``'s type (``dsbf``/``dtbf`` None without ``basis_grads``), the
    weight gradients float32."""
    global launches_bwd, launches_bwd_basis
    E, C, S1, S2 = _widths(xg, sbf, tbf, K)
    dev, bf16 = xg.device, int(xg.dtype == torch.bfloat16)
    lib = _library()
    dxg = torch.empty_like(xg)
    dsbf = torch.empty_like(sbf) if basis_grads else None
    dtbf = torch.empty_like(tbf) if basis_grads and S2 else None
    partial, dw = _scratch(lib, E, K, C, S1, S2, bf16, 0, dev)
    rc = lib.triplet_product_bwd(
        *map(_build.ptr, (xg, sbf, tbf, ws, wt, mask2d, ct, dxg, dsbf, dtbf,
                          partial, dw)),
        E, K, C, S1, S2, bf16, int(bool(basis_grads)), _build.stream(dev))
    _build.check(rc, "triplet_product backward kernel", _SHAPES)
    launches_bwd += 1
    launches_bwd_basis += int(bool(basis_grads))
    return (dxg, dsbf, dtbf, *_weight_split(dw, S1, S2, C))


def triplet_product_bwd2_kernel(xg, sbf, tbf, ws, wt, mask2d, ct, u1, u2,
                                u3, u4, u5, K):
    """Launch the second-order kernel on validated operands (``ct``
    float32 ``[E, C]``); ``u1..u5`` are the cotangents of ``(dxg, dsbf,
    dtbf, dws, dwt)``, each None when absent. Returns ``(xb, sb, tb, wsb,
    wtb, ctb)``: the rows in ``xg``'s type, the rest float32 (``tb``,
    ``wtb`` None without torsion)."""
    global launches_bwd2
    E, C, S1, S2 = _widths(xg, sbf, tbf, K)
    dev, dt = xg.device, xg.dtype
    if not S2:
        u3 = u5 = None
    for name, u, shape in (("u1", u1, tuple(xg.shape)),
                           ("u2", u2, tuple(sbf.shape)),
                           ("u3", u3, (E * K, S2)), ("u4", u4, (S1, C)),
                           ("u5", u5, (S2, C))):
        if u is not None:
            _check(name, u, shape, dev)
    c = lambda u, d: None if u is None else u.to(d).contiguous()
    u1, u2, u3 = c(u1, dt), c(u2, dt), c(u3, dt)
    u4, u5 = c(u4, torch.float32), c(u5, torch.float32)
    lib = _library()
    xb = torch.empty_like(xg)
    sb = torch.empty_like(sbf)
    tb = torch.empty_like(tbf) if S2 else None
    ctb = torch.empty((E, C), dtype=torch.float32, device=dev)
    partial, dw = _scratch(lib, E, K, C, S1, S2, int(dt == torch.bfloat16), 1,
                           dev)
    rc = lib.triplet_product_bwd2(
        *map(_build.ptr, (xg, sbf, tbf, ws, wt, mask2d, ct, u1, u2, u3, u4,
                          u5, xb, sb, tb, ctb, partial, dw)),
        E, K, C, S1, S2, int(dt == torch.bfloat16), _build.stream(dev))
    _build.check(rc, "triplet_product second-order kernel", _SHAPES)
    launches_bwd2 += 1
    wsb, wtb = _weight_split(dw, S1, S2, C)
    return xb, sb, tb, wsb, wtb, ctb


# ---------------------------------------------------------------------------
# the autograd tower: _TripletProduct -> _TripletProductBwd -> second order
# ---------------------------------------------------------------------------

def _to(g, t):
    return None if g is None or t is None else g.to(t.dtype)


def _backward(xg, sbf, tbf, ws, wt, mask2d, ct, K, basis_grads):
    """First-order VJP in the op's types: the kernel on the card (basis
    cotangents None unless ``basis_grads``), the plain version on the CPU
    (zeros there)."""
    if xg.is_cuda:
        dxg, dsbf, dtbf, dws, dwt = triplet_product_backward_kernel(
            *_kernel_inputs(xg, sbf, tbf, ws, wt, mask2d, K),
            ct.float().contiguous(), K, basis_grads)
        return dxg, dsbf, dtbf, _to(dws, ws), _to(dwt, wt)
    return fused_triplet_product_bwd_reference(xg, sbf, tbf, ws, wt, mask2d,
                                               ct, K, basis_grads)


@once_differentiable
def _backward_once(ctx, ct):
    """``basis_grads=False``: the first-order VJP with zero basis
    cotangents, not differentiable again (the JAX ``_run_bwd``)."""
    K, _ = ctx.meta
    xg, sbf, tbf, ws, wt, mask2d = ctx.saved_tensors
    need = ctx.needs_input_grad
    dxg, _, _, dws, dwt = _backward(xg, sbf, tbf, ws, wt, mask2d, ct, K,
                                    False)
    zeros = lambda t, n: torch.zeros_like(t) if n and t is not None else None
    return dxg, zeros(sbf, need[1]), zeros(tbf, need[2]), dws, dwt


class _TripletProduct(torch.autograd.Function):
    """The contraction. CUDA tensors: the forward kernel; CPU tensors: the
    plain version. With ``basis_grads`` its backward is
    :class:`_TripletProductBwd`, so a backward taken with ``create_graph``
    is differentiable again."""

    @staticmethod
    def forward(ctx, xg, sbf, tbf, ws, wt, mask2d, K, basis_grads):
        ctx.meta = (K, basis_grads)
        # the inputs themselves, so a second-order pass reaches ws and wt
        ctx.save_for_backward(xg, sbf, tbf, ws, wt, mask2d)
        if xg.is_cuda:
            return triplet_product_forward_kernel(
                *_kernel_inputs(xg, sbf, tbf, ws, wt, mask2d, K), K)
        return fused_triplet_product_reference(xg, sbf, tbf, ws, wt, K,
                                               mask2d)

    @staticmethod
    def backward(ctx, ct):
        K, basis_grads = ctx.meta
        need = ctx.needs_input_grad
        if basis_grads:
            xg, sbf, tbf, ws, wt, mask2d = ctx.saved_tensors
            grads = _TripletProductBwd.apply(
                xg, sbf, tbf, ws, wt, mask2d, ct, K,
                _grad_wanted(ctx, 1) or _grad_wanted(ctx, 2))
        else:
            grads = _backward_once(ctx, ct)
        return tuple(g if n else None for g, n in zip(grads, need[:5])) + (
            None, None, None)


class _TripletProductBwd(torch.autograd.Function):
    """First-order VJP ``(xg, sbf, tbf, ws, wt, ct) -> (dxg, dsbf, dtbf,
    dws, dwt)`` (``dsbf``/``dtbf`` None unless asked for). CUDA tensors:
    the backward kernel; CPU tensors: the plain version. Its backward is
    the second-order VJP (the JAX ``_bwd_t_op`` / ``_bwd_a_op`` rule);
    absent cotangents arrive as None and their terms are skipped."""

    @staticmethod
    def forward(ctx, xg, sbf, tbf, ws, wt, mask2d, ct, K, need_basis):
        ctx.set_materialize_grads(False)
        ctx.meta = K
        ctx.save_for_backward(xg, sbf, tbf, ws, wt, mask2d, ct)
        dxg, dsbf, dtbf, dws, dwt = _backward(xg, sbf, tbf, ws, wt, mask2d,
                                              ct, K, need_basis)
        if not need_basis:
            dsbf = dtbf = None
        return dxg, dsbf, dtbf, dws, dwt

    @staticmethod
    @once_differentiable
    def backward(ctx, u1, u2, u3, u4, u5):
        K = ctx.meta
        xg, sbf, tbf, ws, wt, mask2d, ct = ctx.saved_tensors
        need = ctx.needs_input_grad
        if all(u is None for u in (u1, u2, u3, u4, u5)):
            return (None,) * 9
        if xg.is_cuda:
            xb, sb, tb, wsb, wtb, ctb = triplet_product_bwd2_kernel(
                *_kernel_inputs(xg, sbf, tbf, ws, wt, mask2d, K),
                ct.float().contiguous(), u1, u2, u3, u4, u5, K)
            wsb, wtb, ctb = _to(wsb, ws), _to(wtb, wt), _to(ctb, ct)
        else:
            xb, sb, tb, wsb, wtb, ctb = fused_triplet_product_bwd2_reference(
                xg, sbf, tbf, ws, wt, mask2d, ct, u1, u2, u3, u4, u5, K)
        grads = (xb, sb, tb, wsb, wtb, None, ctb)
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None, None)


def _check_device(xg):
    if xg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_triplet_product runs on CUDA or the CPU, "
                         f"not {xg.device}")


def fused_triplet_product(xg, sbf, tbf, ws, wt, mask2d, K: int,
                          tile_e: int = 128,
                          basis_grads: bool = True) -> torch.Tensor:
    """``out[e] = sum_k mask2d[e, k] * xg[e*K+k] * (sbf[e*K+k] @ ws) *
    (tbf[e*K+k] @ wt)`` (see the module docstring): ``xg [T, C]``,
    ``sbf [T, S1]``, ``tbf [T, S2]``, ``ws [S1, C]``, ``wt [S2, C]``,
    ``mask2d [E, K]``; ``[E, C]`` in ``xg``'s type. With ``basis_grads``
    differentiable to second order (energy+force training); without, the
    basis cotangents are zeros and it is first order only. ``tile_e``, the
    TPU kernel's edge tile, is accepted in the JAX signature's place and
    has no effect here."""
    _check_device(xg)
    return _TripletProduct.apply(xg, sbf, tbf, ws, wt, mask2d, int(K),
                                 bool(basis_grads))


def fused_angle_product(xg, sbf, ws, mask2d, K: int, tile_e: int = 128,
                        basis_grads: bool = True) -> torch.Tensor:
    """DimeNet++'s variant without torsion: ``out[e] = sum_k mask2d[e, k]
    * xg[e*K+k] * (sbf[e*K+k] @ ws)`` (``tile_e`` as for
    :func:`fused_triplet_product`)."""
    _check_device(xg)
    return _TripletProduct.apply(xg, sbf, None, ws, None, mask2d, int(K),
                                 bool(basis_grads))
