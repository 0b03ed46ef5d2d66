"""Fused triplet interaction over the packed transposed basis table: the
triplet product of SphereNet / DimeNet++ with ``pallas_fuse_basis`` on the
[N, K] table without the slot kernel. Port of
``dig_tpu/ops/pallas_triplet_pt.py``.

    out[e] = sum_k m2[e, k] * xg[t] * (sbf[t] @ ws) * (tbf[t] @ wt),
    t = e*K + k

with ``sbf`` and ``tbf`` assembled per triplet from ``pt [R, T]`` (the
triplet axis minor; :func:`basis_pt`): with ``bt, y0, yt`` its rows
``[0:nk)``, ``[nk:nk+n)`` and ``[nk+n:R)`` (nk = n*k),

    sbf[t, l*k + m]       = bt[l*k + m, t] * y0[l, t]
    tbf[t, (a*n + b)*k + c] = yt[a*n + b, t] * bt[b*k + c, t]

Without torsion (``has_t`` False, DimeNet++) ``pt`` has ``nk + n`` rows,
``wt`` is a ``[1, C]`` zero dummy and the ``tbf @ wt`` factor is absent.
``xg [T, C]`` holds the raw ``expand_kj_raw`` rows (other rows' values at
masked triplets), ``m2 [E, K]`` the triplet mask.

Precision, as the TPU kernel's ``fwd_body``: the rows are assembled in
float32 and rounded to ``pt``'s type before the products; products and
sums are float32 and each output is rounded to its type once (the
derivative of the rounding is the identity). A triplet with ``m2 = 0``
contributes nothing, and its ``dxg`` row and ``dpt`` column are exactly 0.

Differentiable to second order, as the JAX op's custom_vjp tower
(``fused_triplet_pt`` -> ``_B`` -> ``_run_bwd2``): the backward of
:class:`_TripletPT` is the Function :class:`_TripletPTBwd`, whose own
backward is the second-order VJP. The backward returns ``dxg`` in
``xg``'s type, ``dpt`` in ``pt``'s (only when autograd asks for it) and
``dws`` / ``dwt`` summed in float32 and cast to the weights' type. On a
CUDA tensor every level launches a hand-written kernel of
``csrc/triplet_pt.cu`` or raises; on a CPU tensor each runs its plain
version (:func:`fused_triplet_pt_ref` and the autograd first and second
VJPs of it, :func:`fused_triplet_pt_bwd_ref`,
:func:`fused_triplet_pt_bwd2_ref`). ``launches_fwd``, ``launches_bwd`` and
``launches_bwd2`` count kernel launches (``launches_bwd_dpt`` the backward
launches that computed ``dpt``). As in ``ops/triplet_slot.py``, a backward
computes ``dpt`` only when the backward pass now running will use it, so a
force step's outer pass (``loss.backward(inputs=params)``) leaves it out.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .basis import packed_basis_rows
from .triplet_slot import (_grad_wanted, _leaves, _round_to,
                           _vjp_rows_optional, _zeros_for_unused)

launches_fwd = 0
launches_bwd = 0
launches_bwd2 = 0
launches_bwd_dpt = 0     # of launches_bwd: those that computed dpt

_SHAPES = "C must be at most 128"


def reset_launch_counts() -> None:
    global launches_fwd, launches_bwd, launches_bwd2, launches_bwd_dpt
    launches_fwd = 0
    launches_bwd = 0
    launches_bwd2 = 0
    launches_bwd_dpt = 0


def pt_rows(num_spherical: int, num_radial: int, has_t: bool) -> int:
    n, k = num_spherical, num_radial
    return n * k + n + (n * n if has_t else 0)


def basis_pt(num_spherical: int, num_radial: int, theta, phi, dk,
             has_t: bool) -> torch.Tensor:
    """Packed transposed basis table ``[R, T]`` from per-triplet scalars
    ``[T]``: the Bessel rows of ``dk`` (l-major), Y_l^0(theta), then, with
    ``has_t``, Y_l^m(theta, phi). The closed forms of ``basis_pt_k``, the
    slot layout's ``[K, R, E]`` table."""
    return torch.stack(packed_basis_rows(num_spherical, num_radial, theta,
                                         phi, dk, has_t), dim=0)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _contract(xg, pt, ws, wt, m2, K: int, cfg, md: torch.dtype):
    """The contraction in float32 ``[E, C]``, the assembled rows rounded
    to ``md``; differentiable by autograd to any order."""
    n, k, has_t = cfg
    nk = n * k
    T, C = xg.shape
    ptf = pt.float()
    bt = ptf[:nk]                                        # [nk, T]
    sbf = _round_to((bt * ptf[nk:nk + n].repeat_interleave(k, 0)).t(), md)
    prod = xg.float() * (sbf @ ws.float())
    if has_t:
        yt = ptf[nk + n:]                                # [n*n, T]
        tbf = _round_to((yt.repeat_interleave(k, 0) * bt.repeat(n, 1)).t(),
                        md)
        prod = prod * (tbf @ wt.float())
    return (prod.reshape(T // K, K, C) * m2.float()[:, :, None]).sum(dim=1)


def fused_triplet_pt_ref(xg, pt, ws, wt, m2, K: int, cfg) -> torch.Tensor:
    """Plain forward (the JAX oracle's name): ``[E, C]`` in ``xg``'s
    type."""
    return _contract(xg, pt, ws, wt, m2, K, cfg, pt.dtype).to(xg.dtype)


def fused_triplet_pt_bwd_ref(xg, pt, ws, wt, m2, ct, K: int, cfg,
                             need_dpt: bool = True):
    """Plain first-order VJP: float32 ``(dxg, dpt, dws, dwt)`` of the
    contraction against ``ct [E, C]`` (autograd of the plain forward;
    ``dpt`` None unless ``need_dpt``, ``dwt`` 0 without torsion)."""
    return _vjp_rows_optional(
        lambda *xs: _contract(*xs, m2, K, cfg, pt.dtype), (xg, pt, ws, wt),
        ct, need_dpt)


def fused_triplet_pt_bwd2_ref(xg, pt, ws, wt, m2, ct, u1, u2, u4, u5,
                              K: int, cfg):
    """Plain second-order VJP: the cotangents ``(u1, u2, u4, u5)`` of
    ``(dxg, dpt, dws, dwt)`` pulled back to float32 ``(xb, ptb, wsb, wtb,
    ctb)``, the gradients with respect to ``(xg, pt, ws, wt, ct)``. Any
    ``u`` may be None (its terms vanish). Autograd of the first-order VJP,
    itself taken with ``create_graph``."""
    with torch.enable_grad():
        xs = _leaves(xg, pt, ws, wt, ct)
        out = _contract(*xs[:4], m2, K, cfg, pt.dtype)
        first = torch.autograd.grad(out, xs[:4], xs[4], create_graph=True,
                                    allow_unused=True)
        pairs = [(g, u.detach().float()) for g, u in zip(first,
                                                         (u1, u2, u4, u5))
                 if g is not None and u is not None]
        grads = [None] * 5
        if pairs:
            grads = torch.autograd.grad([g for g, _ in pairs], xs,
                                        [u for _, u in pairs],
                                        allow_unused=True)
    return _zeros_for_unused(grads, xs)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _build.load("triplet_pt")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.triplet_pt_blocks.argtypes = [I] * 9
        lib.triplet_pt_blocks.restype = I
        lib.triplet_pt_fwd.argtypes = [P] * 6 + [I] * 7 + [P]
        lib.triplet_pt_fwd.restype = I
        lib.triplet_pt_bwd.argtypes = [P] * 10 + [I] * 7 + [P]
        lib.triplet_pt_bwd.restype = I
        lib.triplet_pt_bwd2.argtypes = [P] * 15 + [I] * 7 + [P]
        lib.triplet_pt_bwd2.restype = I
        lib._argtypes_set = True
    return lib


def _check(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"fused_triplet_pt: {name} on {t.device}, xg on "
                         f"{dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_triplet_pt: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")


def _kernel_inputs(xg, pt, ws, wt, m2, K, cfg):
    """Validate shapes, devices and types; return the kernel's operands
    (xg, pt and m2 in their shared type; ws and wt float32)."""
    n, k, has_t = cfg
    T, C = xg.shape
    if K <= 0 or T % K or T == 0:
        raise ValueError(f"fused_triplet_pt: {T} triplet rows is not a "
                         f"positive multiple of K={K}")
    nk = n * k
    want = {"pt": (pt, (pt_rows(n, k, has_t), T)), "ws": (ws, (nk, C)),
            "wt": (wt, ((n * nk if has_t else 1), C)),
            "m2": (m2, (T // K, K))}
    for name, (t, shape) in want.items():
        _check(name, t, shape, xg.device)
    if xg.dtype not in (torch.float32, torch.bfloat16) or \
            pt.dtype != xg.dtype or m2.dtype != xg.dtype:
        raise TypeError(f"fused_triplet_pt kernel takes xg, pt and m2 of one "
                        f"type, float32 or bfloat16; got {xg.dtype}, "
                        f"{pt.dtype}, {m2.dtype}")
    if C > 128:
        raise ValueError(f"fused_triplet_pt kernel takes C up to 128; got "
                         f"C={C}")
    return (xg.contiguous(), pt.contiguous(), ws.float().contiguous(),
            wt.float().contiguous(), m2.contiguous())


def _dims(xg, K, cfg):
    n, k, has_t = cfg
    return xg.shape[0] // K, xg.shape[1], n, k, int(bool(has_t))


def _weight_split(dw, cfg, C):
    n, k, has_t = cfg
    nk = n * k
    dws = dw[:nk * C].view(nk, C)
    dwt = (dw[nk * C:].view(n * nk, C) if has_t
           else torch.zeros((1, C), dtype=torch.float32, device=dw.device))
    return dws, dwt


def _scratch(lib, E, K, second_order, cfg, C, bf16, dpt, dev):
    """The weight partials of a backward (``second_order`` 0, with ``dpt``
    or not) or second-order launch, one row a block, and their sum."""
    n, k, has_t = cfg
    blocks = lib.triplet_pt_blocks(E, K, C, n, k, int(bool(has_t)), bf16,
                                   int(bool(dpt)), second_order)
    if blocks <= 0:
        _build.check(blocks, "triplet_pt backward kernel's grid", _SHAPES)
    size = n * k * (1 + (n if has_t else 0)) * C
    return (torch.empty((blocks, size), dtype=torch.float32, device=dev),
            torch.empty(size, dtype=torch.float32, device=dev))


def triplet_pt_forward_kernel(xg, pt, ws, wt, m2, K, cfg):
    """Launch the forward kernel on validated operands; ``[E, C]`` in
    ``xg``'s type."""
    global launches_fwd
    E, C, n, k, has_t = _dims(xg, K, cfg)
    out = torch.empty((E, C), dtype=xg.dtype, device=xg.device)
    rc = _library().triplet_pt_fwd(
        *map(_build.ptr, (xg, pt, ws, wt, m2, out)), E, K, C, n, k,
        has_t,
        int(xg.dtype == torch.bfloat16),
        _build.stream(xg.device))
    _build.check(rc, "triplet_pt forward kernel", _SHAPES)
    launches_fwd += 1
    return out


def triplet_pt_backward_kernel(xg, pt, ws, wt, m2, ct, K, cfg, need_dpt):
    """Launch the backward kernel on validated operands (``ct`` float32
    ``[E, C]``); returns ``(dxg, dpt, dws, dwt)``: ``dxg`` in ``xg``'s
    type, ``dpt`` in ``pt``'s (None unless ``need_dpt``), the weight
    gradients float32."""
    global launches_bwd, launches_bwd_dpt
    E, C, n, k, has_t = _dims(xg, K, cfg)
    lib = _library()
    dxg = torch.empty_like(xg)
    dpt = torch.empty_like(pt) if need_dpt else None
    bf16 = int(xg.dtype == torch.bfloat16)
    partial, dw = _scratch(lib, E, K, 0, cfg, C, bf16, need_dpt, xg.device)
    rc = lib.triplet_pt_bwd(
        *map(_build.ptr, (xg, pt, ws, wt, m2, ct, dxg, dpt, partial, dw)),
        E, K, C, n, k, has_t, bf16, _build.stream(xg.device))
    _build.check(rc, "triplet_pt backward kernel", _SHAPES)
    launches_bwd += 1
    launches_bwd_dpt += int(bool(need_dpt))
    return (dxg, dpt, *_weight_split(dw, cfg, C))


def triplet_pt_bwd2_kernel(xg, pt, ws, wt, m2, ct, u1, u2, u4, u5, K, cfg):
    """Launch the second-order kernel on validated operands (``ct``
    float32 ``[E, C]``); ``u1 [T, C]``, ``u2 [R, T]``, ``u4 [nk, C]`` and
    ``u5 [ntk, C]`` are the cotangents of ``(dxg, dpt, dws, dwt)``, each
    None when absent. Returns ``(xb, ptb, wsb, wtb, ctb)``: ``xb`` in
    ``xg``'s type, ``ptb`` in ``pt``'s, the rest float32."""
    global launches_bwd2
    E, C, n, k, has_t = _dims(xg, K, cfg)
    dev, dt = xg.device, xg.dtype
    if not has_t:
        u5 = None                          # wt is unused without torsion
    for name, u, shape in (("u1", u1, tuple(xg.shape)),
                           ("u2", u2, tuple(pt.shape)), ("u4", u4, (n * k, C)),
                           ("u5", u5, (n * n * k, C))):
        if u is not None:
            _check(name, u, shape, dev)
    c = lambda u, d: None if u is None else u.to(d).contiguous()
    u1, u2 = c(u1, dt), c(u2, dt)
    u4, u5 = c(u4, torch.float32), c(u5, torch.float32)
    lib = _library()
    xb = torch.empty_like(xg)
    ptb = torch.empty_like(pt)
    ctb = torch.empty((E, C), dtype=torch.float32, device=dev)
    partial, dw = _scratch(lib, E, K, 1, cfg, C, int(dt == torch.bfloat16),
                           True, dev)
    rc = lib.triplet_pt_bwd2(
        *map(_build.ptr, (xg, pt, ws, wt, m2, ct, u1, u2, u4, u5, xb, ptb,
                          ctb, partial, dw)),
        E, K, C, n, k, has_t, int(dt == torch.bfloat16),
        _build.stream(dev))
    _build.check(rc, "triplet_pt second-order kernel", _SHAPES)
    launches_bwd2 += 1
    return (xb, ptb, *_weight_split(dw, cfg, C), ctb)


# ---------------------------------------------------------------------------
# the autograd tower: _TripletPT -> _TripletPTBwd -> second order
# ---------------------------------------------------------------------------

def _cast(g, t, need=True):
    return g.to(t.dtype) if need and g is not None else None


class _TripletPT(torch.autograd.Function):
    """The contraction. CUDA tensors: the forward kernel; CPU tensors: the
    plain version. Its backward is :class:`_TripletPTBwd`, so a backward
    taken with ``create_graph`` is differentiable again."""

    @staticmethod
    def forward(ctx, xg, pt, ws, wt, m2, K, cfg):
        ctx.meta = (K, cfg)
        # the inputs themselves, so a second-order pass reaches ws and wt
        ctx.save_for_backward(xg, pt, ws, wt, m2)
        if xg.is_cuda:
            return triplet_pt_forward_kernel(
                *_kernel_inputs(xg, pt, ws, wt, m2, K, cfg), K, cfg)
        return fused_triplet_pt_ref(xg, pt, ws, wt, m2, K, cfg)

    @staticmethod
    def backward(ctx, ct):
        K, cfg = ctx.meta
        xg, pt, ws, wt, m2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dxg, dpt, dws, dwt = _TripletPTBwd.apply(xg, pt, ws, wt, m2, ct, K,
                                                 cfg, _grad_wanted(ctx, 1))
        return (dxg if need[0] else None, dpt, dws if need[2] else None,
                dwt if need[3] else None, None, None, None)


class _TripletPTBwd(torch.autograd.Function):
    """First-order VJP ``(xg, pt, ws, wt, ct) -> (dxg, dpt, dws, dwt)``
    (``dpt`` None unless asked for). CUDA tensors: the backward kernel; CPU
    tensors: :func:`fused_triplet_pt_bwd_ref`. Its backward is the
    second-order VJP (the ``_B`` rule of the JAX op); absent cotangents
    arrive as None and their terms are skipped."""

    @staticmethod
    def forward(ctx, xg, pt, ws, wt, m2, ct, K, cfg, need_dpt):
        ctx.set_materialize_grads(False)
        ctx.meta = (K, cfg)
        ctx.save_for_backward(xg, pt, ws, wt, m2, ct)
        if xg.is_cuda:
            dxg, dpt, dws, dwt = triplet_pt_backward_kernel(
                *_kernel_inputs(xg, pt, ws, wt, m2, K, cfg),
                ct.float().contiguous(), K, cfg, need_dpt)
        else:
            dxg, dpt, dws, dwt = fused_triplet_pt_bwd_ref(
                xg, pt, ws, wt, m2, ct, K, cfg, need_dpt)
        return (_cast(dxg, xg), _cast(dpt, pt), _cast(dws, ws),
                _cast(dwt, wt))

    @staticmethod
    @once_differentiable
    def backward(ctx, u1, u2, u4, u5):
        K, cfg = ctx.meta
        xg, pt, ws, wt, m2, ct = ctx.saved_tensors
        need = ctx.needs_input_grad
        if all(u is None for u in (u1, u2, u4, u5)):
            return (None,) * 9
        if xg.is_cuda:
            grads = triplet_pt_bwd2_kernel(
                *_kernel_inputs(xg, pt, ws, wt, m2, K, cfg),
                ct.float().contiguous(), u1, u2, u4, u5, K, cfg)
        else:
            grads = fused_triplet_pt_bwd2_ref(xg, pt, ws, wt, m2, ct, u1, u2,
                                              u4, u5, K, cfg)
        xb, ptb, wsb, wtb, ctb = grads
        return (_cast(xb, xg, need[0]), _cast(ptb, pt, need[1]),
                _cast(wsb, ws, need[2]), _cast(wtb, wt, need[3]), None,
                _cast(ctb, ct, need[5]), None, None, None)


def fused_triplet_pt(xg, pt, ws, wt, m2, K: int, tile_e: int, cfg):
    """Fused triplet interaction over the packed basis table (see the
    module docstring): ``xg [T, C]`` (T = E*K), ``pt [R, T]``
    (:func:`basis_pt`), ``ws [n*k, C]``, ``wt [n*n*k, C]`` (a ``[1, C]``
    dummy without torsion), ``m2 [E, K]``; ``cfg = (num_spherical,
    num_radial, has_t)``. ``tile_e``, the TPU kernel's edge tile, keeps its
    place in the JAX signature and has no effect here. Returns ``[E, C]``
    in ``xg``'s type. Differentiable to second order (force training)."""
    if xg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_triplet_pt runs on CUDA or the CPU, not "
                         f"{xg.device}")
    return _TripletPT.apply(xg, pt, ws, wt, m2, int(K), tuple(cfg))
