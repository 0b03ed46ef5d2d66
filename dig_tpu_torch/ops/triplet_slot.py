"""Slot-resident fused triplet interaction: SphereNet's triplet hot op in
the slot layout. Port of ``fused_triplet_slot`` and ``basis_pt_k`` of
``dig_tpu/ops/pallas_triplet_slot.py``.

    out[e] = sum_s m2T[s, e] * x[(slot(e)*A + lj[e])*K + s]
                  * (sbf[e, s] @ ws) * (tbf[e, s] @ wt)

with ``slot(e) = e // (A*K)``, ``sbf[r = l*k + m] = bt[r] * y0[l]`` and
``tbf[i] = yt[i // k] * bt[i mod n*k]``, where ``bt, y0, yt`` are rows
``[0:nk)``, ``[nk:nk+n)`` and ``[nk+n:)`` of ``pt[s, :, e]`` (nk = n*k).
Without torsion (``has_t`` False, DimeNet++) the ``tbf @ wt`` factor is
absent and ``pt`` has ``nk + n`` rows.

Precision: ``sbf``, ``tbf`` and the gathered ``x`` are rounded to
``x.dtype`` (the operands the TPU kernel rounds); products and sums are
float32 and the output is rounded to ``x.dtype`` once. (The TPU kernel
sums over s in ``x.dtype``; in bf16 that rounds 16 times instead of
once.) Derivatives of the roundings are the identity; gradients are
float32, cast to each input's dtype at the end. A triplet whose ``lj``
lies outside ``[0, A)`` contributes zero.

Differentiable to second order, as the JAX op's custom_vjp tower
(``fused_triplet_slot`` -> ``_B`` -> ``_run_bwd2``): the backward of
:class:`_TripletSlot` is the Function :class:`_TripletSlotBwd`, whose own
backward is the second-order VJP. Force training (force = -dE/dpos inside
the loss) runs all three levels. On a CUDA tensor every level launches a
hand-written kernel of ``csrc/triplet_slot.cu`` or raises; on a CPU tensor
each level runs its plain version (``fused_triplet_slot_reference``, its
autograd backward ``fused_triplet_slot_bwd_reference`` and the autograd
double backward ``fused_triplet_slot_bwd2_reference``). ``launches_fwd``,
``launches_bwd`` and ``launches_bwd2`` count kernel launches
(``launches_bwd_dpt`` the backward launches that computed ``dpt``).

A backward computes the rows' cotangent (``dpt``, the geometry op's
``dgeo``) only when the backward pass now running will use it
(:func:`_grad_wanted`): a force step's outer pass,
``loss.backward(inputs=params)``, leaves it out, while the inner
``torch.autograd.grad(energy, pos, create_graph=True)`` and a plain
``backward()`` get it.

:func:`fused_triplet_slot_geom` (port of the JAX op of the same name) is
the same contraction with the basis rows evaluated inside the kernels
(``csrc/triplet_slot_geom.cu``) from ``geo [K, NG, E]`` = (theta[, phi],
d_kj / cutoff), NG = 2 + has_t: no ``[K, R, E]`` table exists in device
memory at any derivative level. The rows are evaluated in float64 and
rounded to float32, never to bf16; sbf and tbf are rounded to ``x.dtype``
as above. (Deliberate deviation: the JAX op evaluates the rows in float32.
Its Bessel closed forms cancel catastrophically at short d_kj, where two
float32 evaluations of them disagree by up to 3e-4 of the largest row
gradient; in float64 the kernels and the plain version both give the
float32 rounding of the closed form.) A masked triplet
(``m2T == 0`` or ``lj`` outside ``[0, A)``) evaluates its rows at
``d_kj / cutoff = 1`` (the Bessel closed forms have poles at 0) and gets a
zero geometry gradient. Its tower is :class:`_TripletSlotGeom` ->
:class:`_TripletSlotGeomBwd` -> the second-order kernels; its plain
versions ``fused_triplet_slot_geom_reference``, ``_bwd_reference`` and
``_bwd2_reference``; ``launches_geom_fwd``, ``launches_geom_bwd`` and
``launches_geom_bwd2`` count its launches (``launches_geom_bwd_dgeo``
the backward launches that computed ``dgeo``).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .basis import basis_row_code, packed_basis_rows

KERNEL_CHANNELS = (32, 64, 128)   # C the kernels are compiled for

launches_fwd = 0
launches_bwd = 0
launches_bwd2 = 0
launches_geom_fwd = 0
launches_geom_bwd = 0
launches_geom_bwd2 = 0
launches_bwd_dpt = 0          # of launches_bwd: those that computed dpt
launches_geom_bwd_dgeo = 0    # of launches_geom_bwd: those with dgeo

_SHAPES = "C must be one of 32/64/128"


def reset_launch_counts() -> None:
    global launches_fwd, launches_bwd, launches_bwd2
    global launches_geom_fwd, launches_geom_bwd, launches_geom_bwd2
    global launches_bwd_dpt, launches_geom_bwd_dgeo
    launches_fwd = 0
    launches_bwd = 0
    launches_bwd2 = 0
    launches_geom_fwd = 0
    launches_geom_bwd = 0
    launches_geom_bwd2 = 0
    launches_bwd_dpt = 0
    launches_geom_bwd_dgeo = 0


def basis_pt_k(num_spherical: int, num_radial: int, theta, phi, dk,
               has_t: bool) -> torch.Tensor:
    """Packed basis table ``[K, R, E]`` from ``[K, E]`` per-triplet
    scalars (s-leading): the bessel rows of ``dk`` (l-major), Y_l^0(theta),
    then, with ``has_t``, Y_l^m(theta, phi)."""
    return torch.stack(packed_basis_rows(num_spherical, num_radial, theta,
                                         phi, dk, has_t), dim=1)


def _round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back to float32, with an identity
    derivative (the kernel's gradients are float32 throughout)."""
    if dtype == torch.float32:
        return t
    return t + (t.to(dtype).float() - t).detach()


def _contract(x, pt, ws, wt, m2T, lj, A: int, K: int, cfg,
              md: torch.dtype) -> torch.Tensor:
    """The slot contraction in float32, rounding the operands the kernels
    round to ``md``; differentiable by autograd to any order.

    The JAX oracle (``fused_triplet_slot_ref``) gathers x with an [N, E]
    one-hot; here the gather is ``x.view(N, K, C)[slot*A + lj, s]``, the
    same function without the ~0.5 GB one-hot per s at the flagship shape.
    """
    n, k, has_t = cfg
    E, C = x.shape
    nk = n * k
    slot = torch.arange(E, device=x.device) // (A * K)
    ljl = lj[0].long()
    valid = (ljl >= 0) & (ljl < A)
    jg = slot * A + torch.where(valid, ljl, 0)
    m2 = torch.where(valid[None, :], m2T.float(), 0.0)
    xk = x.float().view(E // K, K, C)
    ptf, wsf, wtf = pt.float(), ws.float(), wt.float()
    out = torch.zeros((E, C), dtype=torch.float32, device=x.device)
    for s in range(K):
        b = ptf[s, :nk].t()                                  # [E, nk]
        y0 = ptf[s, nk:nk + n].t()                           # [E, n]
        sbf = _round_to(b * y0.repeat_interleave(k, dim=1), md)
        prod = (m2[s][:, None] * _round_to(xk[jg, s], md)) * (sbf @ wsf)
        if has_t:
            yt = ptf[s, nk + n:].t()                         # [E, n*n]
            tbf = _round_to(yt.repeat_interleave(k, dim=1) * b.repeat(1, n),
                            md)
            prod = prod * (tbf @ wtf)
        out = out + prod
    return out


def fused_triplet_slot_reference(x, pt, ws, wt, m2T, lj, A: int, K: int,
                                 cfg) -> torch.Tensor:
    """Plain version of the slot contraction (differentiable by autograd
    to any order); ``[E, C]`` in ``x.dtype``."""
    return _contract(x, pt, ws, wt, m2T, lj, A, K, cfg, x.dtype).to(x.dtype)


def _leaves(*ts):
    return [t.detach().float().requires_grad_() for t in ts]


def _zeros_for_unused(grads, like):
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, like)]


def _vjp_rows_optional(contract, args, ct, need_rows):
    """float32 gradients of ``contract(*leaves)`` against ``ct`` with
    respect to the four operands ``args``; the second (the rows) is
    neither a leaf nor differentiated, and its gradient None, unless
    ``need_rows``."""
    with torch.enable_grad():
        xs = _leaves(*args)
        if not need_rows:
            xs[1] = args[1].detach().float()
        out = contract(*xs)
        want = [t for t in xs if t.requires_grad]
        grads = torch.autograd.grad(out, want, ct.detach().float(),
                                    allow_unused=True)
    grads = _zeros_for_unused(grads, want)
    if not need_rows:
        grads.insert(1, None)
    return grads


def fused_triplet_slot_bwd_reference(x, pt, ws, wt, m2T, lj, ct, A: int,
                                     K: int, cfg, need_dpt: bool = True):
    """Plain first-order VJP: float32 ``(dx, dpt, dws, dwt)`` of the
    contraction against the output cotangent ``ct [E, C]`` (autograd of
    the plain version; ``dpt`` None unless ``need_dpt``, ``dwt`` 0
    without torsion)."""
    return _vjp_rows_optional(
        lambda *xs: _contract(*xs, m2T, lj, A, K, cfg, x.dtype),
        (x, pt, ws, wt), ct, need_dpt)


def fused_triplet_slot_bwd2_reference(x, pt, ws, wt, m2T, lj, ct, u1, u2,
                                      u4, u5, A: int, K: int, cfg):
    """Plain second-order VJP: the cotangents ``(u1, u2, u4, u5)`` of
    ``(dx, dpt, dws, dwt)`` pulled back to float32 ``(xb, ptb, wsb, wtb,
    ctb)``, the gradients with respect to ``(x, pt, ws, wt, ct)``. Any
    ``u`` may be None (its terms vanish). Autograd of the first-order VJP,
    itself taken with ``create_graph``."""
    with torch.enable_grad():
        xs = _leaves(x, pt, ws, wt, ct)
        out = _contract(*xs[:4], m2T, lj, A, K, cfg, x.dtype)
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
    lib = _build.load("triplet_slot")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.triplet_slot_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
        lib.triplet_slot_fwd.restype = I
        lib.triplet_slot_bwd.argtypes = [P] * 11 + [I] * 10 + [P]
        lib.triplet_slot_bwd.restype = I
        lib.triplet_slot_bwd2.argtypes = [P] * 16 + [I] * 9 + [P]
        lib.triplet_slot_bwd2.restype = I
        lib._argtypes_set = True
    return lib


def _check_shape(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"fused_triplet_slot: {name} on {t.device}, x on "
                         f"{dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_triplet_slot: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")


def _kernel_inputs(x, pt, ws, wt, m2T, lj, A, K, cfg):
    """Validate shapes, devices and types; return the kernel's operands
    (x, pt, m2T in their shared type; ws, wt float32; lj int32)."""
    n, k, has_t = cfg
    E, C = x.shape
    nk = n * k
    R = nk + n + (n * n if has_t else 0)
    want = {"x": (x, (E, C)), "pt": (pt, (K, R, E)), "ws": (ws, (nk, C)),
            "wt": (wt, ((n * n * k if has_t else 1), C)),
            "m2T": (m2T, (K, E)), "lj": (lj, (1, E))}
    for name, (t, shape) in want.items():
        _check_shape(name, t, shape, x.device)
    if E % (A * K):
        raise ValueError(f"fused_triplet_slot: E={E} is not a multiple of "
                         f"A*K={A * K}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            pt.dtype != x.dtype or m2T.dtype != x.dtype:
        raise TypeError(f"fused_triplet_slot kernel takes x, pt and m2T of "
                        f"one type, float32 or bfloat16; got {x.dtype}, "
                        f"{pt.dtype}, {m2T.dtype}")
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"fused_triplet_slot kernel takes C in "
                         f"{KERNEL_CHANNELS}; got C={C}")
    return (x.contiguous(), pt.contiguous(), ws.float().contiguous(),
            wt.float().contiguous(), m2T.contiguous(),
            lj.to(torch.int32).contiguous())


def triplet_slot_forward_kernel(x, pt, ws, wt, m2T, lj, A, K, cfg):
    """Launch the forward kernel on validated operands; ``[E, C]`` in
    ``x.dtype``."""
    global launches_fwd
    n, k, has_t = cfg
    E, C = x.shape
    out = torch.empty((E, C), dtype=x.dtype, device=x.device)
    rc = _library().triplet_slot_fwd(
        *map(_build.ptr, (x, pt, m2T, ws, wt, lj, out)), E, A, K, n, k,
        int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        _build.stream(x.device))
    _build.check(rc, "triplet_slot forward kernel", _SHAPES)
    launches_fwd += 1
    return out


def _weight_scratch(E, A, K, n, k, has_t, C, dev):
    """``(blocks, partial, dw)`` of a backward kernel: one block per (slot,
    s), its weight-gradient partials, and their fixed-order sum."""
    blocks = (E // (A * K)) * K
    size = (n * k + (n * n * k if has_t else 0)) * C
    return (blocks,
            torch.empty((blocks, size), dtype=torch.float32, device=dev),
            torch.empty(size, dtype=torch.float32, device=dev))


def _weight_grads(dw, n, k, has_t, C, dev):
    nk, ntk = n * k, (n * n * k if has_t else 0)
    dws = dw[:nk * C].view(nk, C)
    dwt = (dw[nk * C:].view(ntk, C) if has_t
           else torch.zeros((1, C), dtype=torch.float32, device=dev))
    return dws, dwt


def triplet_slot_backward_kernel(x, pt, ws, wt, m2T, lj, ct, A, K, cfg,
                                 need_dpt):
    """Launch the backward kernel; returns float32 ``(dx, dpt, dws, dwt)``,
    ``dpt`` None unless ``need_dpt``. ``ct`` is float32 ``[E, C]``."""
    global launches_bwd, launches_bwd_dpt
    n, k, has_t = cfg
    E, C = x.shape
    dev = x.device
    dx = torch.empty((E, C), dtype=torch.float32, device=dev)
    dpt = (torch.empty(pt.shape, dtype=torch.float32, device=dev)
           if need_dpt else None)
    blocks, partial, dw = _weight_scratch(E, A, K, n, k, has_t, C, dev)
    rc = _library().triplet_slot_bwd(
        *map(_build.ptr, (x, pt, m2T, ws, wt, lj, ct, dx, dpt, partial, dw)),
        E, A, K, n, k, int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        int(bool(need_dpt)), blocks, _build.stream(dev))
    _build.check(rc, "triplet_slot backward kernel", _SHAPES)
    launches_bwd += 1
    launches_bwd_dpt += int(bool(need_dpt))
    return (dx, dpt, *_weight_grads(dw, n, k, has_t, C, dev))


def triplet_slot_bwd2_kernel(x, pt, ws, wt, m2T, lj, ct, u1, u2, u4, u5, A,
                             K, cfg):
    """Launch the second-order kernels on validated operands (``ct``
    float32 ``[E, C]``); returns float32 ``(xb, ptb, wsb, wtb, ctb)``.
    ``u1 [E, C]``, ``u2 [K, R, E]``, ``u4 [nk, C]`` and ``u5 [ntk, C]``
    are the cotangents of ``(dx, dpt, dws, dwt)``; a None one is skipped
    by the kernels."""
    global launches_bwd2
    n, k, has_t = cfg
    E, C = x.shape
    dev = x.device
    nk, ntk = n * k, (n * n * k if has_t else 0)
    if not has_t:
        u5 = None                        # wt is unused without torsion
    for name, u, shape in (("ct", ct, (E, C)), ("u1", u1, (E, C)),
                           ("u2", u2, tuple(pt.shape)), ("u4", u4, (nk, C)),
                           ("u5", u5, (ntk, C))):
        if u is not None:
            _check_shape(name, u, shape, dev)
    u1 = None if u1 is None else u1.to(x.dtype).contiguous()
    u2 = None if u2 is None else u2.to(x.dtype).contiguous()
    u4 = None if u4 is None else u4.float().contiguous()
    u5 = None if u5 is None else u5.float().contiguous()
    xb = torch.empty((E, C), dtype=torch.float32, device=dev)
    ptb = torch.empty(pt.shape, dtype=torch.float32, device=dev)
    ctb = torch.empty((E, C), dtype=torch.float32, device=dev)
    blocks, partial, dw = _weight_scratch(E, A, K, n, k, has_t, C, dev)
    rc = _library().triplet_slot_bwd2(
        *map(_build.ptr, (x, pt, m2T, ws, wt, lj, ct, u1, u2, u4, u5, xb,
                          ptb, partial, dw, ctb)),
        E, A, K, n, k, int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        blocks, _build.stream(dev))
    _build.check(rc, "triplet_slot second-order kernel", _SHAPES)
    launches_bwd2 += 1
    return (xb, ptb, *_weight_grads(dw, n, k, has_t, C, dev), ctb)


# ---------------------------------------------------------------------------
# the autograd tower: _TripletSlot -> _TripletSlotBwd -> second order
# ---------------------------------------------------------------------------

def _cast(g, t, need):
    return g.to(t.dtype) if need and g is not None else None


def _grad_wanted(ctx, i: int) -> bool:
    """Whether the backward pass now running will use the gradient of the
    Function's tensor input ``i``. ``ctx.needs_input_grad[i]`` only says
    that the input required a gradient when the graph was built; a pass
    run for other inputs (a force step's outer ``loss.backward(inputs=
    params)``, where the rows lead only to the positions) does not execute
    the input's node, so its gradient would be computed for nothing. The
    engine says which nodes it will execute. A leaf input keeps the flag:
    the engine cannot be asked about a leaf inside ``torch.autograd.grad``,
    which captures leaves instead of executing them."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None or isinstance(node, torch._C._functions.AccumulateGrad) \
            or torch._C._current_graph_task_id() == -1:
        return True
    return torch._C._will_engine_execute_node(node)


class _TripletSlot(torch.autograd.Function):
    """The contraction. CUDA tensors: the forward kernel; CPU tensors: the
    plain version. Its backward is :class:`_TripletSlotBwd`, so a backward
    taken with ``create_graph`` is differentiable again."""

    @staticmethod
    def forward(ctx, x, pt, ws, wt, m2T, lj, A, K, cfg):
        ctx.meta = (A, K, cfg)
        # the inputs themselves, so a second-order pass reaches ws and wt
        ctx.save_for_backward(x, pt, ws, wt, m2T, lj)
        if x.is_cuda:
            return triplet_slot_forward_kernel(
                *_kernel_inputs(x, pt, ws, wt, m2T, lj, A, K, cfg), A, K, cfg)
        return fused_triplet_slot_reference(x, pt, ws, wt, m2T, lj, A, K, cfg)

    @staticmethod
    def backward(ctx, ct):
        A, K, cfg = ctx.meta
        x, pt, ws, wt, m2T, lj = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dpt, dws, dwt = _TripletSlotBwd.apply(x, pt, ws, wt, m2T, lj, ct,
                                                  A, K, cfg,
                                                  _grad_wanted(ctx, 1))
        return (dx if need[0] else None, dpt, dws if need[2] else None,
                dwt if need[3] else None, None, None, None, None, None)


class _TripletSlotBwd(torch.autograd.Function):
    """First-order VJP ``(x, pt, ws, wt, ct) -> (dx, dpt, dws, dwt)``
    (``dpt`` None unless asked for). CUDA tensors: the backward kernel;
    CPU tensors: ``fused_triplet_slot_bwd_reference``. Its backward is the
    second-order VJP (the ``_B`` rule of the JAX op); absent cotangents
    arrive as None and their terms are skipped."""

    @staticmethod
    def forward(ctx, x, pt, ws, wt, m2T, lj, ct, A, K, cfg, need_dpt):
        ctx.set_materialize_grads(False)
        ctx.meta = (A, K, cfg)
        ctx.save_for_backward(x, pt, ws, wt, m2T, lj, ct)
        if x.is_cuda:
            dx, dpt, dws, dwt = triplet_slot_backward_kernel(
                *_kernel_inputs(x, pt, ws, wt, m2T, lj, A, K, cfg),
                ct.float().contiguous(), A, K, cfg, need_dpt)
        else:
            dx, dpt, dws, dwt = fused_triplet_slot_bwd_reference(
                x, pt, ws, wt, m2T, lj, ct, A, K, cfg, need_dpt)
        return (dx.to(x.dtype), _cast(dpt, pt, need_dpt), dws.to(ws.dtype),
                dwt.to(wt.dtype))

    @staticmethod
    @once_differentiable
    def backward(ctx, u1, u2, u4, u5):
        A, K, cfg = ctx.meta
        x, pt, ws, wt, m2T, lj, ct = ctx.saved_tensors
        need = ctx.needs_input_grad
        if all(u is None for u in (u1, u2, u4, u5)):
            return (None,) * 11
        if x.is_cuda:
            grads = triplet_slot_bwd2_kernel(
                *_kernel_inputs(x, pt, ws, wt, m2T, lj, A, K, cfg),
                ct.float().contiguous(), u1, u2, u4, u5, A, K, cfg)
        else:
            grads = fused_triplet_slot_bwd2_reference(
                x, pt, ws, wt, m2T, lj, ct, u1, u2, u4, u5, A, K, cfg)
        xb, ptb, wsb, wtb, ctb = grads
        return (_cast(xb, x, need[0]), _cast(ptb, pt, need[1]),
                _cast(wsb, ws, need[2]), _cast(wtb, wt, need[3]), None, None,
                _cast(ctb, ct, need[6]), None, None, None, None)


def fused_triplet_slot(x, pt, ws, wt, m2T, lj, A: int, K: int, cfg):
    """Slot-resident fused triplet interaction (see the module docstring).

    ``x [E, C]`` edge features in the slot-aligned NK layout
    (E = G*A*K), ``pt [K, R, E]`` packed basis (:func:`basis_pt_k`),
    ``ws [n*k, C]``, ``wt [n*n*k | 1, C]``, ``m2T [K, E]`` triplet mask,
    ``lj [1, E]`` slot-local sender ids (int32); ``cfg = (num_spherical,
    num_radial, has_t)``. Returns ``[E, C]`` in ``x.dtype``.
    Differentiable to second order (force training); a third order
    raises.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_triplet_slot runs on CUDA or the CPU, not "
                         f"{x.device}")
    return _TripletSlot.apply(x, pt, ws, wt, m2T, lj, int(A), int(K),
                              tuple(cfg))


# ---------------------------------------------------------------------------
# fused_triplet_slot_geom: the rows evaluated from the geometry
# ---------------------------------------------------------------------------

def _live(m2T, lj, A: int) -> torch.Tensor:
    """[K, E] bool: the real triplets (mask set, sender inside the slot)."""
    ljl = lj[0].long()
    return (m2T != 0) & ((ljl >= 0) & (ljl < A))[None, :]


def geom_rows_pt(geo, m2T, lj, A: int, cfg) -> torch.Tensor:
    """The float32 rows ``[K, R, E]`` the geometry op evaluates from
    ``geo``: the closed forms in float64, rounded to float32, masked
    triplets at ``d_kj / cutoff = 1`` (differentiable; the plain version's
    table, never the kernels')."""
    n, k, has_t = cfg
    g = geo.double()
    th = g[:, 0]
    ph = g[:, 1] if has_t else torch.zeros_like(th)
    dk = torch.where(_live(m2T, lj, A), g[:, -1], 1.0)
    return basis_pt_k(n, k, th, ph, dk, has_t).float()


def fused_triplet_slot_geom_reference(x, geo, ws, wt, m2T, lj, A: int,
                                      K: int, cfg) -> torch.Tensor:
    """Plain version of the geometry op (differentiable by autograd to any
    order): :func:`geom_rows_pt`, then the slot contraction; ``[E, C]`` in
    ``x.dtype``."""
    pt = geom_rows_pt(geo, m2T, lj, A, cfg)
    return _contract(x, pt, ws, wt, m2T, lj, A, K, cfg, x.dtype).to(x.dtype)


def fused_triplet_slot_geom_bwd_reference(x, geo, ws, wt, m2T, lj, ct,
                                          A: int, K: int, cfg,
                                          need_dgeo: bool = True):
    """Plain first-order VJP: float32 ``(dx, dgeo, dws, dwt)``, ``dgeo``
    None unless ``need_dgeo``."""
    return _vjp_rows_optional(
        lambda x_, g, ws_, wt_: _contract(
            x_, geom_rows_pt(g, m2T, lj, A, cfg), ws_, wt_, m2T, lj, A, K,
            cfg, x.dtype),
        (x, geo, ws, wt), ct, need_dgeo)


def fused_triplet_slot_geom_bwd2_reference(x, geo, ws, wt, m2T, lj, ct, u1,
                                           ug, u4, u5, A: int, K: int, cfg):
    """Plain second-order VJP: the cotangents ``(u1, ug, u4, u5)`` of
    ``(dx, dgeo, dws, dwt)`` pulled back to float32 ``(xb, geob, wsb, wtb,
    ctb)``; a None ``u`` is absent."""
    with torch.enable_grad():
        xs = _leaves(x, geo, ws, wt, ct)
        pt = geom_rows_pt(xs[1], m2T, lj, A, cfg)
        out = _contract(xs[0], pt, xs[2], xs[3], m2T, lj, A, K, cfg, x.dtype)
        first = torch.autograd.grad(out, xs[:4], xs[4], create_graph=True,
                                    allow_unused=True)
        pairs = [(g, u.detach().float()) for g, u in zip(first,
                                                         (u1, ug, u4, u5))
                 if g is not None and u is not None and g.requires_grad]
        grads = [None] * 5
        if pairs:
            grads = torch.autograd.grad([g for g, _ in pairs], xs,
                                        [u for _, u in pairs],
                                        allow_unused=True)
    return _zeros_for_unused(grads, xs)


def geom_library_spec(cfg):
    """``(variant, generated headers)`` of the geometry library for
    ``cfg = (n, k, has_t)``: the rows' code of ``ops/basis.py``."""
    n, k, has_t = cfg
    return (f"n{n}k{k}t{int(bool(has_t))}",
            {"geom_rows.cuh": basis_row_code(n, k, bool(has_t))})


def _geom_library(cfg) -> ctypes.CDLL:
    lib = _build.load("triplet_slot_geom", geom_library_spec(cfg))
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.triplet_slot_geom_fwd.argtypes = [P] * 7 + [I] * 8 + [P]
        lib.triplet_slot_geom_fwd.restype = I
        lib.triplet_slot_geom_bwd.argtypes = [P] * 11 + [I] * 10 + [P]
        lib.triplet_slot_geom_bwd.restype = I
        lib.triplet_slot_geom_bwd2.argtypes = [P] * 16 + [I] * 9 + [P]
        lib.triplet_slot_geom_bwd2.restype = I
        lib._argtypes_set = True
    return lib


def _geom_kernel_inputs(x, geo, ws, wt, m2T, lj, A, K, cfg):
    """Validate shapes, devices and types; return the kernel's operands
    (x and m2T in their shared type; geo, ws, wt float32; lj int32)."""
    n, k, has_t = cfg
    E, C = x.shape
    nk = n * k
    want = {"x": (x, (E, C)), "geo": (geo, (K, 2 + int(bool(has_t)), E)),
            "ws": (ws, (nk, C)),
            "wt": (wt, ((n * n * k if has_t else 1), C)),
            "m2T": (m2T, (K, E)), "lj": (lj, (1, E))}
    for name, (t, shape) in want.items():
        _check_shape(name, t, shape, x.device)
    if E % (A * K):
        raise ValueError(f"fused_triplet_slot_geom: E={E} is not a multiple "
                         f"of A*K={A * K}")
    if x.dtype not in (torch.float32, torch.bfloat16) or m2T.dtype != x.dtype:
        raise TypeError(f"fused_triplet_slot_geom kernel takes x and m2T of "
                        f"one type, float32 or bfloat16; got {x.dtype}, "
                        f"{m2T.dtype}")
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"fused_triplet_slot_geom kernel takes C in "
                         f"{KERNEL_CHANNELS}; got C={C}")
    return (x.contiguous(), geo.float().contiguous(), ws.float().contiguous(),
            wt.float().contiguous(), m2T.contiguous(),
            lj.to(torch.int32).contiguous())


def triplet_slot_geom_forward_kernel(x, geo, ws, wt, m2T, lj, A, K, cfg):
    """Launch the geometry forward on validated operands; ``[E, C]`` in
    ``x.dtype``."""
    global launches_geom_fwd
    n, k, has_t = cfg
    E, C = x.shape
    out = torch.empty((E, C), dtype=x.dtype, device=x.device)
    rc = _geom_library(cfg).triplet_slot_geom_fwd(
        *map(_build.ptr, (x, geo, m2T, ws, wt, lj, out)), E, A, K, n, k,
        int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        _build.stream(x.device))
    _build.check(rc, "triplet_slot_geom forward kernel", _SHAPES)
    launches_geom_fwd += 1
    return out


def triplet_slot_geom_backward_kernel(x, geo, ws, wt, m2T, lj, ct, A, K, cfg,
                                      need_dgeo):
    """Launch the geometry backward; float32 ``(dx, dgeo, dws, dwt)``,
    ``dgeo`` None unless ``need_dgeo``. ``ct`` is float32 ``[E, C]``."""
    global launches_geom_bwd, launches_geom_bwd_dgeo
    n, k, has_t = cfg
    E, C = x.shape
    dev = x.device
    dx = torch.empty((E, C), dtype=torch.float32, device=dev)
    dgeo = (torch.empty(geo.shape, dtype=torch.float32, device=dev)
            if need_dgeo else None)
    blocks, partial, dw = _weight_scratch(E, A, K, n, k, has_t, C, dev)
    rc = _geom_library(cfg).triplet_slot_geom_bwd(
        *map(_build.ptr, (x, geo, m2T, ws, wt, lj, ct, dx, dgeo, partial,
                          dw)),
        E, A, K, n, k, int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        int(bool(need_dgeo)), blocks, _build.stream(dev))
    _build.check(rc, "triplet_slot_geom backward kernel", _SHAPES)
    launches_geom_bwd += 1
    launches_geom_bwd_dgeo += int(bool(need_dgeo))
    return (dx, dgeo, *_weight_grads(dw, n, k, has_t, C, dev))


def triplet_slot_geom_bwd2_kernel(x, geo, ws, wt, m2T, lj, ct, u1, ug, u4,
                                  u5, A, K, cfg):
    """Launch the geometry second-order kernels on validated operands
    (``ct`` float32 ``[E, C]``); float32 ``(xb, geob, wsb, wtb, ctb)``.
    ``u1 [E, C]``, ``ug [K, NG, E]``, ``u4 [nk, C]`` and ``u5 [ntk, C]``
    are the cotangents of ``(dx, dgeo, dws, dwt)``; a None one is
    skipped."""
    global launches_geom_bwd2
    n, k, has_t = cfg
    E, C = x.shape
    dev = x.device
    nk, ntk = n * k, (n * n * k if has_t else 0)
    if not has_t:
        u5 = None                        # wt is unused without torsion
    for name, u, shape in (("ct", ct, (E, C)), ("u1", u1, (E, C)),
                           ("ug", ug, tuple(geo.shape)), ("u4", u4, (nk, C)),
                           ("u5", u5, (ntk, C))):
        if u is not None:
            _check_shape(name, u, shape, dev)
    u1 = None if u1 is None else u1.to(x.dtype).contiguous()
    ug = None if ug is None else ug.float().contiguous()
    u4 = None if u4 is None else u4.float().contiguous()
    u5 = None if u5 is None else u5.float().contiguous()
    xb = torch.empty((E, C), dtype=torch.float32, device=dev)
    geob = torch.empty(geo.shape, dtype=torch.float32, device=dev)
    ctb = torch.empty((E, C), dtype=torch.float32, device=dev)
    blocks, partial, dw = _weight_scratch(E, A, K, n, k, has_t, C, dev)
    rc = _geom_library(cfg).triplet_slot_geom_bwd2(
        *map(_build.ptr, (x, geo, m2T, ws, wt, lj, ct, u1, ug, u4, u5, xb,
                          geob, partial, dw, ctb)),
        E, A, K, n, k, int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        blocks, _build.stream(dev))
    _build.check(rc, "triplet_slot_geom second-order kernel", _SHAPES)
    launches_geom_bwd2 += 1
    return (xb, geob, *_weight_grads(dw, n, k, has_t, C, dev), ctb)


class _TripletSlotGeom(torch.autograd.Function):
    """The geometry op. CUDA tensors: the forward kernel; CPU tensors: the
    plain version. Its backward is :class:`_TripletSlotGeomBwd`."""

    @staticmethod
    def forward(ctx, x, geo, ws, wt, m2T, lj, A, K, cfg):
        ctx.meta = (A, K, cfg)
        ctx.save_for_backward(x, geo, ws, wt, m2T, lj)
        if x.is_cuda:
            return triplet_slot_geom_forward_kernel(
                *_geom_kernel_inputs(x, geo, ws, wt, m2T, lj, A, K, cfg), A,
                K, cfg)
        return fused_triplet_slot_geom_reference(x, geo, ws, wt, m2T, lj, A,
                                                 K, cfg)

    @staticmethod
    def backward(ctx, ct):
        A, K, cfg = ctx.meta
        x, geo, ws, wt, m2T, lj = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dgeo, dws, dwt = _TripletSlotGeomBwd.apply(
            x, geo, ws, wt, m2T, lj, ct, A, K, cfg, _grad_wanted(ctx, 1))
        return (dx if need[0] else None, dgeo, dws if need[2] else None,
                dwt if need[3] else None, None, None, None, None, None)


class _TripletSlotGeomBwd(torch.autograd.Function):
    """First-order VJP ``(x, geo, ws, wt, ct) -> (dx, dgeo, dws, dwt)``
    (``dgeo`` None unless asked for). CUDA tensors: the backward kernel;
    CPU tensors: ``fused_triplet_slot_geom_bwd_reference``. Its backward is
    the second-order VJP (the ``_Bg`` rule of the JAX op)."""

    @staticmethod
    def forward(ctx, x, geo, ws, wt, m2T, lj, ct, A, K, cfg, need_dgeo):
        ctx.set_materialize_grads(False)
        ctx.meta = (A, K, cfg)
        ctx.save_for_backward(x, geo, ws, wt, m2T, lj, ct)
        if x.is_cuda:
            dx, dgeo, dws, dwt = triplet_slot_geom_backward_kernel(
                *_geom_kernel_inputs(x, geo, ws, wt, m2T, lj, A, K, cfg),
                ct.float().contiguous(), A, K, cfg, need_dgeo)
        else:
            dx, dgeo, dws, dwt = fused_triplet_slot_geom_bwd_reference(
                x, geo, ws, wt, m2T, lj, ct, A, K, cfg, need_dgeo)
        return (dx.to(x.dtype), _cast(dgeo, geo, need_dgeo),
                dws.to(ws.dtype), dwt.to(wt.dtype))

    @staticmethod
    @once_differentiable
    def backward(ctx, u1, ug, u4, u5):
        A, K, cfg = ctx.meta
        x, geo, ws, wt, m2T, lj, ct = ctx.saved_tensors
        need = ctx.needs_input_grad
        if all(u is None for u in (u1, ug, u4, u5)):
            return (None,) * 11
        if x.is_cuda:
            grads = triplet_slot_geom_bwd2_kernel(
                *_geom_kernel_inputs(x, geo, ws, wt, m2T, lj, A, K, cfg),
                ct.float().contiguous(), u1, ug, u4, u5, A, K, cfg)
        else:
            grads = fused_triplet_slot_geom_bwd2_reference(
                x, geo, ws, wt, m2T, lj, ct, u1, ug, u4, u5, A, K, cfg)
        xb, geob, wsb, wtb, ctb = grads
        return (_cast(xb, x, need[0]), _cast(geob, geo, need[1]),
                _cast(wsb, ws, need[2]), _cast(wtb, wt, need[3]), None, None,
                _cast(ctb, ct, need[6]), None, None, None, None)


def fused_triplet_slot_geom(x, geo, ws, wt, m2T, lj, A: int, K: int, cfg):
    """The slot contraction of :func:`fused_triplet_slot` with the basis
    rows evaluated inside the kernels from ``geo [K, NG, E]`` =
    (theta[, phi], d_kj / cutoff), NG = 2 + has_t (see the module
    docstring). Other operands as :func:`fused_triplet_slot`; returns
    ``[E, C]`` in ``x.dtype``. Differentiable to second order."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_triplet_slot_geom runs on CUDA or the CPU, "
                         f"not {x.device}")
    return _TripletSlotGeom.apply(x, geo, ws, wt, m2T, lj, int(A), int(K),
                                  tuple(cfg))
