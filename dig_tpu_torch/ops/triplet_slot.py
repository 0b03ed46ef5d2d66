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
once.) Gradients are float32, cast to each input's dtype at the end. A
triplet whose ``lj`` lies outside ``[0, A)`` contributes zero.

On a CUDA tensor ``fused_triplet_slot`` launches the hand-written kernels
of ``csrc/triplet_slot.cu``; on a CPU tensor it runs
``fused_triplet_slot_reference`` and takes its gradients by autograd.
First order only: the second-order kernel (``_run_bwd2``) comes with
force training (ROADMAP queue 2 item 3). ``launches_fwd`` /
``launches_bwd`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .basis import make_bessel_funcs, make_sph_funcs_full, make_sph_funcs_m0

KERNEL_CHANNELS = (32, 64, 128)   # C the kernels are compiled for

launches_fwd = 0
launches_bwd = 0

_SHAPES = "C must be one of 32/64/128"
_SECOND_ORDER = ("fused_triplet_slot is first order only: the second-order "
                 "kernel (pallas_triplet_slot.py:501 _run_bwd2) comes with "
                 "the SphereNet force-training slice (ROADMAP queue 2 item 3)")


def reset_launch_counts() -> None:
    global launches_fwd, launches_bwd
    launches_fwd = 0
    launches_bwd = 0


def basis_pt_k(num_spherical: int, num_radial: int, theta, phi, dk,
               has_t: bool) -> torch.Tensor:
    """Packed basis table ``[K, R, E]`` from ``[K, E]`` per-triplet
    scalars (s-leading): the bessel rows of ``dk`` (l-major), Y_l^0(theta),
    then, with ``has_t``, Y_l^m(theta, phi)."""
    rows = [f(dk) for row in make_bessel_funcs(num_spherical, num_radial)
            for f in row]
    rows += [f(theta) for f in make_sph_funcs_m0(num_spherical)]
    if has_t:
        rows += [f(theta, phi) for f in make_sph_funcs_full(num_spherical)]
    return torch.stack(rows, dim=1)


def _round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back to float32, with an identity
    derivative (the kernel's gradients are float32 throughout)."""
    if dtype == torch.float32:
        return t
    return t + (t.to(dtype).float() - t).detach()


def fused_triplet_slot_reference(x, pt, ws, wt, m2T, lj, A: int, K: int,
                                 cfg) -> torch.Tensor:
    """Plain version of the slot contraction (differentiable by autograd).

    The JAX oracle (``fused_triplet_slot_ref``) gathers x with an [N, E]
    one-hot; here the gather is ``x.view(N, K, C)[slot*A + lj, s]``, the
    same function without the ~0.5 GB one-hot per s at the flagship shape.
    """
    n, k, has_t = cfg
    E, C = x.shape
    nk = n * k
    md = x.dtype
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
    return out.to(md)


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
        lib._argtypes_set = True
    return lib


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
        if t.device != x.device:
            raise ValueError(f"fused_triplet_slot: {name} on {t.device}, x "
                             f"on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_triplet_slot: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
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


def triplet_slot_backward_kernel(x, pt, ws, wt, m2T, lj, ct, A, K, cfg,
                                 need_dpt):
    """Launch the backward kernel; returns float32 ``(dx, dpt, dws, dwt)``,
    ``dpt`` None unless ``need_dpt``. ``ct`` is float32 ``[E, C]``."""
    global launches_bwd
    n, k, has_t = cfg
    E, C = x.shape
    dev = x.device
    nk, ntk = n * k, (n * n * k if has_t else 0)
    dx = torch.empty((E, C), dtype=torch.float32, device=dev)
    dpt = (torch.empty(pt.shape, dtype=torch.float32, device=dev)
           if need_dpt else None)
    blocks = (E // (A * K)) * K          # one block per (slot, s)
    size = (nk + ntk) * C
    partial = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    dw = torch.empty(size, dtype=torch.float32, device=dev)
    rc = _library().triplet_slot_bwd(
        *map(_build.ptr, (x, pt, m2T, ws, wt, lj, ct, dx, dpt, partial, dw)),
        E, A, K, n, k, int(bool(has_t)), C, int(x.dtype == torch.bfloat16),
        int(bool(need_dpt)), blocks, _build.stream(dev))
    _build.check(rc, "triplet_slot backward kernel", _SHAPES)
    launches_bwd += 1
    dws = dw[:nk * C].view(nk, C)
    dwt = (dw[nk * C:].view(ntk, C) if has_t
           else torch.zeros((1, C), dtype=torch.float32, device=dev))
    return dx, dpt, dws, dwt


def _reference_backward(saved, ct, A, K, cfg):
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in saved[:4]]
        out = fused_triplet_slot_reference(*xs, *saved[4:], A, K, cfg)
        grads = torch.autograd.grad(out, xs, ct.to(out.dtype),
                                    allow_unused=True)   # wt without torsion
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, xs)]


class _TripletSlot(torch.autograd.Function):
    """CUDA tensors: the kernels. CPU tensors: the plain version. First
    order only."""

    @staticmethod
    def forward(ctx, x, pt, ws, wt, m2T, lj, A, K, cfg):
        ctx.meta = (A, K, cfg, [t.dtype for t in (x, pt, ws, wt)])
        if x.is_cuda:
            args = _kernel_inputs(x, pt, ws, wt, m2T, lj, A, K, cfg)
            out = triplet_slot_forward_kernel(*args, A, K, cfg)
        else:
            args = (x, pt, ws, wt, m2T, lj)
            out = fused_triplet_slot_reference(*args, A, K, cfg)
        ctx.save_for_backward(*args)
        return out

    @staticmethod
    def backward(ctx, ct):
        if torch.is_grad_enabled():
            raise NotImplementedError(_SECOND_ORDER)
        A, K, cfg, dtypes = ctx.meta
        saved = ctx.saved_tensors
        if ct.is_cuda:
            grads = triplet_slot_backward_kernel(
                *saved, ct.float().contiguous(), A, K, cfg,
                ctx.needs_input_grad[1])
        else:
            grads = _reference_backward(saved, ct, A, K, cfg)
        out = [None if g is None or not need else g.to(dt)
               for g, dt, need in zip(grads, dtypes, ctx.needs_input_grad)]
        return (*out, None, None, None, None, None)


def fused_triplet_slot(x, pt, ws, wt, m2T, lj, A: int, K: int, cfg):
    """Slot-resident fused triplet interaction (see the module docstring).

    ``x [E, C]`` edge features in the slot-aligned NK layout
    (E = G*A*K), ``pt [K, R, E]`` packed basis (:func:`basis_pt_k`),
    ``ws [n*k, C]``, ``wt [n*n*k | 1, C]``, ``m2T [K, E]`` triplet mask,
    ``lj [1, E]`` slot-local sender ids (int32); ``cfg = (num_spherical,
    num_radial, has_t)``. Returns ``[E, C]`` in ``x.dtype``. First order
    only: a double backward raises.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_triplet_slot runs on CUDA or the CPU, not "
                         f"{x.device}")
    return _TripletSlot.apply(x, pt, ws, wt, m2T, lj, int(A), int(K),
                              tuple(cfg))
