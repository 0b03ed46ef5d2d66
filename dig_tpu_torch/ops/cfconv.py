"""Fused continuous-filter convolution: SchNet's interaction hot op.

Port of ``dig_tpu/ops/pallas_cfconv.py``:

    agg[g,i,f] = sum_j gate(d_gij) * W(d_gij)[f] * vj[g,j,f]
    W(d)       = sps(rbf(d) @ W1 + b1) @ W2 + b2

On a CUDA tensor ``cfconv_fused`` launches the hand-written kernels of
``csrc/cfconv.cu`` (forward, and a backward that recomputes the filter);
on a CPU tensor it runs ``cfconv_reference`` and takes its gradients by
autograd. Both are first order only. There is no fallback: a CUDA call
the kernel cannot take raises.

``launches_fwd`` / ``launches_bwd`` count kernel launches (the backward's
second, partial-sum kernel is part of the one backward launch).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..nn.blocks import shifted_softplus
from . import _build
from .basis import cosine_cutoff, gaussian_rbf

# Sentinel distance for invalid pairs (padding slots, diagonal): far beyond
# any cutoff, so the gate and the basis both evaluate to exactly 0.
MASK_DIST = 1.0e9

KERNEL_FEATURES = (32, 64, 128)  # F the kernels are compiled for
KERNEL_MAX_GAUSSIANS = 64

launches_fwd = 0
launches_bwd = 0

_SHAPES = "F must be one of 32/64/128 and R at most 64"


def reset_launch_counts() -> None:
    global launches_fwd, launches_bwd
    launches_fwd = 0
    launches_bwd = 0


def _bf16_round(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if precision == "bf16" else x


def cfconv_reference(dist, vj, w1, b1, w2, b2, *, cutoff: float,
                     num_gaussians: int, precision: str = "f32"):
    """Plain cfconv from masked distances (``pallas_cfconv.py:69-84``).

    dist: [G, n, n] with invalid pairs set to ``MASK_DIST``; vj: [G, n, F].
    With ``precision="bf16"`` the matmul operands are rounded to bf16 where
    the kernel rounds them (vj, W1, W2, rbf, h); sums stay float32.
    """
    r = lambda x: _bf16_round(x.float(), precision)
    rbf = gaussian_rbf(dist, 0.0, cutoff, num_gaussians)
    gate = torch.where(dist < cutoff, cosine_cutoff(dist, cutoff), 0.0)
    h = shifted_softplus(torch.einsum("gijr,rf->gijf", r(rbf), r(w1))
                         + b1.float())
    w = torch.einsum("gijf,fk->gijk", r(h), r(w2)) + b2.float()
    w = w * gate[..., None]
    return torch.einsum("gijf,gjf->gif", w, r(vj))


def _library() -> ctypes.CDLL:
    lib = _build.load("cfconv")
    if not getattr(lib, "_argtypes_set", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cfconv_fwd.argtypes = [P] * 7 + [I, I, I, I, Fl, I, I, P]
        lib.cfconv_fwd.restype = I
        lib.cfconv_bwd.argtypes = ([P] * 11 + [I, I, I, I, Fl, I, I, I, I,
                                               P])
        lib.cfconv_bwd.restype = I
        lib.cfconv_bwd_blocks.argtypes = [I] * 5
        lib.cfconv_bwd_blocks.restype = I
        lib._argtypes_set = True
    return lib


def _kernel_inputs(dist, vj, w1, b1, w2, b2):
    """Validate shapes/devices and return contiguous float32 tensors."""
    dev = dist.device
    G, n, _ = dist.shape
    F = vj.shape[-1]
    R = w1.shape[0]
    shapes = {"dist": (dist, (G, n, n)), "vj": (vj, (G, n, F)),
              "w1": (w1, (R, F)), "b1": (b1, (F,)), "w2": (w2, (F, F)),
              "b2": (b2, (F,))}
    for name, (t, want) in shapes.items():
        if t.device != dev:
            raise ValueError(f"cfconv_fused: {name} on {t.device}, dist on "
                             f"{dev}")
        if tuple(t.shape) != want:
            raise ValueError(f"cfconv_fused: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if not t.is_floating_point():
            raise TypeError(f"cfconv_fused: {name} must be floating point")
    if F not in KERNEL_FEATURES or not 1 <= R <= KERNEL_MAX_GAUSSIANS:
        raise ValueError(f"cfconv_fused kernel takes F in {KERNEL_FEATURES} "
                         f"and R <= {KERNEL_MAX_GAUSSIANS}; got F={F}, R={R}")
    return [t.float().contiguous() for t in (dist, vj, w1, b1, w2, b2)]


def cfconv_forward_kernel(dist, vj, w1, b1, w2, b2, cutoff, num_gaussians,
                          precision):
    """Launch the forward kernel on float32 contiguous CUDA inputs."""
    global launches_fwd
    G, n, _ = dist.shape
    F, R = vj.shape[-1], w1.shape[0]
    out = torch.empty((G, n, F), dtype=torch.float32, device=dist.device)
    rc = _library().cfconv_fwd(
        *map(_build.ptr, (dist, vj, w1, b1, w2, b2, out)), G, n, F, R,
        float(cutoff), int(num_gaussians), int(precision == "bf16"),
        _build.stream(dist.device))
    _build.check(rc, "cfconv forward kernel", _SHAPES)
    launches_fwd += 1
    return out


def cfconv_backward_kernel(dist, vj, w1, b1, w2, b2, g, cutoff,
                           num_gaussians, precision, need_dist_grad):
    """Launch the backward kernel; returns (d_dist, d_vj, dW1, db1, dW2,
    db2) in float32. d_dist is zeros when ``need_dist_grad`` is False."""
    global launches_bwd
    dev = dist.device
    G, n, _ = dist.shape
    F, R = vj.shape[-1], w1.shape[0]
    d_dist = torch.empty((G, n, n), dtype=torch.float32, device=dev)
    d_vj = torch.empty((G, n, F), dtype=torch.float32, device=dev)
    size = R * F + F + F * F + F
    d_params = torch.empty(size, dtype=torch.float32, device=dev)
    # as many blocks as the card holds at once walk whole slots; each
    # writes its weight-gradient partial sums to its row of `partial`
    lib, bf16 = _library(), int(precision == "bf16")
    grid = lib.cfconv_bwd_blocks(G, n, F, R, bf16)
    if grid <= 0:
        _build.check(grid, "cfconv backward kernel's grid", _SHAPES)
    partial = torch.empty((grid, size), dtype=torch.float32, device=dev)
    rc = lib.cfconv_bwd(
        *map(_build.ptr, (dist, vj, w1, b1, w2, b2, g, d_dist, d_vj,
                          partial, d_params)),
        G, n, F, R, float(cutoff), int(num_gaussians), bf16,
        int(bool(need_dist_grad)), grid, _build.stream(dev))
    _build.check(rc, "cfconv backward kernel", _SHAPES)
    launches_bwd += 1
    dw1, db1, dw2, db2 = torch.split(d_params, [R * F, F, F * F, F])
    return (d_dist, d_vj, dw1.view(R, F), db1, dw2.view(F, F), db2)


def _reference_backward(saved, g, cutoff, num_gaussians, precision,
                        need_dist_grad):
    """The six cotangents of ``cfconv_reference`` (CPU tensors)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in saved]
        out = cfconv_reference(*xs, cutoff=cutoff,
                               num_gaussians=num_gaussians,
                               precision=precision)
        grads = list(torch.autograd.grad(out, xs, g))
    if not need_dist_grad:
        grads[0] = torch.zeros_like(grads[0])
    return grads


class _CFConv(torch.autograd.Function):
    """CUDA tensors: the kernels. CPU tensors: the plain version. First
    order only on both, as the TPU op."""

    @staticmethod
    def forward(ctx, dist, vj, w1, b1, w2, b2, cutoff, num_gaussians,
                precision, need_dist_grad):
        ctx.meta = (cutoff, num_gaussians, precision, need_dist_grad,
                    [t.dtype for t in (dist, vj, w1, b1, w2, b2)])
        if dist.is_cuda:
            args = _kernel_inputs(dist, vj, w1, b1, w2, b2)
            out = cfconv_forward_kernel(*args, cutoff, num_gaussians,
                                        precision)
        else:
            args = (dist, vj, w1, b1, w2, b2)
            out = cfconv_reference(*args, cutoff=cutoff,
                                   num_gaussians=num_gaussians,
                                   precision=precision)
        ctx.save_for_backward(*args)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        cutoff, num_gaussians, precision, need_dist_grad, dtypes = ctx.meta
        want_dist = ctx.needs_input_grad[0]
        if g.is_cuda:
            grads = cfconv_backward_kernel(
                *ctx.saved_tensors, g.float().contiguous(), cutoff,
                num_gaussians, precision, need_dist_grad and want_dist)
        else:
            grads = _reference_backward(ctx.saved_tensors, g, cutoff,
                                        num_gaussians, precision,
                                        need_dist_grad)
        grads = [t.to(dt) for t, dt in zip(grads, dtypes)]
        return (grads[0] if want_dist else None, *grads[1:],
                None, None, None, None)


def cfconv_fused(dist, vj, w1, b1, w2, b2, cutoff: float,
                 num_gaussians: int, precision: str = "bf16",
                 need_dist_grad: bool = True):
    """Fused cfconv: dist [G,n,n] (invalid pairs = MASK_DIST), vj [G,n,F],
    w1 [R,F], b1 [F], w2 [F,F], b2 [F] -> agg [G,n,F] float32.

    ``precision`` ("bf16" | "f32") is the type of the products' operands;
    sums are always float32. ``need_dist_grad=False`` skips the geometry
    gradient: d(agg)/d(dist) is then ZERO — only for energy-only training.
    First order only: a double backward raises.
    """
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got "
                         f"{precision!r}")
    if dist.device.type not in ("cuda", "cpu"):
        raise ValueError(f"cfconv_fused runs on CUDA or the CPU, not "
                         f"{dist.device}")
    return _CFConv.apply(dist, vj, w1, b1, w2, b2, cutoff, num_gaussians,
                         precision, need_dist_grad)
