"""Pipeline parallelism (GPipe microbatch schedule) over a ``pipe`` mesh
dimension. Port of ``dig_tpu/parallel/pp.py`` on ``torch.distributed``.

The layer stack is cut into ``P`` contiguous stages, one a rank along the
``pipe`` dimension; microbatches stream through the stages with
activations handed to the next stage by an autograd ``ppermute``
(:func:`~dig_tpu_torch.parallel.comm.ppermute`: forward to the next
stage, gradients back to the previous one). The schedule is the classic
GPipe fill/drain: ``M + P - 1`` ticks for ``M`` microbatches, bubble
fraction ``(P-1)/(M+P-1)``. The backward is the mirrored drain that
autograd runs through the hops' adjoints, as JAX derives it from the
scan's transpose.

Every stage runs every tick with the JAX package's selects (stage 0 takes
its microbatch where the others take the received activation; only the
last stage writes the output buffer), so the autograd graph has the same
shape on every rank and each hop's adjoint runs on every rank.

Contract: all stages share one activation shape, and the stacked
layer-parameter dict has a leading layer axis divisible by the stage
count.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import comm


def pp_shard_params(stacked_params: Dict[str, torch.Tensor], mesh,
                    axis: str = "pipe") -> Dict[str, torch.Tensor]:
    """This rank's contiguous slice ``[L/P, ...]`` of a stacked per-layer
    parameter dict (values ``[L, ...]``), as leaf tensors that require
    gradients."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    s = mesh.get_local_rank(axis)
    out = {}
    for k, v in stacked_params.items():
        v = torch.as_tensor(v)
        per = v.shape[0] // n
        out[k] = v[s * per:(s + 1) * per].detach().clone().requires_grad_()
    return out


def pipeline_apply(layer_fn: Callable, mesh, *, axis: str = "pipe"):
    """Returns ``apply(stacked_local, x_micro) -> outs``.

    ``layer_fn(layer_params, h) -> h`` is one layer (shape-preserving);
    ``stacked_local`` this stage's ``[L/P, ...]`` slice
    (:func:`pp_shard_params`); ``x_micro`` is ``[M, mb, ...]``
    microbatches (the same on every rank). Returns ``[M, mb, ...]``
    outputs, the same on every rank."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)

    def local_apply(params, h):
        L = next(iter(params.values())).shape[0]
        for l in range(L):
            h = layer_fn({k: v[l] for k, v in params.items()}, h)
        return h

    def apply(stacked_local, x_micro):
        M = x_micro.shape[0]
        dev = x_micro.device
        first = torch.tensor(stage == 0, device=dev)
        act = torch.zeros_like(x_micro[0])
        buf = [torch.zeros_like(x_micro[0]) for _ in range(M)]
        T = M + n - 1
        for t in range(T):
            # stage 0 injects microbatch t (clamped during drain ticks:
            # those outputs never reach the write window)
            inp = torch.where(first, x_micro[min(t, M - 1)], act)
            y = local_apply(stacked_local, inp)
            idx = t - (n - 1)
            w = min(max(idx, 0), M - 1)
            write = stage == n - 1 and 0 <= idx < M
            buf[w] = torch.where(torch.tensor(write, device=dev), y, buf[w])
            if t < T - 1:      # the last hop's activation is never read
                act = comm.ppermute(y, group)
        # only the last stage wrote buf: the sum hands it to every stage
        return comm.psum_replicated(torch.stack(buf), group)

    return apply


def make_pp_train_step(layer_fn: Callable, optimizer, mesh,
                       loss_fn: Callable, *, axis: str = "pipe"):
    """Pipeline train step ``step(params, x_micro, y_micro) -> loss``:
    ``params`` this stage's slice (:func:`pp_shard_params`), ``optimizer``
    over its values; each stage updates only its own layers (no parameter
    collective, only the activation hops). ``loss_fn(outs, y_micro) ->
    scalar``, the same on every rank."""
    papply = pipeline_apply(layer_fn, mesh, axis=axis)

    def step(params, x_micro, y_micro):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(papply(params, x_micro), y_micro)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
