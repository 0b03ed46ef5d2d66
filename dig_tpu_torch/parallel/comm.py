"""Collectives with autograd, and a count of the collectives issued.

The JAX package's ``shard_map`` bodies call ``all_to_all``, ``ppermute``,
``all_gather`` and ``psum``, and JAX differentiates them. Here each is a
``torch.autograd.Function`` over a process group whose backward is its
adjoint:

* :func:`all_to_all` — chunk ``q`` of the leading axis goes to rank ``q``;
  adjoint: the same exchange of the cotangents.
* :func:`ppermute` — every rank sends to the rank ``shift`` ahead and
  receives from the one ``shift`` behind (one ``batch_isend_irecv``);
  adjoint: the reverse hop. At group size 1 it is the identity.
* :func:`all_gather` — every rank's tensor stacked on a new leading axis;
  adjoint: this rank's row of the cotangent summed over the group (a
  reduce-scatter, as an all-reduce and a slice, which gloo also runs).
* :func:`psum_replicated` — the sum over the group of a tensor whose
  result the caller then uses identically on every rank (a replicated
  output); adjoint: the identity, as each rank already holds the whole
  cotangent.

Every rank must make the same calls in the same order, in the forward and
in the backward (the models keep every exchange's output in the graph of
the loss on every rank, so autograd runs each adjoint everywhere).

``counts`` tallies the collectives issued through these wrappers and
:func:`all_reduce_` (forward and backward alike), by kind; the scaling
probe reads it where the JAX package parses HLO text.
"""
from __future__ import annotations

from collections import Counter
from typing import List

import torch
import torch.distributed as dist

counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM):
    """In-place ``dist.all_reduce``, counted."""
    counts["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    counts["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _a2a(ct, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x [P, ...]`` (P the group size): row ``q`` is sent to rank ``q``;
    returns ``[P, ...]`` whose row ``p`` came from rank ``p``."""
    return _AllToAll.apply(x, group)


def _hop(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    counts["ppermute"] += 1
    g = group if group is not None else dist.group.WORLD
    me = dist.get_rank(g)
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(g, (me + shift) % n)
    frm = dist.get_global_rank(g, (me - shift) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])
    for r in reqs:
        r.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _hop(x, group, shift)

    @staticmethod
    def backward(ctx, ct):
        return _hop(ct, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` ahead in ``group`` (cyclically) and
    return what the rank ``shift`` behind sent."""
    return _PPermute.apply(x, group, shift)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    counts["all_gather"] += 1
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in
                                 range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, ct):
        ct = all_reduce_(ct.contiguous().clone(), ctx.group)
        return ct[dist.get_rank(ctx.group)], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``[P, ...]``."""
    return _AllGather.apply(x, group)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``, for a result every rank then uses
    the same way (its cotangent is the same on every rank)."""
    return _PsumReplicated.apply(x, group)
