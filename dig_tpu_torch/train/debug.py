"""Debug mode: NaN checks, in-place update asserts, collective self-checks.
Port of ``dig_tpu/train/debug.py``.

* :func:`debug_mode` — context manager that raises ``FloatingPointError``
  at the first operation whose floating output holds a NaN (the
  counterpart of ``jax_debug_nans``), through a ``TorchDispatchMode``.
* :func:`assert_donation_discipline` — runs a step and asserts that it
  updated every parameter and optimizer-state tensor in place.
* :func:`collective_selfcheck` — runs all_reduce / all_gather / a ring
  send-receive over every dimension of a ``DeviceMesh`` with known
  per-rank inputs and asserts the exact results.

Deliberate deviations: the JAX package checks that a donated step
invalidated its input buffers and that reading them afterwards raises;
PyTorch has no donation, so the port checks the in-place update (same
storage, values changed), which is what donation buys, and has nothing to
check for the reuse of a donated buffer.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# factory ops whose outputs are uninitialised memory, often filled
# afterwards by a kernel outside the dispatcher
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "empty_permuted"}


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and bool(torch.isnan(t).any()))


class _NanCheck(TorchDispatchMode):
    """Checks every floating output for NaN. Outputs of the factory ops
    (``empty*``, ``new_empty*``) are not checked when made: they are
    *pending*, and checked when an operation first reads them (a kernel
    writes them through a pointer, outside the dispatcher, so that read
    is where its output is first seen). Views of a pending tensor are
    pending too; an operation that writes a pending tensor in place
    clears it."""

    def __init__(self):
        super().__init__()
        self._pending: Dict[int, weakref.ref] = {}

    def _pend(self, t: torch.Tensor) -> None:
        k = id(t)
        self._pending[k] = weakref.ref(t, lambda _, k=k:
                                       self._pending.pop(k, None))

    def _is_pending(self, t) -> bool:
        if not isinstance(t, torch.Tensor):
            return False
        r = self._pending.get(id(t))
        return r is not None and r() is t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        out = func(*args, **kwargs)
        if name in _FACTORIES:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._pend(t)
            return out
        schema = func._schema
        written = set()
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in tree_leaves(v):
                    written.add(id(t))
        is_view = any(r.alias_info is not None and not r.alias_info.is_write
                      for r in schema.returns)
        inputs = [t for t in tree_leaves((args, kwargs)) if
                  self._is_pending(t)]
        if is_view:
            if inputs:
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        self._pend(t)
            return out
        for t in inputs:
            self._pending.pop(id(t), None)
            if id(t) not in written and _has_nan(t):
                raise FloatingPointError(
                    f"NaN in a tensor written outside the dispatcher (a "
                    f"kernel's output), first read by {func}")
        for t in tree_leaves(out):
            if _has_nan(t):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Raise ``FloatingPointError`` at the first operation in the enclosed
    region whose floating output holds a NaN (each check reads the result
    on the host, so the region runs synchronously). The previous state is
    restored on exit."""
    if not nan_checks:
        yield
        return
    with _NanCheck():
        yield


def _state_tensors(state):
    """(name, tensor) of every parameter and optimizer-state tensor of a
    ``TrainState`` (``model``, ``optimizer``)."""
    out = [(f"param {n}", p) for n, p in state.model.named_parameters()]
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out.append((f"optimizer {k} of {names.get(id(p), '?')}", v))
    return out


def assert_donation_discipline(step_fn, state, batch) -> None:
    """Run ``step_fn(batch)`` (a stateful step over ``state``, a
    :class:`~dig_tpu_torch.train.trainer.TrainState`) and assert that it
    updated every parameter and optimizer-state tensor in place: the
    same tensor objects on the same storage, and at least one value
    changed. An optimizer whose state is made at its first step (Adam's)
    takes one step first, so that there is state to watch.

    Raises AssertionError if the step rebound a tensor to new storage
    ("copied instead of donating"), or changed nothing."""
    if not state.optimizer.state:
        step_fn(batch)
    before = [(name, t, t.data_ptr(), t.detach().clone())
              for name, t in _state_tensors(state)]
    step_fn(batch)
    after = {id(t): t for _, t in _state_tensors(state)}
    moved = [name for name, t, ptr, _ in before
             if after.get(id(t)) is not t or t.data_ptr() != ptr]
    if moved or len(after) != len(before):
        raise AssertionError(
            "the step copied instead of donating: it rebound "
            f"{moved[:5] or 'the optimizer state'} instead of updating them "
            "in place")
    if not any(not torch.equal(t.detach(), old) for _, t, _, old in before):
        raise AssertionError("the step updated no parameter or optimizer "
                             "state")


def collective_selfcheck(mesh, axis: Optional[str] = None) -> dict:
    """Run known-answer collectives over every dimension of ``mesh`` (a
    ``torch.distributed`` ``DeviceMesh``; only ``axis`` when given) and
    assert exact results on every rank: the sum of the ranks' indices
    along the dimension, their all-gather in order, and a ring hop (each
    index sent to the next rank, received from the previous). Returns
    ``{dim: size}``; raises AssertionError on every rank otherwise."""
    dev = mesh.device_type
    checked = {}
    names = [axis] if axis else list(mesh.mesh_dim_names)
    for ax in names:
        group = mesh.get_group(ax)
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        x = torch.tensor([float(me)], device=dev)
        tot = x.clone()
        dist.all_reduce(tot, group=group)
        gathered = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(gathered, x, group=group)
        nbr = torch.empty_like(x)
        if n > 1:
            nxt = dist.get_global_rank(group, (me + 1) % n)
            prv = dist.get_global_rank(group, (me - 1) % n)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, nxt, group),
                dist.P2POp(dist.irecv, nbr, prv, group)])
            for r in reqs:
                r.wait()
        else:
            nbr.copy_(x)
        ok = torch.tensor([
            float(tot.item() == n * (n - 1) / 2),
            float(torch.equal(torch.cat(gathered).cpu(),
                              torch.arange(n, dtype=torch.float32))),
            float(nbr.item() == (me - 1) % n)], device=dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
        if not bool(torch.all(ok == 1.0)):
            bad = [c for c, v in zip(("all_reduce", "all_gather",
                                      "ring send/recv"), ok.tolist())
                   if v != 1.0]
            raise AssertionError(
                f"collective self-check FAILED on mesh dimension {ax!r}: "
                f"{bad} returned wrong results — the process groups are "
                "miswired")
        checked[ax] = n
    return checked
