"""Process-group entry point + elastic-training scaffolding. Port of
``dig_tpu/parallel/distributed.py`` on ``torch.distributed``.

* :func:`initialize` sets up the process group from torchrun's
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``) or explicit arguments; with one process it is a no-op
  returning False, so scripts call it unconditionally. The JAX package
  reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``: the names differ deliberately, as torchrun sets
  these.
* :func:`global_mesh`, :class:`CheckpointOnSignal` and
  :class:`RestartableLoader` as in the JAX package.
* :func:`init_local` and :func:`spawn_local` run ``P`` ranks on one host
  over a ``file://`` store (the tests' gloo groups, a world-size-1 NCCL
  group on one card).
"""
from __future__ import annotations

import os
import signal
import threading
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group: ``coordinator_address`` (``host:port``,
    default ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` (default
    ``WORLD_SIZE``), ``process_id`` (default ``RANK``); ``backend``
    default NCCL where there is a card, else gloo. Under NCCL the process
    takes card ``LOCAL_RANK``. One process (or no address) is a no-op
    returning False."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False
    backend = backend or _default_backend()
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(axis_names=("data",), shape=None):
    """A ``DeviceMesh`` over every rank of the process group: ``shape``, or
    all ranks on the first dimension."""
    from .mesh import make_mesh
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return make_mesh(shape, axis_names)


def init_local(rank: int, world_size: int, store: str,
               backend: str = "gloo",
               timeout: Optional[float] = None) -> None:
    """Join a process group of ``world_size`` ranks on this host through
    the file store ``store`` (a path that does not exist yet, the same for
    every rank). Under NCCL the rank takes card ``rank % device_count``.
    ``timeout``: seconds a collective may wait (default: torch's)."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world_size, rank=rank, **kw)


def _entry(rank: int, fn, world_size: int, store: str, backend: str,
           out_dir: str, args, timeout: float) -> None:
    torch.set_num_threads(1)
    init_local(rank, world_size, store, backend, timeout)
    try:
        res = ("ok", fn(rank, world_size, *args))
    except Exception:                         # reported to the parent
        res = ("error", traceback.format_exc())
    torch.save(res, os.path.join(out_dir, f"result_{rank}.pt"))
    dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, workdir: str,
                args: Sequence = (), backend: str = "gloo",
                timeout: float = 300.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new
    processes, each a rank of a process group over a file store under
    ``workdir``, one thread each; returns the ranks' results in rank order
    (``torch.save``-able values), or raises with the first failing rank's
    traceback. ``fn`` must be importable by the children (a module-level
    function). The ranks fork from a ``forkserver`` process, started once
    a process with ``fn``'s module imported (a fresh interpreter, so no
    thread of this process is forked), so a rank starts without importing
    torch again. A collective that waits ``timeout`` seconds fails its
    rank, and the ranks are stopped when the whole run takes longer than
    twice that."""
    import multiprocessing

    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        [fn.__module__])
    ctx = mp.start_processes(
        _entry, args=(fn, world_size, store, backend, workdir, tuple(args),
                      timeout),
        nprocs=world_size, join=False, start_method="forkserver")
    deadline = time.monotonic() + 2 * timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world_size} ranks ran over "
                               f"{2 * timeout:.0f} s")
    out = []
    for r in range(world_size):
        status, val = torch.load(os.path.join(workdir, f"result_{r}.pt"),
                                 weights_only=False)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {world_size} failed:\n{val}")
        out.append(val)
    return out


class CheckpointOnSignal:
    """Preemption safety net: on SIGTERM/SIGUSR1 (and optionally SIGINT),
    sets a flag the training loop polls; the loop then saves and exits
    cleanly. Optionally calls ``save_fn()`` directly from the handler for
    loops that cannot poll.

    Usage::

        guard = CheckpointOnSignal(save_fn=lambda: ckpt.save(state))
        for step, batch in loader:
            ...
            if guard.should_stop:   # poll once per step
                break
    """

    def __init__(self, save_fn: Optional[Callable[[], None]] = None,
                 signals=(signal.SIGTERM,), immediate: bool = False):
        self.save_fn = save_fn
        self.immediate = immediate
        self._stop = threading.Event()
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self._stop.set()
        if self.immediate and self.save_fn is not None:
            self.save_fn()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def finalize(self):
        """Save (if not already) and restore previous signal handlers."""
        if self._stop.is_set() and not self.immediate and self.save_fn:
            self.save_fn()
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclass
class IteratorState:
    epoch: int = 0
    step: int = 0


class RestartableLoader:
    """Deterministic, resumable epoch iterator over any loader whose
    shuffling is a pure function of (seed, epoch) — all dig_tpu_torch
    loaders.

    ``state_dict()`` / ``load_state_dict`` capture (epoch, step); after
    restore, iteration skips already-consumed batches of the current epoch
    so a preempted run continues exactly where it stopped."""

    def __init__(self, loader):
        self.loader = loader
        self.state = IteratorState()

    def state_dict(self):
        return {"epoch": self.state.epoch, "step": self.state.step}

    def load_state_dict(self, d):
        self.state = IteratorState(int(d["epoch"]), int(d["step"]))

    def epochs(self, num_epochs: int) -> Iterator:
        """Yields (epoch, step, batch), resuming from the stored state."""
        while self.state.epoch < num_epochs:
            if hasattr(self.loader, "epoch"):
                # pin the loader's epoch counter for deterministic shuffles
                self.loader.epoch = self.state.epoch
            skip = self.state.step
            for k, batch in enumerate(iter(self.loader)):
                if k < skip:
                    continue
                # advance BEFORE yielding: a state_dict() taken after the
                # consumer finishes this batch records the next step to run
                self.state.step = k + 1
                yield self.state.epoch, k, batch
            self.state.epoch += 1
            self.state.step = 0
