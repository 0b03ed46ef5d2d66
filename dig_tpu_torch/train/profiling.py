"""Profiler integration. Port of ``dig_tpu/train/profiling.py`` on
``torch.profiler``.

Two entry points:

* :class:`StepProfiler` — records a window of training steps (start step /
  number of steps) with ``torch.profiler`` (CPU and, where there is a
  card, CUDA activity), each step under ``record_function("train")``.
  ``Run3D(profile_dir=...)`` drives it.
* :func:`profile_block` — context manager for ad-hoc tracing of any region.

Deliberate deviation: the traces are Chrome trace JSON files
(``<log_dir>/trace_<n>.json``, readable in Perfetto or
``chrome://tracing``), where the JAX package writes XPlane protobufs
(``*.xplane.pb``).
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _next_path(log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(log_dir, f"trace_{n}.json")):
        n += 1
    return os.path.join(log_dir, f"trace_{n}.json")


class StepProfiler:
    """Trace a window of steps: [start_step, start_step + num_steps).

    Call :meth:`step` once per optimization step *around* the step (it
    returns a context manager). A no-op when ``log_dir`` is falsy.

        prof = StepProfiler(log_dir, start_step=10, num_steps=5)
        for g in loader:
            with prof.step():
                train_step(g)
        prof.stop()  # idempotent; also stops after the window

    The window is ``torch.profiler.schedule(wait=start_step, warmup=0,
    active=num_steps, repeat=1)``; the trace is written when the window
    closes (or at :meth:`stop`) to ``log_dir/trace_<n>.json``
    (:attr:`path`).
    """

    def __init__(self, log_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start_step
        self.end = start_step + num_steps
        self.path: Optional[str] = None
        self._n = 0
        self._prof = None
        if log_dir:
            with warnings.catch_warnings():
                # no warm-up step: the window is the JAX package's
                warnings.filterwarnings("ignore", message=".*warmup.*")
                self._prof = profile(
                    activities=_activities(),
                    schedule=torch.profiler.schedule(
                        wait=start_step, warmup=0, active=num_steps,
                        repeat=1),
                    on_trace_ready=self._write)
            self._prof.start()

    def _write(self, prof) -> None:
        self.path = _next_path(self.log_dir)
        prof.export_chrome_trace(self.path)

    @contextlib.contextmanager
    def step(self):
        if self._prof is None:
            yield
            return
        try:
            if self.start <= self._n < self.end:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                with record_function("train"):
                    yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            else:
                yield
        except BaseException:
            # stop the trace when the step raises (OOM, NaN checks): a
            # dangling profiler would hold its buffers and never write
            self.stop()
            raise
        self._n += 1
        if self._prof is not None:
            self._prof.step()
            if self._n >= self.end:
                self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()


@contextlib.contextmanager
def profile_block(log_dir: str, name: str = "block"):
    """Trace an arbitrary region into ``log_dir/trace_<n>.json``."""
    path = _next_path(log_dir)
    with profile(activities=_activities()) as prof:
        with record_function(name):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
