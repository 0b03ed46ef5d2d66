"""The timed window: train steps back to back, cycling the pool.

The host calls each step as soon as the last returns, running ahead of the
card as far as the step lets it; a CUDA event is recorded after every step
and the events are read only after the window. The window runs until the host
clock passes ``seconds`` from its start, then waits for the device: its
length covers all the work it dispatched. Launch counters of the port's
ops are read before and after.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import torch

from . import counters


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float
    step_ms: List[float]            # device time between step boundaries
    dispatch_ms: List[float]        # host: step start to train_step's return
    batches: List[int]              # pool index of each step
    launches: dict                  # the ops' counters, summed over it
    first: int                      # pool index of the next step after it


def run(step, pool, start: int, seconds: float, device) -> Window:
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    before = counters.read()
    sync()
    marks = []
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    host = []
    dispatch, batches = [], []
    i = start
    t0 = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        step(pool[i % len(pool)])
        h1 = time.perf_counter()
        dispatch.append((h1 - h0) * 1e3)
        batches.append(i % len(pool))
        i += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            host.append(h1)
        if h1 - t0 >= seconds:
            break
    sync()
    t1 = time.perf_counter()
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + host[:-1], host)]
    after = counters.read()
    return Window(steps=len(batches), seconds=t1 - t0, step_ms=step_ms,
                  dispatch_ms=dispatch, batches=batches,
                  launches={k: after[k] - before[k] for k in after},
                  first=i)
