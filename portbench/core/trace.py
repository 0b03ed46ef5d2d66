"""A profiled stretch of train steps after the timed window, and what the
per-layer metrics read from it.

``torch.profiler`` traces the host and the card over ``steps`` steps
inside a ``portbench.window`` span that ends with a device synchronise.
The device operations (kernels, copies, sets) are read from the trace:
their busy time is the union of their intervals within the span (a copy
of ``scripts/profile_torch_step.py``'s ``_busy_us``). The port's kernels
are told apart by the names of the ``__global__`` functions in
``dig_tpu_torch/csrc/``, read from the sources; a ``sum_partials_kernel``
belongs to the port kernel launched before it.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import List, Tuple

import torch

from . import counters
from .spec import ROOT

SPAN = "portbench.window"


@dataclasses.dataclass
class Op:
    name: str
    start: float        # us
    end: float


@dataclasses.dataclass
class Trace:
    steps: int
    batches: List[int]
    window: Tuple[float, float]         # the span, us
    device_ops: List[Op]                # in start order
    host_ops: List[Op]
    launches: dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in busy_intervals(self)) / 1e6


def csrc_kernels() -> set:
    """Names of the ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for path in sorted((ROOT / "dig_tpu_torch" / "csrc").glob("*.cu*")):
        text = Path(path).read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            rest = text[m.end():]
            lb = re.match(r"__launch_bounds__\s*\(", rest)
            if lb:
                depth, j = 1, lb.end()
                while depth:
                    depth += {"(": 1, ")": -1}.get(rest[j], 0)
                    j += 1
                rest = rest[j:]
            name = re.match(r"\s*(\w+)\s*\(", rest)
            if name:
                names.add(name.group(1))
    return names


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::name<...>(...)`` -> ``name``."""
    head = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    head = head.split("<")[0].split()
    return head[-1].split("::")[-1] if head else kernel


def profile(step, pool, start: int, steps: int) -> Trace:
    from torch.profiler import DeviceType, ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    before = counters.read()
    torch.cuda.synchronize()
    batches = []
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for k in range(steps):
                batches.append((start + k) % len(pool))
                step(pool[batches[-1]])
            torch.cuda.synchronize()
    after = counters.read()
    dev, host, span = [], [], None
    for e in prof.events():
        op = Op(e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(op)
        elif e.name == SPAN:
            span = (op.start, op.end)
        else:
            host.append(op)
    if span is None:
        raise RuntimeError("the profiler recorded no window span")
    dev = [o for o in dev if o.end > span[0] and o.start < span[1]]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation: "
                           "no device trace on this machine")
    dev.sort(key=lambda o: o.start)
    return Trace(steps=steps, batches=batches, window=span, device_ops=dev,
                 host_ops=host,
                 launches={k: after[k] - before[k] for k in after})


def busy_intervals(tr: Trace):
    """The union of the device operations' intervals inside the window."""
    lo, hi = tr.window
    out = []
    for o in tr.device_ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def attributed(tr: Trace):
    """Each device operation with the port kernel it belongs to (its own
    base name, the preceding port kernel's for a ``sum_partials_kernel``)
    or None for every other operation."""
    port = csrc_kernels()
    last = None
    for o in tr.device_ops:
        b = base_name(o.name)
        if b not in port:
            yield o, None
        elif b == "sum_partials_kernel":
            yield o, last
        else:
            last = b
            yield o, b


def kernel_seconds(tr: Trace, names) -> float:
    """Device seconds of the port kernels named (their partial sums
    included)."""
    return sum(o.end - o.start for o, k in attributed(tr)
               if k in names) / 1e6


def glue_seconds(tr: Trace) -> float:
    """Device seconds of every operation that is not a port kernel."""
    return sum(o.end - o.start for o, k in attributed(tr)
               if k is None) / 1e6


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host operation running at their middle."""
    by = {}
    for o in tr.device_ops:
        name = o.name[:160]
        by[name] = by.get(name, 0.0) + (o.end - o.start) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(tr)
    edges = [tr.window[0]] + [x for iv in busy for x in iv] + [tr.window[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        cover = [h for h in tr.host_ops if h.start <= mid < h.end]
        name = max(cover, key=lambda h: h.start).name if cover else "idle"
        named.append([name[:160], length / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def steps_for(seconds: float, mean_step_s: float) -> int:
    """Steps to trace: about ``seconds`` of them, at least 3, at most
    200."""
    return max(3, min(200, int(seconds / max(mean_step_s, 1e-6)) + 1))

