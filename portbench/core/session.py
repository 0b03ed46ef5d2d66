"""One run of one cell: set-up, the timed window, the traced stretch, and
the check against the plain reference.

Set-up builds the port's model, Adam and train step once, with weights
drawn from the seed, and the pool of batches through the port's loaders.
It drives that same step through the pool's first batches: steps 1-3 are
the ones the reference follows (their losses, the gradient Adam holds
after step 1, the weights after step 3 are kept), step 4 completes the
warm-up of every batch's shapes. The window then runs on from step 5.
After the window (and the traced stretch) the peak memory is read, the
program's state is freed, and the reference runs.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch

from . import check, spec, trace as trace_mod, traffic as traffic_mod
from . import weights as weights_mod
from . import window as window_mod
from ..reference import common

CHECKED_STEPS = 3
BETA1 = 0.9


@dataclasses.dataclass
class Record:
    cell: str
    config: str
    cfg: dict
    traffic: dict
    device: torch.device
    setup_s: float
    graphs_per_batch: list
    window: window_mod.Window
    trace: Optional[trace_mod.Trace]
    peak_bytes: int
    checks: dict
    groups: list

    def work(self, i: int) -> dict:
        """The work of pool batch ``i`` (its molecules, counted by the
        benchmark's own geometry)."""
        cache = self.__dict__.setdefault("_work", {})
        if i not in cache:
            fl = spec.module("flops", self.config)
            cache[i] = fl.work(self.cfg, self.traffic, self.groups[i],
                               self.device)
        return cache[i]

    def flops(self, batches) -> float:
        fl = spec.module("flops", self.config)
        per = {i: fl.step_flops(self.cfg, self.traffic, self.work(i))
               for i in set(batches)}
        return sum(per[i] for i in batches)

    def kernel_calls(self, batches) -> dict:
        """``{family: (launches, bound ms)}`` summed over ``batches``."""
        fl = spec.module("flops", self.config)
        out = {}
        for i in batches:
            for fam, (n, ms) in fl.kernel_calls(self.cfg, self.traffic,
                                                self.work(i)).items():
                a, b = out.get(fam, (0, 0.0))
                out[fam] = (a + n, b + ms)
        return out


def _program_readings(losses, g1, w0, w3) -> dict:
    """The program's step losses, the norm per leaf of its first gradient
    (``g1``, from Adam's state after step 1) and of its change from ``w0``
    to ``w3`` (the weights after step 3)."""
    return {"losses": [float(x) for x in losses],
            "grad": {k: float(v.norm()) for k, v in g1.items()},
            "change": {k: float((w3[k] - w0[k]).norm()) for k in w3}}


@dataclasses.dataclass
class Prepared:
    cell: str
    cfg: dict
    traffic: dict
    ref: object
    groups: list
    w0: dict
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    step: object
    pool: list


def prepare(cell_name: str, seed: int, device) -> Prepared:
    """Molecules and weights from the seed, the port's model, Adam and
    step, and the pool through the port's loaders."""
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    prog = spec.module("models", cell["config"])
    ref = spec.module("reference", cell["config"])
    common.set_fp32_flags()
    groups = traffic_mod.groups(traffic, seed)
    w0 = weights_mod.draw(ref.param_spec(cfg), seed, device)
    model, opt, step = prog.build(cfg, traffic, w0, device)
    pool = prog.pool(cfg, traffic, groups, device)
    return Prepared(cell_name, cfg, traffic, ref, groups, w0, model, opt,
                    step, pool)


def first_steps(p: Prepared) -> dict:
    """Drive the step through every pool batch once; returns the readings
    of steps 1-3 (:func:`_program_readings`)."""
    names = {q: k for k, q in p.model.named_parameters()}
    losses, g1, w3 = [], None, None
    for i in range(len(p.pool)):
        out = p.step(p.pool[i])
        if i < CHECKED_STEPS:
            losses.append(out["loss"].detach().clone())
        if i == 0:
            g1 = {names[q]: (p.opt.state[q]["exp_avg"] / (1 - BETA1)).clone()
                  if "exp_avg" in p.opt.state.get(q, {})
                  else torch.zeros_like(q) for q in names}
        if i == CHECKED_STEPS - 1:
            w3 = {names[q]: q.detach().clone() for q in names}
    return _program_readings(losses, g1, p.w0, w3)


def reference(p: Prepared, precision: str = "f32",
              half_batch: bool = False) -> dict:
    """The reference's readings of steps 1-3 from the same weights on the
    same molecules; ``half_batch`` leaves out the second half of each
    batch (a fault, for the check's calibration)."""
    batches = [g[:len(g) // 2] if half_batch else g for g in p.groups]
    lag = lambda P, mols, prec: p.ref.loss_and_grads(P, mols, p.cfg,
                                                     p.traffic, prec)
    return common.follow(lag, p.w0, batches, p.traffic["lr"],
                         common.Precision(precision), CHECKED_STEPS)


def free(p: Prepared) -> None:
    """Drop the program's state (model, optimizer, pool) and the card's
    cached blocks."""
    p.model = p.opt = p.step = p.pool = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Record:
    """Set-up, first steps, window, traced stretch, check."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(0, device=device)       # the context, for the stats
        torch.cuda.reset_peak_memory_stats(device)
    p = prepare(cell_name, seed, device)
    program = first_steps(p)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    win = window_mod.run(p.step, p.pool, len(p.pool), seconds, device)
    tr = None
    if trace:
        mean_s = win.seconds / max(win.steps, 1)
        tr = trace_mod.profile(p.step, p.pool, win.first, trace_mod.steps_for(
            p.traffic["trace_seconds"], mean_s))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    free(p)

    limits = spec.limits(cell_name)
    values = check.gaps(program, reference(p),
                        limits.get("loss_steps", CHECKED_STEPS))
    return Record(cell=cell_name, config=spec.cell(cell_name)["config"],
                  cfg=p.cfg, traffic=p.traffic,
                  device=device, setup_s=setup_s,
                  graphs_per_batch=[len(g) for g in p.groups], window=win,
                  trace=tr, peak_bytes=peak,
                  checks=check.judge(values, limits),
                  groups=p.groups)
