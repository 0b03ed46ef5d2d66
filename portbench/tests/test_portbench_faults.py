"""The check at a test size on the CPU: a sound run of each cell comes
out correct; with the timed path broken underneath (a step that leaves
its state unchanged; half of each batch left out, the mean taken over
the rest; an answer altered where it is produced) the rest of a run comes
out not correct; and the control, the reference in TF32 in the program's
place, reads gaps far above the sound run's. (One card: no exchange
between chips to leave out.)"""
import time

import pytest
import torch

from portbench.core import check, session, spec
from portbench.tests._tiny import use_tiny

CPU = torch.device("cpu")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    use_tiny(monkeypatch, 2)


def _run(cell, seed=5):
    return session.run(cell, seed, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert check.correct(_run(cell).checks)


def _halve(batch):
    """Mask out every other molecule of a batch of any of the port's
    layouts."""
    if isinstance(batch, dict):
        return {k: _halve(b) for k, b in batch.items()}
    if hasattr(batch, "graph_mask"):
        keep = torch.arange(batch.num_graphs) % 2 == 0
        return batch.replace(graph_mask=batch.graph_mask & keep,
                             node_mask=batch.node_mask
                             & keep[batch.node_graph.long()])
    keep = torch.arange(batch.num_graphs) % 2 == 0
    return batch.replace(node_mask=batch.node_mask & keep[:, None],
                         globals={**batch.globals, "mol_mask":
                                  batch.globals["mol_mask"] & keep[:, None]})


def _state_unchanged(model, opt, step):
    opt.step = lambda *a, **k: None
    return model, opt, step


def _answer_altered(model, opt, step):
    forward = model.forward
    model.forward = lambda *a, **k: forward(*a, **k) * 1.001
    return model, opt, step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    prog = spec.module("models", spec.cell(cell)["config"])
    build, pool = prog.build, prog.pool
    if fault == "half_batch":
        monkeypatch.setattr(prog, "pool", lambda *a: [_halve(b)
                                                      for b in pool(*a)])
    else:
        wrap = {"state_unchanged": _state_unchanged,
                "answer_altered": _answer_altered}[fault]
        monkeypatch.setattr(prog, "build", lambda *a: wrap(*build(*a)))
    assert not check.correct(_run(cell).checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program(cell):
    p = session.prepare(cell, 9, CPU)
    program = session.first_steps(p)
    session.free(p)
    ref = session.reference(p)
    limits = spec.limits(cell)
    steps = limits.get("loss_steps", session.CHECKED_STEPS)
    sound = check.gaps(program, ref, steps)
    control = check.gaps(session.reference(p, "tf32"), ref, steps)
    assert max(control[n] / max(sound[n], 1e-12) for n in check.NAMES) > 10
    assert not check.correct(check.judge(control, limits))
