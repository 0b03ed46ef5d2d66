"""The port's train utilities on the CPU: ``make_train_state``, the step
profiler, NaN checks, the in-place update check (the port's donation
check), and ``collective_selfcheck`` in a one-rank gloo group.

* ``make_train_state`` builds the module from the seeded generator and
  the optimizer from its parameters; the same seed draws the same
  weights, another seed others;
* ``StepProfiler`` writes one Chrome trace of the window's steps, each
  under ``record_function("train")``, and stops when a step raises;
  ``profile_block`` traces a region;
* ``debug_mode`` raises ``FloatingPointError`` at the first operation
  whose output holds a NaN (JAX's test case: ``log(-1)``), also where a
  NaN reaches a buffer written outside the dispatcher (a kernel's output,
  here written through numpy), stays silent on a clean SchNet step and
  restores the previous state on exit;
* ``assert_donation_discipline`` passes for ``make_step_fns``' step and
  flags a step that rebinds its weights to new storage ("copied instead
  of donating");
* ``collective_selfcheck`` on a one-rank mesh.
"""
import glob
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
from dig_tpu_torch.models import SchNet
from dig_tpu_torch.train import (StepProfiler, TrainState,
                                 assert_donation_discipline,
                                 collective_selfcheck, debug_mode,
                                 make_step_fns, make_train_state,
                                 profile_block)

KW = dict(cutoff=5.0, num_layers=1, hidden_channels=16, num_filters=16,
          num_gaussians=8, max_edges=128)


def _tiny():
    mols = synthetic_molecules(4, seed=0, max_atoms=8)
    return next(iter(MoleculeLoader(mols, 4, n_node_pad=32, device="cpu")))


def _state(seed=0):
    build = lambda gen: SchNet(device="cpu", generator=gen, **KW)
    return make_train_state(build, lambda ps: torch.optim.Adam(ps, lr=1e-3),
                            _tiny(), seed=seed)


def test_make_train_state_builds_and_seeds():
    a, b, c = _state(0), _state(0), _state(1)
    assert isinstance(a, TrainState) and a.step == 0
    assert isinstance(a.optimizer, torch.optim.Adam)
    sa, sb, sc = (s.model.state_dict() for s in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert ([id(p) for p in a.optimizer.param_groups[0]["params"]]
            == [id(p) for p in a.model.parameters() if p.requires_grad])


def test_step_profiler_writes_trace(tmp_path):
    st = _state()
    step, _ = make_step_fns(st.model, st.optimizer)
    g = _tiny()
    prof = StepProfiler(str(tmp_path / "prof"), start_step=1, num_steps=2)
    for _ in range(4):
        with prof.step():
            step(g)
    prof.stop()
    hits = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert hits == [prof.path]
    events = json.load(open(hits[0]))["traceEvents"]
    assert sum(e.get("name") == "train" for e in events) == 2
    with profile_block(str(tmp_path / "blk"), name="region"):
        step(g)
    events = json.load(open(glob.glob(str(tmp_path / "blk" /
                                           "*.json"))[0]))["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    # a raising step stops the profiler (and writes what it has)
    prof = StepProfiler(str(tmp_path / "p2"), start_step=0, num_steps=3)
    with pytest.raises(RuntimeError):
        with prof.step():
            raise RuntimeError("step failed")
    assert prof._prof is None
    # no log_dir: a no-op
    with StepProfiler(None).step():
        step(g)


def test_debug_mode_raises_on_nan():
    with debug_mode():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0)) * 0.0 + torch.sqrt(
                torch.tensor(-1.0))
    # restored afterwards
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_debug_mode_checks_buffers_filled_outside_dispatch():
    with debug_mode():
        out = torch.empty(4, 3)             # a kernel's output buffer
        out.numpy()[:] = 1.0                 # "the kernel" fills it
        out.numpy()[2, 1] = np.nan
        with pytest.raises(FloatingPointError, match="outside the"):
            out.sum()
        clean = torch.empty(5)
        clean.numpy()[:] = 2.0
        assert float(clean.sum()) == 10.0    # a clean buffer passes


def test_debug_mode_silent_on_clean_step():
    st = _state()
    step, _ = make_step_fns(st.model, st.optimizer, energy_and_force=False)
    with debug_mode():
        aux = step(_tiny())
    assert np.isfinite(float(aux["loss"]))


def test_donation_discipline_passes_for_inplace_step():
    st = _state()
    step, _ = make_step_fns(st.model, st.optimizer)
    assert_donation_discipline(step, st, _tiny())


def test_donation_discipline_flags_copying_step():
    st = _state()
    step, _ = make_step_fns(st.model, st.optimizer)

    def copying(g):
        step(g)
        with torch.no_grad():
            for p in st.model.parameters():
                p.data = p.data.clone()       # rebinds: a copy

    with pytest.raises(AssertionError, match="copied instead of donating"):
        assert_donation_discipline(copying, st, _tiny())


def test_collective_selfcheck_one_rank(tmp_path):
    from dig_tpu_torch.parallel import init_local, make_mesh
    init_local(0, 1, str(tmp_path / "store"))
    try:
        assert collective_selfcheck(make_mesh((1,), ("data",))) == {"data": 1}
    finally:
        dist.destroy_process_group()
