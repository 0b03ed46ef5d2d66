"""Port's Run3D, evaluate and checkpoints, on the CPU.

* ``Run3D().run(energy_and_force=True, slot_size=A)`` (the README's entry
  point) for two tiny epochs of the slot model: finite losses and MAEs,
  the StepLR schedule applied per step, and a checkpoint of the best epoch
  that restores into a fresh model with the same validation MAE.
* ``evaluate`` against the JAX ``evaluate`` on transplanted weights, with
  the energy+force eval step: float32 MAEs agree to 1e-5 relative (sums
  in another order through two layers).
* ``Checkpointer`` keeps the newest ``max_to_keep``; ``partial_restore``
  takes only entries of the same key and shape.
"""
import json
import math

import flax
import numpy as np
import optax
import pytest
import torch

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.models import SphereNet as JSphereNet
from dig_tpu.threed import ThreeDEvaluator as JEvaluator
from dig_tpu.train import make_step_fns as j_make_step_fns
from dig_tpu.train import make_train_state
from dig_tpu.train.trainer import evaluate as j_evaluate
from dig_tpu_torch.convert import spherenet_from_flax
from dig_tpu_torch.datasets import MoleculeLoader as TLoader
from dig_tpu_torch.models import SphereNet as TSphereNet
from dig_tpu_torch.threed import Run3D, ThreeDEvaluator, run
from dig_tpu_torch.train import (Checkpointer, evaluate, make_step_fns,
                                 partial_restore)

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8,
          block_size=A)
SLOT = dict(pallas_triplet=True, pallas_fuse_basis=True, pallas_slot=True)


def _data(seed, n):
    """Molecules with forces and one energy target (the models' output)."""
    mols = synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=A,
                               box=6.0, with_forces=True)
    return [dict(m, y=m["y"][:1]) for m in mols]


def test_run3d_energy_and_force_two_epochs(tmp_path):
    model = TSphereNet(device="cpu", **KW, **SLOT)
    res = Run3D().run(_data(0, 8), _data(1, 4), _data(2, 4), model,
                      ThreeDEvaluator(), epochs=2, batch_size=4,
                      vt_batch_size=4, lr=5e-4, lr_decay_step_size=1,
                      energy_and_force=True, p=100.0, slot_size=A,
                      save_dir=str(tmp_path / "ckpt"),
                      log_dir=str(tmp_path / "log"), quiet=True,
                      device="cpu")
    assert np.isfinite(res["best_valid"]) and np.isfinite(res["best_test"])
    # StepLR: two steps an epoch, halved every epoch, four steps taken
    assert res["optimizer"].param_groups[0]["lr"] == pytest.approx(
        5e-4 * 0.5 ** 2)
    log = [json.loads(line) for line in
           (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    assert all(math.isfinite(r[k]) for r in log
               for k in ("train_loss", "valid_mae", "test_mae"))
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() in (1, 2)
    state = ckpt.restore()
    fresh = TSphereNet(device="cpu", generator=torch.Generator().manual_seed(9),
                       **KW, **SLOT)
    fresh.load_state_dict(state["model"])
    _, eval_step = make_step_fns(fresh, torch.optim.Adam(fresh.parameters()),
                                 energy_and_force=True)
    valid = TLoader(_data(1, 4), 4, slot_size=A, device="cpu")
    mae = evaluate(eval_step, valid, ThreeDEvaluator())
    assert mae == pytest.approx(res["best_valid"], rel=1e-6)
    assert set(state["optimizer"]) == {"state", "param_groups"}


def test_run_is_run3d_with_debug_and_profile(tmp_path):
    """``run`` is ``Run3D``; ``debug`` (the in-place update check, then NaN
    checks) and ``profile_dir`` (a Chrome trace of the window) run one
    epoch, as the JAX package's ``tests/test_debug_profile.py:79``."""
    assert run is Run3D
    model = TSphereNet(device="cpu", **KW, **SLOT)
    res = Run3D().run(_data(0, 8), _data(1, 4), _data(2, 4), model,
                      ThreeDEvaluator(), epochs=1, batch_size=4,
                      vt_batch_size=2, slot_size=A, quiet=True,
                      device="cpu", debug=True,
                      profile_dir=str(tmp_path / "p"))
    assert np.isfinite(res["best_valid"])
    assert len(list((tmp_path / "p").glob("trace_*.json"))) == 1


def test_evaluate_matches_jax():
    mols = _data(3, 8)
    jl = JLoader(mols, 4, slot_size=A)
    jm = JSphereNet(**KW)
    opt = optax.adam(5e-4)
    state = make_train_state(jm, opt, next(iter(jl)), seed=4)
    _, eval_j = j_make_step_fns(jm, opt, energy_and_force=True, donate=False)
    want = j_evaluate(state, eval_j, jl, JEvaluator(), True)
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        state.params["params"], sep="/").items()}
    for flags in (None, SLOT):
        tm = spherenet_from_flax(flat, TSphereNet(device="cpu", **KW,
                                                  **(flags or {})))
        _, eval_t = make_step_fns(tm, torch.optim.Adam(tm.parameters()),
                                  energy_and_force=True)
        got = evaluate(eval_t, TLoader(mols, 4, slot_size=A, device="cpu"),
                       ThreeDEvaluator())
        assert got == pytest.approx(want, rel=1e-5)


def test_checkpointer_keeps_newest_and_partial_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save({"w": torch.full((2,), float(step))}, step=step,
                metrics={"valid_mae": 1.0 / step})
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert torch.equal(ck.restore()["w"], torch.full((2,), 3.0))
    assert torch.equal(ck.restore(2)["w"], torch.full((2,), 2.0))
    mine = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    out = partial_restore(mine, {"a": torch.ones(2), "b": torch.ones(4)})
    assert torch.equal(out["a"], torch.ones(2))
    assert torch.equal(out["b"], torch.zeros(3))       # shape differs
    assert torch.equal(out["c"], torch.zeros(1))       # absent
