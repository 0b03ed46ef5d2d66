"""The comparison that decides ``correct``.

The program's first three train steps (taken in set-up, through the
window's own step and pool) are held to the plain reference's three
steps from the same weights on the same molecules. Three numbers:

* ``loss_gap``: the largest |L_program - L_reference| / |L_reference|
  over the three steps, or over the first ``loss_steps`` of them where
  the cell's limits say so (a cell whose later steps amplify rounding
  past any limit that would hold);
* ``grad_gap``: the first step's gradient as Adam holds it after one step
  (exp_avg / (1 - beta1)); per leaf the gap between the program's norm and
  the reference's, over the larger of the reference's norm of that leaf
  and of the median leaf; the worst leaf;
* ``change_gap``: the same of each leaf's change after the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (Adam moves them by round-off alone).

Each must lie at or under its limit (``limits/<cell>.json``).
"""
from __future__ import annotations

import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def gaps(prog: dict, ref: dict, loss_steps: int = 3) -> dict:
    """``prog`` and ``ref``: ``{"losses": [3], "grad": {leaf: norm},
    "change": {leaf: norm}}``."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in list(zip(prog["losses"],
                                    ref["losses"]))[:loss_steps])
    keys = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in keys)
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], keys),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def judge(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of the compared numbers (a limit
    file's other keys, as ``loss_steps``, are not numbers compared)."""
    return {n: {"value": values[n], "limit": limits[n]} for n in NAMES}


def correct(checks: dict) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"]
               for c in checks.values())
