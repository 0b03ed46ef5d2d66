"""Find everything a run needs by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists which metrics the cell reports.
Each name maps to files of its own:

* configuration ``<c>``: ``configs/<c>.json`` (its sizes),
  ``models/<c>.py`` (builds the port's model and step),
  ``reference/<c>.py`` (the plain reference), ``flops/<c>.py`` (the
  work a batch needs);
* traffic mix ``<t>``: ``traffic/<t>.json``;
* cell ``<c>.<t>``: ``limits/<c>.<t>.json`` (the limits of the check);
* metric ``<m>``: ``metrics/<m>.py``.

A later change adds a cell, a configuration or a metric by adding files
and entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json``; raises for an unknown
    name."""
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{cell_name}.json")


def module(kind: str, name: str):
    """``portbench.<kind>.<name>``: kind is models, reference, flops or
    metrics."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def metrics_of(cell_name: str, trace: bool) -> list:
    """The metrics the cell reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on. A metric without a
    ``workloads`` key belongs to every cell."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in benchmark()[key]
            if cell_name in m.get("workloads", [cell_name])]
