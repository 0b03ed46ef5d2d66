"""run.py finds every configuration, traffic mix, limit and metric of
BENCHMARK.json by name from its files, and BENCHMARK.json keeps to the
contract's shape."""
import json
import re

import pytest

from portbench.core import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = spec.cell(cell)
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cfg = spec.config(w["config"])
    t = spec.traffic(w["traffic"])
    assert set(spec.limits(cell)) >= {"loss_gap", "grad_gap", "change_gap"}
    for kind in ("models", "reference", "flops"):
        assert spec.module(kind, w["config"]) is not None
    assert len(t["slots"]) == len(t["molecules"]["batch"])
    assert cfg["precision"] == "float32" and cfg["tf32"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_cell_metrics(cell):
    e2e = [m["name"] for m in spec.metrics_of(cell, False)]
    layer = spec.metrics_of(cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.module("metrics", metric["name"]).read)
    for c in metric.get("workloads", []):
        assert c in CELLS
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_configs():
    names = {c["name"] for c in BENCH["configs"]}
    assert names == {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert spec.config(c["name"])["reduced"] == c["reduced"]
