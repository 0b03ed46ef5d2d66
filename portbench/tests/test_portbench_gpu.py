"""One short window of each cell on the card, through run.py as the
benchmark runs it: exit 0, a correct result with the cell's end-to-end
metrics. Skips without a card (decided inside the test).

    python -m pytest -m gpu portbench/tests/test_portbench_gpu.py
"""
import json
import subprocess
import sys

import pytest

from portbench.core import spec
from portbench.core.spec import ROOT

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_window(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483701", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.metrics_of(cell, False)}
    assert out["device"]["platform"] == "gpu"
