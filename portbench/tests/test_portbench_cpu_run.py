"""Without a card the benchmark fails and prints no result: it never
falls back to the CPU. In a directory that holds only BENCHMARK.json and
the benchmark's files it fails too."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench.core.spec import BENCH_DIR, ROOT


def _run(root, *extra):
    return subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), "--workload",
         "spherenet_qm9.energy_b384", "--seed", "2147483659", "--seconds",
         "1", "--trace", "0", *extra], cwd=root, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                     "CUDA_VISIBLE_DEVICES": "",
                                     "HOME": str(root)})


def _no_result(res):
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_cpu_run_refuses():
    res = _run(ROOT)
    _no_result(res)
    assert "no CUDA card" in res.stderr


def test_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
