"""Nothing the benchmark runs loads JAX or the JAX package: no file of
portbench/ imports them (top-level names compared whole), the reference
imports nothing of the port, and after a tiny run no such module is
loaded."""
import ast
import json
import subprocess
import sys

import pytest

from portbench.core.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dig_tpu"}
FILES = sorted(BENCH_DIR.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH_DIR)))
def test_no_forbidden_import(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if path.parent.name == "reference":
        assert "dig_tpu_torch" not in names
        assert names <= {"__future__", "math", "functools", "numpy",
                         "torch", "typing"}


def test_no_forbidden_module_after_a_run():
    code = (
        "import sys, time, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.core import session, spec\n"
        "from portbench.tests._tiny import shrink\n"
        "spec.traffic = lambda n, read=spec.traffic: shrink(read(n))\n"
        "session.run('spherenet_qm9.energy_b384', 1, 0.1, False,\n"
        "            torch.device('cpu'), time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.splitlines()[-1]))
    assert "dig_tpu_torch" in loaded and not loaded & FORBIDDEN
