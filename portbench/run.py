"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``dig_tpu_torch``. Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``, the numbers compared
with the reference beside their limits, which also end standard error.
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or when JAX or the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dig_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import spec
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card and does not "
              "run on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from portbench.core import session
    device = torch.device("cuda", 0)
    rec = session.run(a.workload, a.seed, a.seconds, bool(a.trace), device,
                      T_START)
    metrics = {}
    for m in spec.metrics_of(a.workload, bool(a.trace)):
        value = spec.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": session.check.correct(rec.checks),
              "attempted": rec.window.steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = session.trace_mod.breakdown(rec.trace)
    result["check"] = rec.checks
    for name, c in rec.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
