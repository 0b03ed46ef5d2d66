"""Readings that set a cell's check limits, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... [--faults 1,2,3] [--out FILE]

For every seed of ``--seeds``: the program's first three steps held to
the reference (the lower readings). For every seed of ``--faults``, with
the same reference: the control, the reference in TF32 in the program's
place, the program itself with TF32 on in its matrix products (a second
control), and the fault "half of each batch left out, the mean taken over
the rest", planted in the reference in the program's place (the upper
readings). A step that leaves the state unchanged reads 1 by the check's
measure and needs no run. Prints one JSON line a reading; ``--out``
appends them to a file too. Not run by the benchmark's runs.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import check, session
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    faults = [int(s) for s in a.faults.split(",") if s]

    def emit(kind, seed, prog, ref, t):
        leaf = lambda key: sorted(abs(prog[key][k] - ref[key][k])
                                  / max(ref[key][k], 1e-30)
                                  for k in ref[key])
        row = {"workload": a.workload, "kind": kind, "seed": seed,
               **check.gaps(prog, ref), "seconds": time.perf_counter() - t,
               "step_loss_gaps": [abs(p - r) / abs(r) for p, r in
                                  zip(prog["losses"], ref["losses"])],
               "median_leaf_grad_gap": statistics.median(leaf("grad")),
               "median_leaf_change_gap": statistics.median(leaf("change")),
               "losses": prog["losses"], "ref_losses": ref["losses"]}
        line = json.dumps(row)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")

    for seed in sorted(set(seeds) | set(faults)):
        t = time.perf_counter()
        p = session.prepare(a.workload, seed, dev)
        program = session.first_steps(p)
        session.free(p)
        if seed in faults:
            t2 = time.perf_counter()
            q = session.prepare(a.workload, seed, dev)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            program_tf32 = session.first_steps(q)
            session.free(q)
            t2 = time.perf_counter() - t2
        ref = session.reference(p)
        if seed in seeds:
            emit("program", seed, program, ref, t)
        if seed in faults:
            emit("program_tf32", seed, program_tf32, ref,
                 time.perf_counter() - t2)
            t = time.perf_counter()
            emit("control_tf32", seed, session.reference(p, "tf32"), ref, t)
            t = time.perf_counter()
            emit("half_batch", seed, session.reference(p, half_batch=True),
                 ref, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
