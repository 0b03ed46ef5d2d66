"""Where remat changes the bits of a bf16 force step on the card.

    python scripts/remat_bits.py

Takes path 3's force step (chip_smoke.py: SphereNet 4 x 128 on the slot
kernels, bf16, its 29-atom bucket) from the same seeded state with remat
off and on, each in a fresh process (chip_smoke.py --remat-step), under
three settings: as shipped; with every first-order backward computing the
rows' cotangent (``_grad_wanted`` always true, the earlier rule); and
with cuBLAS's reduced-precision bf16 reduction off. Prints, per setting,
whether the losses are the same bits, the launch counts of both steps
and which parameters' gradients differ. Needs one CUDA card; builds the
two kernel libraries the step uses.
"""
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = ("shipped", "rows_cotangent_always", "no_reduced_precision")


def one_step(setting, flag, out):
    """One step in this process under ``setting``, remat ``flag``."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    if setting == "rows_cotangent_always":
        from dig_tpu_torch.ops import triplet_slot as ts
        ts._grad_wanted = lambda ctx, i: bool(ctx.needs_input_grad[i])
    if setting == "no_reduced_precision":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    chip_smoke.remat_step(flag, "bf16", out)


def main():
    if sys.argv[1:2] == ["--step"]:
        one_step(*sys.argv[2:5])
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("remat_bits.py needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dig_tpu_torch.ops import _build
    chip_smoke.build_all(_build, {n: (n, None)
                                  for n in ("triplet_slot", "segment_csr")})
    with tempfile.TemporaryDirectory() as tmp:
        for setting in SETTINGS:
            runs = []
            for flag in ("0", "1"):
                out = os.path.join(tmp, f"{setting}_{flag}.pt")
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--step",
                     setting, flag, out], capture_output=True, text=True,
                    timeout=900)
                if res.returncode != 0:
                    sys.exit(f"{setting} remat {flag}: {res.stderr[-2000:]}")
                runs.append(torch.load(out))
            a, b = runs
            diff = [n for n in a["grad"]
                    if not torch.equal(a["grad"][n], b["grad"][n])]
            print(f"{setting}: loss the same bits "
                  f"{torch.equal(a['loss'], b['loss'])}; launches (slot "
                  f"forward, backward, backward with dpt, second order; "
                  f"segment sum) off {a['launches']}, on {b['launches']}; "
                  f"{len(diff)} of {len(a['grad'])} gradients differ: "
                  f"{diff}", flush=True)


if __name__ == "__main__":
    main()
