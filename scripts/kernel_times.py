"""Time the triplet kernels, the cfconv kernels and the chunked CSR sum
on one card, per call and per kernel, at
chip_smoke.py's shapes, and hash their outputs.

    python scripts/kernel_times.py [--root DIR] [--out FILE] [--ops A,B]

``--root`` names the checkout whose ``dig_tpu_torch`` is timed (default:
this one), so that two versions of the kernels can be timed in turns in
one call, on one card, on the same inputs: chip_smoke.py's own (path 7a's
batch and seeded operands, the force bench's three bucket batches, the
unblocked NK batch of paths 5a-6b, path 7b's graph, SchNetDense's three
bucket batches), made by this checkout's chip_smoke.py. The root's
libraries of the kept ops are built first, one nvcc each, all at once.

What it times, with CUDA events over repeated bare launches (bf16 and f32):
the geometry forward, backward (dgeo asked for and not) and second order
at path 7a's shape (u1 = u4 = u5 absent, as in force training); the
triplet_slot forward, backward (dpt asked for and not) and second order at
the three bucket shapes of the force bench (``slot_fwd_A16``, ...) and its
forward at path 2's shape (``slot_fwd_p2``); the triplet_pt forward
(``pt_fwd_6a``, ``pt_fwd_6b``), backward (dpt asked for and not) and
second order (the cotangents a force step passes, u1 and u2, and all
four) at paths 6a's and 6b's shapes; the triplet_product forward at
paths 5a's and 5b's shapes (``prod_fwd_5a``, ``prod_fwd_5b``), its
backward at path 5a's shape with and without basis cotangents and at
5b's without, and its second order at 5a's (``prod_bwd2_5a``: u1, u2,
u3, as the force step passes them); the cfconv forward and backward at
each of SchNetDense's buckets (``cfconv_fwd_n16``, ``cfconv_bwd_n16`` and, with
need_dist_grad, ``cfconv_bwd_n16_dist``; n = 16, 24, 32), vj in bf16 as
the model passes it; the chunked sum at path 7b's shape beside
the segment sum (``csr``) and torch.segment_reduce; the segment sum at
every shape of chip_smoke.py's phase 12 (``csr_<case>``: the flat paths'
edge->node sums, the main paths' gather adjoints and readouts, the skewed
CSR at F = 24 and 128), timed with the host ahead (chip_smoke.device_ms:
one call takes a few microseconds, less than the host takes to issue it).
Each backward, second order, the chunked sum, the segment sum and the two
triplet forwards is also split into its kernels by chip_smoke.kernel_split
(torch.profiler's device events).
``--ops`` keeps the ops whose names start with one of the given prefixes
(default: all), e.g. ``--ops pt_fwd,prod_fwd,pt_bwd,prod_bwd``, and only
their libraries are built. ``scripts/phase_variants.py`` makes roots with
one phase of a kernel compiled out.

Before the times, one object per kernel call with a hash of each output's
bytes (the second orders also with every cotangent present), so that two
checkouts' outputs can be compared bit for bit without moving them off the
card; a segment sum's also with a hash of its short rows alone (those whose
row-pointer range holds at most SHORT_EDGES edges, summed whole in edge
order by every design). Prints one JSON object per hash or timing, and
appends them all to ``--out``.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
# rows of at most this many edges (csrc/segment_csr.cu's least slice) are
# summed whole in edge order by every design of the segment sum
SHORT_EDGES = 128
SPLIT = ("slot_fwd_kernel", "slot_jvp_kernel", "slot_bwd2_kernel",
         "slot_bwd_kernel", "cfconv_fwd_kernel", "triplet_pt_fwd_kernel",
         "triplet_product_fwd_kernel",
         "triplet_pt_bwd_kernel", "triplet_pt_bwd2_kernel",
         "triplet_product_bwd_kernel", "triplet_product_bwd2_kernel",
         "cfconv_bwd_kernel", "sum_partials_kernel",
         "segment_csr_span_kernel", "segment_csr_piece_kernel",
         "segment_csr_row_kernel", "segment_csr_kernel", "Memset")


def load_smoke():
    """This checkout's chip_smoke.py as a module (it makes the inputs)."""
    spec = importlib.util.spec_from_file_location("smoke_inputs",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t):
    """A hash of a tensor's bytes (any dtype, bf16 too)."""
    return None if t is None else hashlib.sha256(
        t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    ).hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default="")
    ap.add_argument("--ops", default="")
    a = ap.parse_args()
    prefixes = [o for o in a.ops.split(",") if o]

    def want(op):
        return not prefixes or any(op.startswith(o) for o in prefixes)

    def group(name):
        """Whether an op whose name starts with ``name`` may be kept."""
        return not prefixes or any(o.startswith(name) or name.startswith(o)
                                   for o in prefixes)
    root = Path(a.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from dig_tpu_torch.ops import _build
    from dig_tpu_torch.ops import cfconv as cf
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.ops import triplet_product as tp
    from dig_tpu_torch.ops import triplet_pt as tpt
    from dig_tpu_torch.ops import triplet_slot as ts
    smoke = load_smoke()
    cfg = (smoke.SN_KW["num_spherical"], smoke.SN_KW["num_radial"], True)
    # the libraries of the kept ops, by the ops' name prefixes
    libs = {"geom": ("triplet_slot_geom", ts.geom_library_spec(cfg)),
            "slot_bwd": ("triplet_slot", None),
            "slot_fwd": ("triplet_slot", None), "pt_bwd": ("triplet_pt", None),
            "pt_fwd": ("triplet_pt", None),
            "prod_bwd": ("triplet_product", None),
            "prod_fwd": ("triplet_product", None),
            "chunked": ("segment_csr", None), "csr": ("segment_csr", None),
            "cfconv": ("cfconv", None)}
    smoke.build_all(_build, {spec[0]: spec for name, spec in libs.items()
                             if group(name)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    A, K = smoke.SN_KW["block_size"], smoke.SN_KW["nk_degree"]
    results = []

    def emit(**row):
        row.update(card=card, root=str(root))
        results.append(row)
        print(json.dumps(row), flush=True)

    # (op, precision) -> a kernel call; hashed besides, with the outputs of
    # ``extra`` (the second orders with every cotangent present)
    ops, extra = {}, {}
    if group("geom"):
        batch = smoke.ga_batches(torch, dev, smoke.GA_STEPS)[-1]
        inp = smoke.ga_kernel_inputs(torch, dev, batch)
    for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        if not group("geom"):
            break
        args, gcfg = smoke.ga_args(torch, inp, True, dt)
        k_args = ts._geom_kernel_inputs(*args, A, K, gcfg)
        ct32 = inp["ct"].to(dt).float().contiguous()
        ug = inp["ug"]
        ops[("geom_fwd", prec)] = (
            lambda k_args=k_args, g=gcfg:
            ts.triplet_slot_geom_forward_kernel(*k_args, A, K, g))
        ops[("geom_bwd", prec)] = (
            lambda k_args=k_args, ct32=ct32, g=gcfg:
            ts.triplet_slot_geom_backward_kernel(*k_args, ct32, A, K, g,
                                                 True))
        ops[("geom_bwd_nodgeo", prec)] = (
            lambda k_args=k_args, ct32=ct32, g=gcfg:
            ts.triplet_slot_geom_backward_kernel(*k_args, ct32, A, K, g,
                                                 False))
        ops[("geom_bwd2", prec)] = (
            lambda k_args=k_args, ct32=ct32, g=gcfg:
            ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, None, ug, None,
                                             None, A, K, g))
        extra[("geom_bwd2_all_u", prec)] = (
            lambda k_args=k_args, ct32=ct32, g=gcfg, dt=dt:
            ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, inp["u1"].to(dt),
                                             ug, inp["u4"], inp["u5"], A, K,
                                             g))
    if group("slot_fwd_p2"):
        # path 2's batch: the energy step's forward
        sinp = smoke.sn_kernel_inputs(
            torch, dev, smoke.sn_batches(torch, dev, smoke.SN_STEPS + 1)[-1])
    for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        if not group("slot_fwd_p2"):
            break
        args, scfg = smoke.sn_args(torch, sinp, True, dt)
        ops[("slot_fwd_p2", prec)] = (
            lambda k_args=ts._kernel_inputs(*args, A, K, scfg), g=scfg:
            ts.triplet_slot_forward_kernel(*k_args, A, K, g))
    batch = smoke.sf_batches(torch, dev, smoke.SF_STEPS + 1)[-1] \
        if group("slot_bwd") or group("slot_fwd_A") else {}
    for Ab, b in batch.items():
        binp = smoke.sn_kernel_inputs(torch, dev, b, Ab)
        for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            args, ct, us, scfg = smoke.bwd2_args(torch, binp, True, dt, False)
            k_args = ts._kernel_inputs(*args, Ab, K, scfg)
            ct32 = ct.float().contiguous()
            ops[(f"slot_fwd_A{Ab}", prec)] = (
                lambda k_args=k_args, Ab=Ab, g=scfg:
                ts.triplet_slot_forward_kernel(*k_args, Ab, K, g))
            for dpt in (True, False):
                ops[(f"slot_bwd_A{Ab}{'_dpt' if dpt else ''}", prec)] = (
                    lambda k_args=k_args, ct32=ct32, Ab=Ab, g=scfg, dpt=dpt:
                    ts.triplet_slot_backward_kernel(*k_args, ct32, Ab, K, g,
                                                    dpt))
            ops[(f"slot_bwd2_A{Ab}", prec)] = (
                lambda k_args=k_args, ct32=ct32, us=us, Ab=Ab, g=scfg:
                ts.triplet_slot_bwd2_kernel(*k_args, ct32, *us, Ab, K, g))
            _, _, us_all, _ = smoke.bwd2_args(torch, binp, True, dt, True)
            extra[(f"slot_bwd2_A{Ab}_all_u", prec)] = (
                lambda k_args=k_args, ct32=ct32, us=us_all, Ab=Ab, g=scfg:
                ts.triplet_slot_bwd2_kernel(*k_args, ct32, *us, Ab, K, g))
    nk_b = smoke.nk_batches(torch, dev, smoke.NK_STEPS + 1)[-1] \
        if group("pt_") or group("prod_") else None
    for path in smoke.PT_PATHS:
        if not any(group(f"pt_{g}_{path}") for g in ("fwd", "bwd", "bwd2")):
            continue
        pinp = smoke.pt_kernel_inputs(torch, dev, nk_b, path)
        Kp, pcfg = pinp["K"], pinp["cfg"]
        for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            k_args = tpt._kernel_inputs(*smoke.pt_args(torch, pinp, dt), Kp,
                                        pcfg)
            ct32 = pinp["ct"].to(dt).float().contiguous()
            ops[(f"pt_fwd_{path}", prec)] = (
                lambda k_args=k_args, Kp=Kp, g=pcfg:
                tpt.triplet_pt_forward_kernel(*k_args, Kp, g))
            for dpt in (True, False):
                ops[(f"pt_bwd_{path}{'_dpt' if dpt else ''}", prec)] = (
                    lambda k_args=k_args, ct32=ct32, Kp=Kp, g=pcfg, dpt=dpt:
                    tpt.triplet_pt_backward_kernel(*k_args, ct32, Kp, g, dpt))
            # u1 and u2 as a force step passes them; then all four
            u12 = [u.to(dt) for u in pinp["us"][:2]]
            for name, us in ((f"pt_bwd2_{path}", u12 + [None, None]),
                             (f"pt_bwd2_{path}_all_u", u12 + pinp["us"][2:])):
                ops[(name, prec)] = (
                    lambda k_args=k_args, ct32=ct32, us=us, Kp=Kp, g=pcfg:
                    tpt.triplet_pt_bwd2_kernel(*k_args, ct32, *us, Kp, g))
    for path in ("5a", "5b"):
        if not group(f"prod_bwd_{path}") and not group(f"prod_fwd_{path}") \
                and not (path == "5a" and group("prod_bwd2_5a")):
            continue
        ninp = smoke.nk_kernel_inputs(torch, dev, nk_b, path)
        Kn = ninp["K"]
        for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            k_args = tp._kernel_inputs(*smoke.nk_args(torch, ninp, dt), Kn)
            ct32 = ninp["ct"].to(dt).float().contiguous()
            ops[(f"prod_fwd_{path}", prec)] = (
                lambda k_args=k_args, Kn=Kn:
                tp.triplet_product_forward_kernel(*k_args, Kn))
            # 5a's force step asks for the basis cotangents in its inner
            # pass only; 5b's energy step never
            for basis in ((False, True) if path == "5a" else (False,)):
                ops[(f"prod_bwd_{path}{'_basis' if basis else ''}", prec)] = (
                    lambda k_args=k_args, ct32=ct32, Kn=Kn, basis=basis:
                    tp.triplet_product_backward_kernel(*k_args, ct32, Kn,
                                                       basis))
            if path != "5a":
                continue
            # the second order with the force step's u1, u2, u3; hashed
            # besides with all five
            u123 = [None if u is None else u.to(dt) for u in ninp["us"][:3]]
            ops[("prod_bwd2_5a", prec)] = (
                lambda k_args=k_args, ct32=ct32, us=u123 + [None, None],
                Kn=Kn: tp.triplet_product_bwd2_kernel(*k_args, ct32, *us, Kn))
            extra[("prod_bwd2_5a_all_u", prec)] = (
                lambda k_args=k_args, ct32=ct32, us=u123 + ninp["us"][3:],
                Kn=Kn: tp.triplet_product_bwd2_kernel(*k_args, ct32, *us, Kn))
    if group("cfconv"):
        # SchNetDense's three bucket calls of one layer, vj in bf16 as the
        # model passes it
        cf_inp = smoke.bucket_inputs(
            torch, smoke.cf_batches(torch, dev, smoke.STEPS + 1)[-1], dev)
    for n, (args, g_out, _) in (cf_inp.items() if group("cfconv") else ()):
        main_args = [args[0], args[1].to(torch.bfloat16)] + args[2:]
        k_args = cf._kernel_inputs(*main_args)
        g32 = g_out.float().contiguous()
        for prec in ("bf16", "f32"):
            ops[(f"cfconv_fwd_n{n}", prec)] = (
                lambda k_args=k_args, prec=prec: cf.cfconv_forward_kernel(
                    *k_args, smoke.CUTOFF, smoke.GAUSSIANS, prec))
            for dist in (False, True):
                ops[(f"cfconv_bwd_n{n}{'_dist' if dist else ''}", prec)] = (
                    lambda k_args=k_args, g32=g32, prec=prec, dist=dist:
                    cf.cfconv_backward_kernel(*k_args, g32, smoke.CUTOFF,
                                              smoke.GAUSSIANS, prec, dist))
    g = smoke.cs_graph(torch, dev) if group("chunked") or want("csr") \
        else None
    library = {}
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if g is None:
            break
        data, seg, rp, N = g["data"].to(dt), g["seg"], g["rowptr"], g["N"]
        BN, EB, meta_np, _ = sc.choose_chunk_plan(g["rowptr_np"], N,
                                                  data.shape[1], dt)
        meta = torch.from_numpy(meta_np).to(dev)
        ops[("chunked", prec)] = (
            lambda data=data, seg=seg, meta=meta, N=N, BN=BN, EB=EB:
            sc.segment_csr_chunked_launch(data, seg, meta, N, BN, EB))
        ops[("csr", prec)] = (lambda data=data, seg=seg, rp=rp, N=N:
                              sc.segment_csr_launch(data, seg, rp, N))
        library[("segment_reduce", prec)] = (
            lambda data=data, rp=rp: torch.segment_reduce(
                data, "sum", offsets=rp.long(), axis=0))

    # the segment sum at phase 12's shapes; short: its short rows
    short = {}
    if group("csr_"):
        cases = smoke.seg_cases(
            torch, dev, smoke.fs_batches(torch, dev, smoke.FS_STEPS + 1)[-1],
            smoke.sp_batches(torch, dev, smoke.SP_STEPS + 1)[-1])
    for c in cases if group("csr_") else ():
        data, seg, rp, N = c["data"], c["seg"], c["rowptr"], c["N"]
        op = f"csr_{c['name']}" + (f"_F{data.shape[1]}"
                                   if c["name"] == "skewed" else "")
        prec = {torch.float32: "f32", torch.bfloat16: "bf16"}[data.dtype]
        ops[(op, prec)] = (lambda data=data, seg=seg, rp=rp, N=N:
                           sc.segment_csr_launch(data, seg, rp, N))
        span = rp[1:].clamp(max=seg.shape[0]) - rp[:-1].clamp(min=0)
        short[(op, prec)] = span <= SHORT_EDGES

    ops = {key: fn for key, fn in ops.items() if want(key[0])}
    extra = {key: fn for key, fn in extra.items() if want(key[0])}
    library = {key: fn for key, fn in library.items() if want("chunked")}
    for (op, prec), fn in list(ops.items()) + list(extra.items()):
        outs = fn()
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        hashes = [digest(t) for t in outs]
        if (op, prec) in short:
            hashes.append(digest(outs[0][short[(op, prec)]]))
        emit(op=op, precision=prec, hashes=hashes)
    for (op, prec), fn in list(ops.items()) + list(library.items()):
        if op.startswith("csr_"):
            ms = smoke.device_ms(torch, fn)
        else:
            ms = smoke.cuda_ms(torch, fn, iters=50 if op in (
                "chunked", "csr", "segment_reduce") else 20)
        split = smoke.kernel_split(torch, fn, SPLIT) if "bwd" in op or \
            op in ("chunked", "csr") or op.startswith(
                ("pt_fwd", "prod_fwd", "csr_")) else {}
        emit(op=op, precision=prec, ms=ms,
             kernels={k: v for k, v in split.items() if v > 0})
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
