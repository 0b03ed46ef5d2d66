"""Copies of a checkout's dig_tpu_torch package with one phase of a kernel
compiled out, for ``scripts/kernel_times.py --root``: the time a phase
takes is the time the kernel saves without it (the outputs are wrong).

    python scripts/phase_variants.py --root DIR --out DIR NAME [NAME ...]

Writes ``OUT/NAME/dig_tpu_torch`` for each NAME of ``VARIANTS`` (a source
under ``csrc/`` and text replacements, each of which must occur exactly
once in that checkout's source, else the script fails). The comment above
each group names the design whose source its edits match: the ``parent_``
variants a kernel's first design, the others its redesign.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

VARIANTS = {
    # cfconv_fwd_kernel, the first design (rows one at a time, FP32 pipes)
    "parent_cffwd_no_w1": ("cfconv.cu", [(
        "        gemm_w1<F>(rbfs, W1s, Rp, jq, fq, pre);\n", "")]),
    "parent_cffwd_no_w2": ("cfconv.cu", [(
        "        gemm_w2<F>(hs, W2s, jq, fq, w);\n", "")]),
    "parent_cffwd_no_sps": ("cfconv.cu", [(
        "rnd<BF16>(softplus(pre[b][c]) - LOG2F)", "rnd<BF16>(pre[b][c])")]),
    "parent_cffwd_no_basis": ("cfconv.cu", [(
        "            v = rnd<BF16>(expf(p.coeff * dd * dd));",
        "            v = rnd<BF16>(p.coeff * dd * dd);")]),
    "parent_cffwd_no_sum": ("cfconv.cu", [(
        "              acc[c] = fmaf(gt * w[b][c], vjs[j * F + fq + c * F4], acc[c]);",
        "              acc[c] += w[b][c];")]),
    "parent_cffwd_no_reds": ("cfconv.cu", [(
        "        for (int q = 0; q < JQ; ++q) s += reds[q * F + f];",
        "        s = reds[f];")]),
    "parent_cffwd_no_chunks": ("cfconv.cu", [(
        "      const int nv = *nvs;", "      const int nv = 0 * *nvs;")]),
    # slot_fwd_kernel, the first design (every s of 32 edges a block)
    "parent_slotfwd_no_basis": ("triplet_slot_core.cuh", [(
        "    Rows::template load<ROWS_VALUE>(p, s, e0, nullptr, cnt, ptc, m2c, ljc, nullptr, rs);\n"
        "    __syncthreads();\n    form_basis(p, ptc, bas);\n",
        "    Rows::template load<ROWS_VALUE>(p, s, e0, nullptr, cnt, ptc, m2c, ljc, nullptr, rs);\n"
        "    __syncthreads();\n")]),
    "parent_slotfwd_no_products": ("triplet_slot_core.cuh", [(
        "        basis_products<C>(bas + ec * p.NB, ws_s, wt_s, p.nk, p.ntk, c, sv, tv);\n",
        "        sv = bas[ec * p.NB + c % p.NB];\n        tv = 1.f;\n")]),
    "parent_slotfwd_no_gather": ("triplet_slot_core.cuh", [(
        "        const float xv = m * rnd<IS_BF16<T>>(ld(p.x + row * C + c));\n"
        "        acc[q] += (xv * sv) * tv;",
        "        const float xv = m + (float)row;\n"
        "        acc[q] += (xv * sv) * tv;")]),
    # the rows of either design of slot_fwd_kernel: the geometry's values
    # (ROWS_VALUE), the table's loads
    "slotfwd_no_geom_rows": ("triplet_slot_geom.cu", [(
        "        if constexpr (MODE == ROWS_VALUE) {\n"
        "          val = (float)geom_rows::row<double>(r, th, ph, xx);",
        "        if constexpr (MODE == ROWS_VALUE) {\n"
        "          val = (float)(th + ph + xx);")]),
    "slotfwd_no_pt_rows": ("triplet_slot_core.cuh", [(
        "        v = ld(p.pt + at);\n", "        v = (float)at;\n")]),
    # the redesigned slot_fwd_kernel (the compacted walk)
    "slotfwd_no_basis": ("triplet_slot_core.cuh", [(
        "    form_basis_by_row(p, fa, fb, ptc, bas);\n", "")]),
    "slotfwd_no_products": ("triplet_slot_core.cuh", [(
        "      tiled_sv_tv_by_row<C, EPT>(p, bas, ws_s, wt_s, c, q0, sv, tv);\n",
        "      for (int q = 0; q < EPT; ++q) {\n        sv[q] = bas[q0 + q];\n"
        "        tv[q] = 1.f;\n      }\n")]),
    "slotfwd_no_gather": ("triplet_slot_core.cuh", [(
        "          const float xv = m2c[ec] * rnd<IS_BF16<T>>(ld(p.x + row * C + c));",
        "          const float xv = m2c[ec] + (float)row;")]),
    "slotfwd_no_sums": ("triplet_slot_core.cuh", [(
        "    for (int ec = 0; ec < cnt; ++ec) {\n      const int b = loc[c0 + ec] % ET;",
        "    for (int ec = 0; ec < 0; ++ec) {\n      const int b = loc[c0 + ec] % ET;")]),
    # the redesigned cfconv_fwd_kernel (the pair-list walk); the basis
    # staging (in both special-function variants) and the run sums are the
    # backward's too
    "cffwd_no_filter": ("cfconv.cu", [
        ("        tiles<true, 1, 4, false, false>(y, rbf, LR, W1h, LW, 16 * wm, 32 * wn, KR, KR, F);\n",
         "        {}\n"),
        ("        tiles<true, 1, 4, false, false>(y, hs, LH, W2h, LW, 16 * wm, 32 * wn, F, F, F);\n",
         "        {}\n")]),
    "cffwd_no_special": ("cfconv.cu", [
        ("      v[u] = ok && r < p.R ? exp_<BF16>(p.coeff * dd * dd) : 0.f;",
         "      v[u] = ok && r < p.R ? p.coeff * dd * dd : 0.f;"),
        ("            h[u] = fmaxf(x, 0.f) + log1p_<BF16>(exp_<BF16>(-fabsf(x))) - LOG2F;",
         "            h[u] = x;")]),
    "cffwd_no_terms": ("cfconv.cu", [(
        "          st2(ts + row * LT + col, (gt * y[0][nt][v]) * vj2.x, (gt * y[0][nt][v + 1]) * vj2.y);",
        "          st2(ts + row * LT + col, y[0][nt][v], y[0][nt][v + 1]);")]),
    "cf_no_runs": ("cfconv.cu", [(  # both kernels' run sums
        "  for (int x = threadIdx.x; x < nruns * F; x += NT) {",
        "  for (int x = threadIdx.x; x < 0; x += NT) {")]),
    # the redesigned triplet_product_bwd2_kernel
    "prod_no_weights": ("triplet_product.cu", [(
        "        for (int i = 0; i < cnt; ++i) {\n"
        "          const float a = A_s[i * CP + c], gt = Gt_s[i * CP + c];",
        "        for (int i = 0; i < 0; ++i) {\n"
        "          const float a = A_s[i * CP + c], gt = Gt_s[i * CP + c];")]),
    "prod_no_tiles": ("triplet_product.cu", [(
        "        const int rt = has_u45 ? x / etl : x % rtl, et = has_u45 ? x % etl : x / rtl;\n"
        "        const bool sr = rt < rts;\n        const int r0 = sr ? rt * TR : S1",
        "        if (x >= 0) break;\n"
        "        const int rt = has_u45 ? x / etl : x % rtl, et = has_u45 ? x % etl : x / rtl;\n"
        "        const bool sr = rt < rts;\n        const int r0 = sr ? rt * TR : S1")]),
    # the redesigned cfconv_bwd_kernel
    "cf_no_weights": ("cfconv.cu", [(
        "      tiles<BF16, 1, 4, true, false>(dW1, rbf, LR, dp1s, LH, 16 * wm, 32 * wn, PT, PT, F);\n",
        ""), (
        "      tiles<BF16, MT2, NT2, true, false>(dW2, hs, LH, dp2s, LH, 16 * MT2 * wm2, "
        "8 * NT2 * wn2,\n                                         PT, PT, F);\n", "")]),
    "cf_no_special": ("cfconv.cu", [
        ("      v[u] = ok && r < p.R ? exp_<BF16>(p.coeff * dd * dd) : 0.f;",
         "      v[u] = ok && r < p.R ? p.coeff * dd * dd : 0.f;"),
        ("            const float e = exp_<BF16>(-fabsf(x));\n"
         "            h[u] = fmaxf(x, 0.f) + log1p_<BF16>(e) - LOG2F;\n"
         "            sig[nt][v + u] = BF16 ? __fdividef(x >= 0.f ? 1.f : e, 1.f + e)\n"
         "                                  : (x >= 0.f ? 1.f : e) / (1.f + e);",
         "            h[u] = x;\n            sig[nt][v + u] = x;")]),
    "cf_no_filter": ("cfconv.cu", [
        ("        tiles<true, 1, 4, false, false>(acc, rbf, LR, W1h, LW, 16 * wm, 32 * wn, KR, KR, F);\n",
         "        {}\n"),
        ("        tiles<true, 1, 4, false, false>(acc, hs, LH, W2h, LW, 16 * wm, 32 * wn, F, F, F);\n",
         "        {}\n")]),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("names", nargs="+")
    a = ap.parse_args()
    root, out = Path(a.root).resolve(), Path(a.out).resolve()
    for name in a.names:
        if name not in VARIANTS:
            sys.exit(f"unknown variant {name!r}; one of {sorted(VARIANTS)}")
        source, edits = VARIANTS[name]
        dst = out / name / "dig_tpu_torch"
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(root / "dig_tpu_torch", dst,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = dst / "csrc" / source
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"{name}: the text to replace occurs {text.count(old)}"
                         f" times in {root}/dig_tpu_torch/csrc/{source}")
            text = text.replace(old, new)
        path.write_text(text)
        print(f"{name}: {dst}")


if __name__ == "__main__":
    main()
