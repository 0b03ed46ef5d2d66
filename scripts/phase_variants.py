"""Copies of a checkout's dig_tpu_torch package with one phase of a kernel
compiled out, for ``scripts/kernel_times.py --root``: the time a phase
takes is the time the kernel saves without it (the outputs are wrong).

    python scripts/phase_variants.py --root DIR --out DIR NAME [NAME ...]

Writes ``OUT/NAME/dig_tpu_torch`` for each NAME of ``VARIANTS`` (a source
under ``csrc/`` and text replacements, each of which must occur exactly
once in that checkout's source, else the script fails). The ``parent_``
variants apply to the first designs of the triplet_product second order
and of the cfconv backward, the others to their redesigns.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

VARIANTS = {
    # triplet_product_bwd2_kernel, the first design (a warp per triplet)
    "parent_prod_no_weights": ("triplet_product.cu", [(
        "      for (int tl = 0; tl < cnt; ++tl) {\n        if (m_s[tl] != 0.f) {",
        "      for (int tl = 0; tl < 0; ++tl) {\n        if (m_s[tl] != 0.f) {")]),
    "parent_prod_no_tiles": ("triplet_product.cu", [(
        "      for (int r = lane; r < NB; r += 32) {\n        if (r < S1) {\n"
        "          float v = row_dot(",
        "      for (int r = lane; r < 0; r += 32) {\n        if (r < S1) {\n"
        "          float v = row_dot(")]),
    "parent_prod_no_ctb": ("triplet_product.cu", [(
        "      for (int k = 0; k < K; ++k) {\n        const int tl = ce * K + k;",
        "      for (int k = 0; k < 0; ++k) {\n        const int tl = ce * K + k;")]),
    # cfconv_bwd_kernel, the first design (rows one at a time, FP32 pipes)
    "parent_cf_no_weights": ("cfconv.cu", [(
        "        for (int jj = 0; jj < cnt; ++jj) {\n          float p2[4], p1[4];",
        "        for (int jj = 0; jj < 0; ++jj) {\n          float p2[4], p1[4];")]),
    "parent_cf_no_dh": ("cfconv.cu", [(
        "        gemm_w2t<F>(dp2s, W2s, jq, fq, dh);\n", "")]),
    "parent_cf_no_filter": ("cfconv.cu", [
        ("        gemm_w1<F, DIST>(rbfs, cs, W1s, Rp, jq, fq, pre, q);\n", ""),
        ("        __syncthreads();\n        gemm_w2<F>(hs, W2s, jq, fq, w);\n"
         "        // d_vj", "        __syncthreads();\n        // d_vj")]),
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
    "cf_no_runs": ("cfconv.cu", [(
        "      for (int x = tid; x < nruns * F; x += NT) {",
        "      for (int x = tid; x < 0; x += NT) {")]),
    "cf_no_special": ("cfconv.cu", [
        ("            v[u] = ok && r < R ? exp_<BF16>(p.coeff * dd * dd) : 0.f;",
         "            v[u] = ok && r < R ? p.coeff * dd * dd : 0.f;"),
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
