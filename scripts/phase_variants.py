"""Copies of a checkout's dig_tpu_torch package with one phase of a kernel
compiled out, for ``scripts/kernel_times.py --root``: the time a phase
takes is the time the kernel saves without it (the outputs are wrong).
A few copies instead revert one design choice (their outputs are right),
to time the choice.

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
    # the redesigned segment sum: the row pass launched as a plain kernel,
    # not as a programmatic dependent of the piece pass
    "segcsr_no_pdl": ("segment_csr.cu", [(
        "  cfg.numAttrs = pieces ? 1 : 0;\n", "  cfg.numAttrs = 0;\n")]),
    # the redesigned segment sum with a barrier that keeps a batch's loads
    # of the row walk above its adds, as the pieces' sum has
    "segcsr_fence": ("segment_csr.cu", [(
        "#pragma unroll\n      for (int u = 0; u < U_WIDE; ++u) {\n        const bool take",
        "      __syncwarp();\n#pragma unroll\n      for (int u = 0; u < U_WIDE; ++u) {\n"
        "        const bool take")]),
    # the redesigned segment sum with 32 edges in flight a lane, not 16
    "segcsr_u32": ("segment_csr.cu", [(
        "constexpr int U_WIDE = 16;", "constexpr int U_WIDE = 32;")]),
    # the redesigned segment sum with 8 rows a row-pass block, not 4
    "segcsr_rows8": ("segment_csr.cu", [(
        "constexpr int ROW_WARPS = 4;", "constexpr int ROW_WARPS = 8;")]),
    # the redesigned segment sum with slices of 256 edges, not 128
    "segcsr_slice256": ("segment_csr.cu", [(
        "constexpr int SLICE = 128;", "constexpr int SLICE = 256;")]),
    # the rows of slot_fwd_kernel: the geometry's values (ROWS_VALUE), the
    # table's loads
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
    # triplet_pt_fwd_kernel, the first design (every triplet of 8-edge
    # chunks staged, a warp per edge)
    "parent_ptfwd_no_slab": ("triplet_pt.cu", [(
        "    load_slab(p, p.pt, t0, cnt, TC, ptc);\n", "")]),
    "parent_ptfwd_no_basis": ("triplet_pt.cu", [(
        "    form_basis(p, ptc, TC, bas);\n", "")]),
    "parent_ptfwd_no_products": ("triplet_pt.cu", [(
        "        row_products<Q, HAS_T>(bas + tl * NB, w_s, p.nk, NB, C, lane, sv, tv);\n",
        "        for (int q = 0; q < Q; ++q) {\n          sv[q] = bas[tl * NB + q];\n"
        "          tv[q] = 1.f;\n        }\n")]),
    "parent_ptfwd_no_xg": ("triplet_pt.cu", [(
        "            float prod = ld(p.xg + t * C + c) * sv[q];",
        "            float prod = (float)t * sv[q];")]),
    "parent_ptfwd_no_stores": ("triplet_pt.cu", [(
        "        if (c < C) st(p.out + (size_t)e * C + c, acc[q]);",
        "        if (c < C && acc[q] == 1.2345f) st(p.out + (size_t)e * C + c, acc[q]);")]),
    # triplet_product_fwd_kernel, the first design (a warp per edge, k
    # walked in order); no_mask puts a fixed 40% pattern in the mask's place
    "parent_prodfwd_no_mask": ("triplet_product.cu", [(
        "      const float m = ld(p.mask + t);",
        "      const float m = (float)((e * 7 + k) % 5 < 2);")]),
    "parent_prodfwd_no_rows": ("triplet_product.cu", [(
        "      load_row(p, p.sbf, p.tbf, t, bas, lane);\n", "")]),
    "parent_prodfwd_no_products": ("triplet_product.cu", [(
        "      row_products<Q, HAS_T>(bas, w_s, p.S1, NB, C, lane, sv, tv);\n",
        "      for (int q = 0; q < Q; ++q) {\n        sv[q] = bas[q];\n"
        "        tv[q] = 1.f;\n      }\n")]),
    "parent_prodfwd_no_xg": ("triplet_product.cu", [(
        "          float prod = ld(p.xg + t * C + c) * sv[q];",
        "          float prod = (float)t * sv[q];")]),
    "parent_prodfwd_no_stores": ("triplet_product.cu", [(
        "      if (c < C) st(p.out + (size_t)e * C + c, acc[q]);",
        "      if (c < C && acc[q] == 1.2345f) st(p.out + (size_t)e * C + c, acc[q]);")]),
    # the redesigned forwards (the compacted walk): only_listing keeps the
    # listing and the zero rows of edges without a real triplet
    "ptfwd_no_gather": ("triplet_pt.cu", [(
        "          v[u] = ldw(p.pt + (size_t)r * p.Tn + ids[min(i, cnt - 1)]);",
        "          v[u] = (float)ids[min(i, cnt - 1)];")]),
    "ptfwd_no_xg": ("triplet_pt.cu", [(
        "          for (int q = 0; q < Q; ++q) v[e][q] = ldw(p.xg + row + min(lane + 32 * q, C - 1));",
        "          for (int q = 0; q < Q; ++q) v[e][q] = (float)row;")]),
    "ptfwd_no_basis": ("triplet_pt.cu", [(
        "      for (int x = tid; x < NB * FB; x += NT) {\n"
        "        const int r = x / FB, i = x % FB;\n        bas[x] = rnd",
        "      for (int x = tid; x < 0; x += NT) {\n"
        "        const int r = x / FB, i = x % FB;\n        bas[x] = rnd")]),
    "ptfwd_no_products": ("triplet_pt.cu", [(
        "        row_tile(bas, FB, w_s, 0, nk, i0, lane, C, sv);\n"
        "        if constexpr (HAS_T) row_tile(bas, FB, w_s, nk, NB, i0, lane, C, tv);\n",
        "")]),
    "ptfwd_no_sums": ("triplet_pt.cu", [(
        "      add_edge_runs<NT, Q>(xs, m_s, eds, rs, rs[FB + 1],",
        "      add_edge_runs<NT, Q>(xs, m_s, eds, rs, 0,")]),
    "ptfwd_only_listing": ("triplet_pt.cu", [(
        "    const int nl = list_window<NT>(win, p.m, lst, wcnt, bits, [](size_t) {});",
        "    const int nl = 0 * list_window<NT>(win, p.m, lst, wcnt, bits, [](size_t) {});")]),
    "prodfwd_no_rows": ("triplet_product.cu", [(
        "            v[e] = ldw(r < S1 ? p.sbf + t[e] * S1 + r : p.tbf + t[e] * S2 + (r - S1));",
        "            v[e] = (float)t[e];")]),
    "prodfwd_no_xg": ("triplet_product.cu", [(
        "          for (int q = 0; q < Q; ++q) xv[e][q] = ldw(p.xg + t[e] * C + min(lane + 32 * q, C - 1));",
        "          for (int q = 0; q < Q; ++q) xv[e][q] = (float)t[e];")]),
    "prodfwd_no_products": ("triplet_product.cu", [(
        "        row_tile(bas, FBP, w_s, 0, S1, i0, lane, C, sv);\n"
        "        if constexpr (HAS_T) row_tile(bas, FBP, w_s, S1, NB, i0, lane, C, tv);\n",
        "")]),
    "prodfwd_no_sums": ("triplet_product.cu", [(
        "      add_edge_runs<NT, Q>(xs, m_s, eds, rs, rs[FB + 1],",
        "      add_edge_runs<NT, Q>(xs, m_s, eds, rs, 0,")]),
    "prodfwd_only_listing": ("triplet_product.cu", [(
        "    const int nl = list_window<NT>(win, p.mask, lst, wcnt, bits, [](size_t) {});\n"
        "    zero_empty_edges",
        "    const int nl = 0 * list_window<NT>(win, p.mask, lst, wcnt, bits, [](size_t) {});\n"
        "    zero_empty_edges")]),
    # the redesigned forwards with one design choice reverted: two blocks
    # an SM in place of three
    "ptfwd_two_blocks": ("triplet_pt.cu", [(
        "__launch_bounds__(NT, Q == 2 ? 3 : 2) triplet_pt_fwd_kernel",
        "__launch_bounds__(NT, 2) triplet_pt_fwd_kernel")]),
    "prodfwd_two_blocks": ("triplet_product.cu", [(
        "__launch_bounds__(NT, Q == 2 ? 3 : 2) triplet_product_fwd_kernel",
        "__launch_bounds__(NT, 2) triplet_product_fwd_kernel")]),
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
