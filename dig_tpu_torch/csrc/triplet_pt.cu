// Fused triplet interaction over the packed transposed basis table (SphereNet
// and, without torsion, DimeNet++, with pallas_fuse_basis on the [N, K]
// table): forward, backward and second-order backward, for NVIDIA Hopper
// (sm_90a). Plain C interface, loaded through ctypes by
// dig_tpu_torch/ops/triplet_pt.py.
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_triplet_pt.py:
// _run_fwd (pl.pallas_call at :236, _fwd_kernel), _run_bwd (:263,
// _bwd_kernel) and _run_bwd2 (:294, _bwd2_kernel).
//
//   out[e] = sum_k m[t] * xg[t] * sv[t] * tv[t],  t = e*K + k
//   sv = a[t] @ ws,  a[l*k+m]       = bt[l*k+m] * y0[l]          (sbf)
//   tv = b[t] @ wt,  b[(p*n+q)*k+c] = yt[p*n+q] * bt[q*k+c]       (tbf, has_t)
//   bt, y0, yt = rows [0,nk), [nk,nk+n), [nk+n,R) of pt[:, t]; nk = n*k,
//   ntk = n*n*k, R = nk + n (+ n*n with has_t); tv = 1 without torsion.
//
// xg [T, C], pt [R, T] and m [E, K] share one type (float32 or bf16); ws
// [nk, C] and wt [ntk, C] arrive as float32 values of the caller's weights.
// a and b are formed in float32 and rounded to pt's type (as the TPU
// kernel's fwd_body); every product and sum is float32 and each output is
// rounded to its type once. Derivatives of the rounding are the identity.
//
// Backward (per real triplet, go = ct[e] m): dxg = go sv tv; gs = go xg tv
// and gt = go xg sv are the cotangents of sv and tv; dws = sum_t a^T gs,
// dwt = sum_t b^T gt; with dpt, da = gs @ ws^T and db = gt @ wt^T go back
// through the assembly: d bt[j] = da[j] y0[j/k] + sum_p db[p nk + j]
// yt[p n + j/k], d y0[l] = sum_m da[l k + m] bt[l k + m], d yt[i] = sum_m
// db[i k + m] bt[(i k + m) % nk].
// Second order, from the cotangents (u1, u2, u4, u5) of (dxg, dpt, dws, dwt)
// taken as a tangent: (da', db') = the product-rule tangent of (a, b) along
// u2 (not rounded), dsv = da' @ ws + a @ u4, dtv = db' @ wt + b @ u5, and
//   ctb[e] = sum_k m (u1 sv tv + xg dsv tv + xg sv dtv)
//   xb     = go (dsv tv + sv dtv)
//   Ps = go (u1 tv + xg dtv), Pt = go (u1 sv + xg dsv)   (cotangents of sv, tv)
//   Qs = go xg tv,            Qt = go xg sv              (of dsv, dtv)
//   wsb = sum_t a^T Ps + da'^T Qs, wtb likewise with b, db', Pt, Qt
//   ptb = the assembly adjoint of (Ps @ ws^T + Qs @ u4^T | Pt @ wt^T +
//         Qt @ u5^T) against pt, plus that of (Qs @ ws^T | Qt @ wt^T)
//         against u2 (the tangent is bilinear in pt and u2).
// A triplet with m = 0 contributes nothing to any output; its rows of dxg
// and xb and its columns of dpt and ptb are written as 0 (the inputs may hold
// garbage there, as expand_kj_raw's rows do).
//
// What bounds it on this card. Per real triplet the forward reads its xg row
// and its R values of pt and does 2 C (nk + ntk) flops for the basis
// products; it writes out [E, C]. At SphereNet's force-bench widths on the
// unblocked layout (E = 44,544, K = 16, C = 64, n = 3, k = 6, R = 30, bf16;
// about 305,000 of the 712,704 triplets real in chip_smoke.py's batch) that
// is about 2.9 GFLOP against 51 MB: the bytes bound it (0.015 ms at
// 3.35 TB/s against 0.003 ms of bf16 tensor-core work). The backward reads
// the same and ct, and writes dxg [T, C] and, when asked, dpt [R, T] in full;
// the second order reads twice the rows (u1, u2 beside xg, pt) and writes
// xb and ptb in full: each is bound by its bytes. chip_smoke.py counts both
// bounds from its inputs.
//
// What the design does about it (wgmma for the basis products and TMA are
// later work):
//  - Forward: the first kernel staged every triplet of 8-edge chunks (pt's
//    slab, then a | b with a division by NB and by k per element), and a
//    warp per edge walked k in order, one triplet's 72-step fmaf chain at a
//    time: 2.8% of its byte bound, 41% of its time in the products and 30%
//    in forming a | b, for 57% of triplets masked. It now walks as the
//    second order does (window_list.cuh): a block deals itself 32-triplet
//    chunks a window of about 1024 triplets at a time, lists the window's
//    real triplets in triplet order, writes the out rows of edges without
//    one as 0, and walks the list 64 triplets a batch: the listed
//    triplets' pt columns and xg rows gathered, loads in flight together
//    and free of branches (bf16 widened by a shift: the conversion
//    intrinsic inside a conditional load kept the loads serial); a | b
//    formed by rows for those only, from factor rows tabled once a block
//    (no division in the per-element loops); sv and tv of a warp's 8
//    triplets x its lanes' Q channels as a register tile, each weight
//    loaded once for the 8; each edge's terms summed in list order by a
//    warp a run, the run an edge carries across batches kept in shared
//    memory. Grid: SMs x the occupancy, three blocks of 256 threads an SM
//    at C <= 64.
//  - Backward and second order: about 57% of the triplets are masked, and
//    the first kernels' serial per-entry loops over 32- (16-) triplet
//    chunks left them latency-bound (1-2% of their byte bounds). Both walk
//    as window_list.cuh sets out (the backward with its own copy of the
//    listing): a block deals itself the same chunks (b,
//    b + G, ...) a window of about 1024 triplets (whole edges) at a time,
//    lists the window's real triplets in triplet order by warp ballots,
//    writes the masked ones' outputs as 0 (dxg / xb rows in 16-byte stores,
//    dpt / ptb columns, the second order's ctb rows of edges without a real
//    triplet), and walks the list a batch at a time, one barrier a phase:
//    64 real triplets a batch in the backward, 32 in the second order,
//    which keeps Ps, Qs, Pt, Qt and the ctb terms per triplet. Per batch
//    the listed triplets' pt (and u2) columns are gathered and a | b (and
//    their tangent da' | db') formed once; products a warp per 4 triplets
//    (2 at C > 64), rows read as float4, each weight loaded once for them
//    (the second order's u4 | u5 terms in a second pass only when present,
//    read through the L1 cache so the shared memory keeps two blocks an
//    SM); the weight cotangents a thread's channel x up to 24 rows (36 at C
//    > 64) in registers, read as float4 (the second order's two fmaf a
//    triplet kept in order); the basis cotangents 4 x 3 register tiles;
//    the second order's ctb summed per edge in list order in the registers
//    of the first row block's threads, carried across batches and written
//    when the edge changes. The grid is SMs x the kernel's occupancy
//    (occupancy_grid), so it fills the card and depends only on the shapes
//    and the card. ptxas (sm_90a): backward 103-128 registers, second
//    order 124-128, no spills; two blocks of 256 threads an SM at
//    SphereNet's and DimeNet++'s widths.
//  - ws | wt are staged in shared memory, rows of C+1 floats, so reads
//    with c across lanes (the products) and with the basis row across
//    threads (the tiles) are free of bank conflicts.
//  - No atomics: each thread owns entries of the weight cotangents and adds
//    its block's real triplets in triplet order; out and ctb sum an edge's
//    real triplets in k order; the per-block weight sums go to a [blocks, ...]
//    scratch that sum_partials_kernel adds in a fixed order: repeated
//    calls give the same bits. dpt and ptb are written column by column
//    along the triplets, each from its own triplet alone.
#include <stdint.h>

#include "common.cuh"
#include "window_list.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block

template <typename T>
constexpr bool IS_BF16 = sizeof(T) == 2;

template <typename T>
struct Params {
  const T* xg;      // [T, C]
  const T* pt;      // [R, T]
  const float* ws;  // [nk, C]
  const float* wt;  // [ntk, C] (torsion only)
  const T* m;       // [E, K]
  const float* ct;  // [E, C] (backward, second order)
  const T* u1;      // [T, C] or null: cotangent of dxg
  const T* u2;      // [R, T] or null: cotangent of dpt
  const float* u4;  // [nk, C] or null: cotangent of dws
  const float* u5;  // [ntk, C] or null: cotangent of dwt
  T* out;           // [E, C] (forward)
  T* dxg;           // [T, C] (backward: dxg; second order: xb)
  T* dpt;           // [R, T] or null (backward: dpt; second order: ptb)
  float* ctb;       // [E, C] (second order)
  float* partial;   // [blocks, NB * C]
  size_t Tn;        // E * K
  int E, K, C, n, k, nk, ntk, NB, R, CE;
};

// rows [0, nk) of w_s <- src1 [nk, C], rows [nk, NB) <- src2 [ntk, C] (zeros
// where a pointer is null), row stride C+1 floats.
template <typename T>
__device__ void stage_rows(const Params<T>& p, const float* src1, const float* src2,
                           float* w_s) {
  const int C = p.C;
  for (int x = threadIdx.x; x < p.NB * C; x += NT) {
    const int r = x / C, c = x % C;
    const float* src = r < p.nk ? src1 : src2;
    const int o = r < p.nk ? x : x - p.nk * C;
    w_s[r * (C + 1) + c] = src != nullptr ? src[o] : 0.f;
  }
}

// The pt rows (bt row, y row) whose product is basis row r.
template <typename T>
__device__ __forceinline__ void factors(const Params<T>& p, int r, int& b, int& y) {
  if (r < p.nk) {
    b = r;
    y = p.nk + r / p.k;
  } else {
    const int i = r - p.nk;
    b = i % p.nk;
    y = p.nk + p.n + i / p.k;
  }
}

// The adjoint of forming a | b from the pt rows in src [R][TC]: given the
// cotangent d [NB] of triplet tl's a | b, the cotangent of its pt row r.
template <typename T>
__device__ __forceinline__ float basis_adjoint(const Params<T>& p, const float* d,
                                               const float* src, int r, int tl, int TC) {
  const int nk = p.nk, n = p.n, k = p.k;
  float v = 0.f;
  if (r < nk) {
    const int l = r / k;
    v = d[r] * src[(nk + l) * TC + tl];
    for (int a = 0; a < (p.ntk > 0 ? n : 0); ++a)
      v = fmaf(d[nk + a * nk + r], src[(nk + n + a * n + l) * TC + tl], v);
  } else if (r < nk + n) {
    const int l = r - nk;
    for (int mm = 0; mm < k; ++mm) v = fmaf(d[l * k + mm], src[(l * k + mm) * TC + tl], v);
  } else {
    const int q = r - nk - n;
    for (int mm = 0; mm < k; ++mm)
      v = fmaf(d[nk + q * k + mm], src[((q * k + mm) % nk) * TC + tl], v);
  }
  return v;
}

// Forward tiles: a batch of FB real triplets, FE of them a warp in the
// products.
constexpr int FB = 64, FE = FB / NW;

constexpr int WINDOW = 1024;  // triplets a block lists at a time

// Floats of the forward's shared memory for BW chunks of TC triplets a
// window (fwd_layout's order).
struct FwdLayout {
  int W, rounds;
  size_t w_s, ptc, bas, xs, carry, m_s, eds, rs, fa, fb, lst, wcnt, bits, total;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(const Params<T>& p, int TC) {
  FwdLayout L;
  const int BW = TC >= WINDOW ? 1 : WINDOW / TC;
  L.W = BW * TC;
  L.rounds = (L.W + NT - 1) / NT;
  L.w_s = 0;
  L.ptc = L.w_s + (size_t)p.NB * (p.C + 1);
  L.bas = (L.ptc + (size_t)p.R * FB + 3) & ~(size_t)3;  // 16-byte aligned
  L.xs = L.bas + (size_t)p.NB * FB;
  L.carry = L.xs + (size_t)FB * p.C;
  L.m_s = L.carry + 2 * (size_t)p.C;
  L.eds = L.m_s + FB;
  L.rs = L.eds + FB;
  L.fa = L.rs + FB + 2;
  L.fb = L.fa + p.NB;
  L.lst = L.fb + p.NB;
  L.wcnt = L.lst + L.W;
  L.bits = L.wcnt + (size_t)L.rounds * NW;
  L.total = L.bits + (size_t)L.rounds * NW;
  return L;
}

// The forward, on the compacted walk of window_list.cuh: block b deals
// itself the chunks of TC = CE K triplets b, b + G, ... (G = gridDim.x) a
// window of BW chunks at a time, lists the window's real triplets in
// triplet order (so each edge's are a contiguous run), writes the out rows
// of its edges without one as 0, and walks the list FB triplets at a time.
// Per batch: the listed triplets' pt columns [R][FB], xg rows [FB][C],
// masks and edges are gathered (loads in flight together); a | b is formed
// by rows, [NB][FB], from the factor rows fa, fb tabled once a block, and
// rounded to T, while warp 0 lists the batch's runs of equal edges; each
// warp forms sv and tv of its FE triplets as a register tile over its
// lanes' Q channels (row_tile) and leaves xg sv tv in place of the xg row;
// then a
// warp per run sums its edge's terms in list order, the run an edge
// carries into the next batch kept in shared memory. Every sum is the
// masked walk's: sv, tv fmaf chains over the rows from 0, prod = xg sv,
// prod *= tv, acc = fmaf(prod, m, acc) over the edge's real triplets in k
// order; so out keeps its bits whatever the chunking.
template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT, Q == 2 ? 3 : 2) triplet_pt_fwd_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, nk = p.nk, K = p.K, R = p.R, CE = p.CE, TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const FwdLayout L = fwd_layout(p, TC);
  float* w_s = smem + L.w_s;      // [NB][C+1] ws | wt
  float* ptc = smem + L.ptc;      // [R][FB] the batch's pt columns
  float* bas = smem + L.bas;      // [NB][FB] a | b by row
  float* xs = smem + L.xs;        // [FB][C] xg rows, then xg sv tv
  float* carry = smem + L.carry;  // [2][C] the sums batches carry on
  float* m_s = smem + L.m_s;      // [FB]
  int* eds = reinterpret_cast<int*>(smem + L.eds);  // [FB] edge of each listed triplet
  int* rs = reinterpret_cast<int*>(smem + L.rs);    // [FB + 2] run starts, cnt; their count
  int* fa = reinterpret_cast<int*>(smem + L.fa);    // [NB] factor rows of each basis row
  int* fb = reinterpret_cast<int*>(smem + L.fb);    // [NB]
  int* lst = reinterpret_cast<int*>(smem + L.lst);
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);
  stage_rows(p, p.ws, p.wt, w_s);
  for (int r = tid; r < NB; r += NT) factors(p, r, fa[r], fb[r]);
  const int chunks = (p.E + CE - 1) / CE;
  const int G = gridDim.x, BW = L.W / TC;

  for (int w0 = blockIdx.x; w0 < chunks; w0 += G * BW) {
    const Window win{w0, G, TC, L.W, chunks, p.Tn};
    const int nl = list_window<NT>(win, p.m, lst, wcnt, bits, [](size_t) {});
    zero_empty_edges<NT>(win, bits, CE, K, p.E, p.out, C);
    for (int b0 = 0; b0 < nl; b0 += FB) {
      const int cnt = min(FB, nl - b0);
      const int* ids = lst + b0;
      __syncthreads();  // the list is written; the previous batch is done
      // pt columns (zero past cnt) and xg rows (a warp FE rows, lanes over
      // C; rows past cnt repeat the last); addresses clamped, no branches
      for (int x0 = tid; x0 < R * FB; x0 += 4 * NT) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int x = min(x0 + u * NT, R * FB - 1), r = x / FB, i = x % FB;
          v[u] = ldw(p.pt + (size_t)r * p.Tn + ids[min(i, cnt - 1)]);
          if (i >= cnt) v[u] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (x0 + u * NT < R * FB) ptc[x0 + u * NT] = v[u];
      }
      {
        float v[FE][Q];
#pragma unroll
        for (int e = 0; e < FE; ++e) {
          const size_t row = (size_t)ids[min(warp + NW * e, cnt - 1)] * C;
#pragma unroll
          for (int q = 0; q < Q; ++q) v[e][q] = ldw(p.xg + row + min(lane + 32 * q, C - 1));
        }
#pragma unroll
        for (int e = 0; e < FE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (lane + 32 * q < C) xs[(warp + NW * e) * C + lane + 32 * q] = v[e][q];
      }
      for (int i = tid; i < FB; i += NT) {
        const int t = ids[min(i, cnt - 1)];
        m_s[i] = ldw(p.m + t);
        eds[i] = i < cnt ? t / K : -1;
      }
      __syncthreads();
      for (int x = tid; x < NB * FB; x += NT) {
        const int r = x / FB, i = x % FB;
        bas[x] = rnd<IS_BF16<T>>(ptc[fa[r] * FB + i] * ptc[fb[r] * FB + i]);
      }
      if (warp == 0) list_runs(eds, cnt, rs, rs + FB + 1);
      __syncthreads();
      const int i0 = warp * FE;
      if (i0 < cnt) {
        float sv[FE][Q], tv[FE][Q];
#pragma unroll
        for (int e = 0; e < FE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) sv[e][q] = tv[e][q] = 0.f;
        row_tile(bas, FB, w_s, 0, nk, i0, lane, C, sv);
        if constexpr (HAS_T) row_tile(bas, FB, w_s, nk, NB, i0, lane, C, tv);
#pragma unroll
        for (int e = 0; e < FE; ++e) {
          if (i0 + e >= cnt) break;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < C) {
              float prod = xs[(i0 + e) * C + c] * sv[e][q];
              if constexpr (HAS_T) prod *= tv[e][q];
              xs[(i0 + e) * C + c] = prod;
            }
          }
        }
      }
      __syncthreads();
      const int par = (b0 / FB) & 1;
      add_edge_runs<NT, Q>(xs, m_s, eds, rs, rs[FB + 1], b0 > 0 ? lst[b0 - 1] / K : -1,
                           carry + par * C, carry + (1 - par) * C, b0 + FB >= nl, p.out, C);
    }
  }
}

// Backward tiles: a batch of BB real triplets; products TE triplets a warp;
// the (a | b) cotangents TE2 triplets x TR rows a thread (TR odd: no bank
// conflicts on the weights' C + 1 stride).
constexpr int BB = 64, TE = 4, TE2 = 4, TR = 3;
// The second order keeps more per triplet: batches of BB2.
constexpr int BB2 = 32;

// Floats of the backward's shared memory for BW chunks of TC triplets a
// window (bwd_layout's order).
struct BwdLayout {
  int NBp, CP, W, rounds;
  size_t w_s, dW_s, ptc, bas, gs, gt, m_s, lst, wcnt, bits, total;
};

template <typename T, bool HAS_T>
__host__ __device__ inline BwdLayout bwd_layout(const Params<T>& p, int TC) {
  BwdLayout L;
  L.NBp = (p.NB + 3) & ~3;  // float4 rows of a | b
  L.CP = p.C + 1;
  const int BW = TC >= WINDOW ? 1 : WINDOW / TC;
  L.W = BW * TC;
  L.rounds = (L.W + NT - 1) / NT;
  L.w_s = 0;
  L.dW_s = L.w_s + (size_t)p.NB * (p.C + 1);
  L.ptc = L.dW_s + (size_t)p.NB * p.C;
  L.bas = L.ptc + (size_t)p.R * BB;
  L.bas = (L.bas + 3) & ~(size_t)3;  // 16-byte aligned
  L.gs = L.bas + (size_t)BB * L.NBp;
  L.gt = L.gs + (size_t)BB * L.CP;
  L.m_s = L.gt + (HAS_T ? (size_t)BB * L.CP : 0);
  L.lst = L.m_s + BB;
  L.wcnt = L.lst + L.W;
  L.bits = L.wcnt + (size_t)L.rounds * NW;
  L.total = L.bits + (size_t)L.rounds * NW;
  return L;
}

// The backward. Block b owns the chunks of TC = CE K triplets b, b + G,
// b + 2G, ... (G = gridDim.x) and takes them a window of BW chunks at a
// time: the window's real triplets (m != 0) are listed in triplet order by
// warp ballots, the masked ones get their dxg rows and dpt columns written
// as 0, and the list is walked BB triplets at a time. (The listing is
// window_list.cuh's, written out here: through the shared helper this
// kernel ran 3-7% slower at DimeNet++'s widths.) Per
// batch: the pt columns and a | b (float4 rows); sv, tv, dxg and the
// cotangents gs, gt of sv, tv (a warp per TE triplets, lanes over the
// channels, each weight loaded once for the warp's triplets); the block's
// dws | dwt (each entry owned by one thread, a row block of up to WTM rows
// kept in registers over the batch and read with float4 loads); with DPT,
// da | db = gs @ ws^T | gt @ wt^T as TE2 x TR register tiles (over a | b,
// dead by then) and the adjoint of the assembly, a dpt column per triplet.
// Every sum keeps the order of the masked walk over the same chunks: sv, tv
// and da | db over the rows / channels from 0, dws | dwt over the block's
// real triplets in triplet order.
template <typename T, int Q, bool HAS_T, bool DPT>
__global__ void __launch_bounds__(NT, 2) triplet_pt_bwd_kernel(Params<T> p) {
  constexpr int WTM = Q == 2 ? 24 : 36;  // dws | dwt rows of a thread's register block
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, nk = p.nk, K = p.K, R = p.R, TC = p.CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const BwdLayout L = bwd_layout<T, HAS_T>(p, TC);
  const int NBp = L.NBp, CP = L.CP, W = L.W;
  float* w_s = smem + L.w_s;    // [NB][C+1] ws | wt
  float* dW_s = smem + L.dW_s;  // [NB][C] dws | dwt of this block
  float* ptc = smem + L.ptc;    // [R][BB] the batch's pt columns
  float* bas = smem + L.bas;    // [BB][NBp] a | b, then (DPT) da | db
  float* gs = smem + L.gs;      // [BB][C+1] cotangent of sv
  float* gt = smem + L.gt;      // [BB][C+1] cotangent of tv (torsion)
  float* m_s = smem + L.m_s;    // [BB]
  int* lst = reinterpret_cast<int*>(smem + L.lst);            // [W] real triplets
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);          // [rounds * NW]
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);  // [rounds * NW]
  stage_rows(p, p.ws, p.wt, w_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  const int chunks = (p.E + p.CE - 1) / p.CE;
  const int G = gridDim.x, BW = W / TC;
  // dws | dwt: thread items (channel c, a block of rpg rows), rpg a multiple
  // of 4 of about NB C / NT rows, at most WTM
  int rpg = (NB * C + NT - 1) / NT;
  rpg = min(WTM, (rpg + 3) & ~3);
  const int ngroups = (NB + rpg - 1) / rpg;
  constexpr int VEC = 16 / sizeof(T);  // dxg elements a 16-byte store

  for (int w0 = blockIdx.x; w0 < chunks; w0 += G * BW) {
    // the window's chunks w0, w0 + G, ... (BW of them); position x of the
    // window is triplet (w0 + G (x / TC)) TC + x % TC
    __syncthreads();  // the previous window is done with the list
    for (int j = 0; j < L.rounds; ++j) {
      const int x = j * NT + tid;
      const size_t ch = (size_t)w0 + (size_t)G * (x / TC);
      const size_t t = ch * TC + x % TC;
      const bool valid = x < W && ch < (size_t)chunks && t < p.Tn;
      const bool real = valid && ld(p.m + t) != 0.f;
      const unsigned mask = __ballot_sync(0xffffffffu, real);
      if (lane == 0) {
        wcnt[j * NW + warp] = __popc(mask);
        bits[j * NW + warp] = mask;
      }
      if (valid && !real && DPT) {
        for (int r = 0; r < R; ++r) st(p.dpt + (size_t)r * p.Tn + t, 0.f);
      }
    }
    __syncthreads();
    int nl = 0;
    for (int j = 0; j < L.rounds; ++j) {
      int at = 0;
      for (int q = 0; q < L.rounds * NW; ++q) {
        if (q < j * NW + warp) at += wcnt[q];
        if (j == 0) nl += wcnt[q];
      }
      const unsigned mask = bits[j * NW + warp];
      if ((mask >> lane) & 1u) {
        const int x = j * NT + tid;
        const size_t ch = (size_t)w0 + (size_t)G * (x / TC);
        lst[at + __popc(mask & ((1u << lane) - 1u))] = (int)(ch * TC + x % TC);
      }
    }
    // the masked triplets' dxg rows: 0
    if (C % VEC == 0) {
      const int CV = C / VEC;
      for (int x = tid; x < W * CV; x += NT) {
        const int pos = x / CV;
        const size_t ch = (size_t)w0 + (size_t)G * (pos / TC);
        const size_t t = ch * TC + pos % TC;
        if (ch >= (size_t)chunks || t >= p.Tn) continue;
        if ((bits[pos >> 5] >> (pos & 31)) & 1u) continue;
        reinterpret_cast<uint4*>(p.dxg + t * C)[x % CV] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int x = tid; x < W * C; x += NT) {
        const int pos = x / C;
        const size_t ch = (size_t)w0 + (size_t)G * (pos / TC);
        const size_t t = ch * TC + pos % TC;
        if (ch >= (size_t)chunks || t >= p.Tn) continue;
        if ((bits[pos >> 5] >> (pos & 31)) & 1u) continue;
        st(p.dxg + t * C + x % C, 0.f);
      }
    }

    for (int b0 = 0; b0 < nl; b0 += BB) {
      const int cnt = min(BB, nl - b0);
      const int* ids = lst + b0;
      __syncthreads();  // the list is written; the previous batch is done
      for (int x = tid; x < R * BB; x += NT) {
        const int r = x / BB, i = x % BB;
        ptc[x] = i < cnt ? ld(p.pt + (size_t)r * p.Tn + ids[i]) : 0.f;
      }
      for (int i = tid; i < BB; i += NT) m_s[i] = i < cnt ? ld(p.m + ids[i]) : 0.f;
      __syncthreads();
      // a | b, rounded to T; zero past cnt and NB
      for (int x = tid; x < BB * NBp; x += NT) {
        const int r = x / BB, i = x % BB;
        float v = 0.f;
        if (i < cnt && r < NB) {
          int b, y;
          factors(p, r, b, y);
          v = rnd<IS_BF16<T>>(ptc[b * BB + i] * ptc[y * BB + i]);
        }
        bas[i * NBp + r] = v;
      }
      __syncthreads();
      // sv, tv of TE triplets a warp; dxg, gs, gt
      for (int e0 = warp * TE; e0 < cnt; e0 += NW * TE) {
        float sv[TE][Q], tv[TE][Q];
#pragma unroll
        for (int e = 0; e < TE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) sv[e][q] = tv[e][q] = 0.f;
        for (int r = 0; r < NB; r += 4) {
          float4 b4[TE];
#pragma unroll
          for (int e = 0; e < TE; ++e)
            b4[e] = *reinterpret_cast<const float4*>(bas + (e0 + e) * NBp + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = r + j;
            if (rr >= NB || (!HAS_T && rr >= nk)) break;
            float wv[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q)
              wv[q] = lane + 32 * q < C ? w_s[rr * (C + 1) + lane + 32 * q] : 0.f;
#pragma unroll
            for (int e = 0; e < TE; ++e) {
              const float bv = j == 0 ? b4[e].x : j == 1 ? b4[e].y : j == 2 ? b4[e].z : b4[e].w;
#pragma unroll
              for (int q = 0; q < Q; ++q) {
                if (rr < nk) sv[e][q] = fmaf(bv, wv[q], sv[e][q]);
                else tv[e][q] = fmaf(bv, wv[q], tv[e][q]);
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < TE; ++e) {
          const int i = e0 + e;
          if (i >= cnt) break;
          const size_t t = (size_t)ids[i];
          const size_t ed = t / K;
          const float m = m_s[i];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < C) {
              const float go = p.ct[ed * C + c] * m;
              const float x = ld(p.xg + t * C + c);
              float d = go * sv[e][q], g1 = go * x;
              if constexpr (HAS_T) {
                d *= tv[e][q];
                gt[i * CP + c] = g1 * sv[e][q];
                g1 *= tv[e][q];
              }
              st(p.dxg + t * C + c, d);
              gs[i * CP + c] = g1;
            }
          }
        }
      }
      __syncthreads();
      // dws | dwt: item (c, row block), the block's rows in registers, the
      // batch's triplets in order
      for (int it = tid; it < C * ngroups; it += NT) {
        const int c = it % C, r0 = (it / C) * rpg;
        const int r1 = min(NB, r0 + rpg);
        float acc[WTM];
#pragma unroll
        for (int j = 0; j < WTM; ++j) acc[j] = r0 + j < r1 ? dW_s[(r0 + j) * C + c] : 0.f;
        for (int i = 0; i < cnt; ++i) {
          const float g_s = gs[i * CP + c];
          const float g_t = HAS_T ? gt[i * CP + c] : 0.f;
          const float* brow = bas + i * NBp + r0;
#pragma unroll
          for (int j4 = 0; j4 < WTM / 4; ++j4) {
            if (r0 + 4 * j4 >= r1) break;
            const float4 b4 = *reinterpret_cast<const float4*>(brow + 4 * j4);
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = r0 + 4 * j4 + j;
              if (rr < r1) acc[4 * j4 + j] = fmaf(bv[j], rr < nk ? g_s : g_t, acc[4 * j4 + j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < WTM; ++j)
          if (r0 + j < r1) dW_s[(r0 + j) * C + c] = acc[j];
      }
      if constexpr (DPT) {
        __syncthreads();  // a | b is dead: da | db go there
        // da = gs @ ws^T, db = gt @ wt^T: TE2 triplets x TR rows a thread,
        // rows of a tile all of ws or all of wt, each sum over c from 0
        const int rts = (nk + TR - 1) / TR;
        const int rtl = rts + (HAS_T ? (p.ntk + TR - 1) / TR : 0);
        const int etl = (cnt + TE2 - 1) / TE2;
        for (int x = tid; x < etl * rtl; x += NT) {
          const int et = x / rtl, rt = x % rtl;
          const bool sr = rt < rts;
          const int r0 = sr ? rt * TR : nk + (rt - rts) * TR;
          const int r1 = sr ? nk : NB;
          const float* g = sr ? gs : gt;
          const float* wr[TR];
          int es[TE2];
#pragma unroll
          for (int i = 0; i < TR; ++i) wr[i] = w_s + min(r0 + i, r1 - 1) * (C + 1);
#pragma unroll
          for (int e = 0; e < TE2; ++e) es[e] = min(et * TE2 + e, cnt - 1) * CP;
          float acc[TE2][TR];
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) acc[e][i] = 0.f;
          for (int c = 0; c < C; ++c) {
            float gv[TE2], wv[TR];
#pragma unroll
            for (int e = 0; e < TE2; ++e) gv[e] = g[es[e] + c];
#pragma unroll
            for (int i = 0; i < TR; ++i) wv[i] = wr[i][c];
#pragma unroll
            for (int e = 0; e < TE2; ++e)
#pragma unroll
              for (int i = 0; i < TR; ++i) acc[e][i] = fmaf(gv[e], wv[i], acc[e][i]);
          }
#pragma unroll
          for (int e = 0; e < TE2; ++e) {
            const int i = et * TE2 + e;
            if (i >= cnt) continue;
#pragma unroll
            for (int k2 = 0; k2 < TR; ++k2)
              if (r0 + k2 < r1) bas[i * NBp + r0 + k2] = acc[e][k2];
          }
        }
        __syncthreads();
        // back through the assembly: a dpt column per triplet
        for (int x = tid; x < R * BB; x += NT) {
          const int r = x / BB, i = x % BB;
          if (i >= cnt) continue;
          st(p.dpt + (size_t)r * p.Tn + ids[i], basis_adjoint(p, bas + i * NBp, ptc, r, i, BB));
        }
      }
    }
  }
  __syncthreads();
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

// Floats of the second order's shared memory for BW chunks of TC triplets
// a window (bwd2_layout's order).
struct Bwd2Layout {
  int NBp, CP, W, rounds;
  size_t w_s, dW_s, ptc, u2c, bas, dbas, Ps, Qs, I, Pt, Qt, m_s, lst, wcnt, bits, total;
};

template <typename T, bool HAS_T>
__host__ __device__ inline Bwd2Layout bwd2_layout(const Params<T>& p, int TC) {
  Bwd2Layout L;
  L.NBp = (p.NB + 3) & ~3;
  L.CP = p.C + 1;
  const int BW = TC >= WINDOW ? 1 : WINDOW / TC;
  L.W = BW * TC;
  L.rounds = (L.W + NT - 1) / NT;
  const size_t tc = (size_t)BB2 * L.CP;
  L.w_s = 0;
  L.dW_s = L.w_s + (size_t)p.NB * (p.C + 1);
  L.ptc = L.dW_s + (size_t)p.NB * p.C;
  L.u2c = L.ptc + (size_t)p.R * BB2;
  L.bas = (L.u2c + (size_t)p.R * BB2 + 3) & ~(size_t)3;  // 16-byte aligned
  L.dbas = L.bas + (size_t)BB2 * L.NBp;
  L.Ps = L.dbas + (size_t)BB2 * L.NBp;
  L.Qs = L.Ps + tc;
  L.I = L.Qs + tc;
  L.Pt = L.I + tc;
  L.Qt = L.Pt + (HAS_T ? tc : 0);
  L.m_s = L.Qt + (HAS_T ? tc : 0);
  L.lst = L.m_s + BB2;
  L.wcnt = L.lst + L.W;
  L.bits = L.wcnt + (size_t)L.rounds * NW;
  L.total = L.bits + (size_t)L.rounds * NW;
  return L;
}

// Row rr of u4 | u5 (the rows of wsb | wtb's tangent weights), or null
// where that cotangent is absent (its terms are then sums of zeros, as
// the parent kernel's zero-staged rows gave).
template <typename T>
__device__ __forceinline__ const float* u_row(const Params<T>& p, int rr) {
  if (rr < p.nk) return p.u4 != nullptr ? p.u4 + (size_t)rr * p.C : nullptr;
  return p.u5 != nullptr ? p.u5 + (size_t)(rr - p.nk) * p.C : nullptr;
}

// The second order, walked as the backward is: the window's real triplets
// listed by ballots (triplet order is edge order), the masked ones' xb rows,
// ptb columns and the ctb rows of edges without a real triplet written as
// 0, the list walked BB2 triplets at a time. Per batch: the pt and u2
// columns of the listed triplets; a | b (rounded) and their tangent da' |
// db' along u2; sv, tv, dsv, dtv of TE triplets a warp (each weight loaded
// once for the warp's triplets; the u4 | u5 terms in a second pass, only
// when present, read through the L1 cache), xb and the per-channel
// cotangents Ps, Qs, Pt, Qt and the ctb terms I; wsb | wtb over (channel,
// row block) register blocks, the two fmaf a triplet in the order a^T P,
// then da'^T Q, while the threads of the first row block also sum each
// edge's ctb terms in list order, carried across batches in registers and
// written when the edge changes; the cotangents of a | b (P @ w^T + Q @
// u^T) and of da' | db' (Q @ w^T) as TE2 x TR register tiles; the assembly
// adjoint, a ptb column per triplet. Every sum keeps the parent kernel's
// order, so every output keeps its bits wherever the grid keeps its block
// count.
template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT, 2) triplet_pt_bwd2_kernel(Params<T> p) {
  constexpr int TEQ = Q == 2 ? 4 : 2;    // triplets a warp in the products
  constexpr int WTM = Q == 2 ? 24 : 36;  // wsb | wtb rows of a thread's register block
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, nk = p.nk, K = p.K, R = p.R, CE = p.CE, TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const bool has_u45 = p.u4 != nullptr || p.u5 != nullptr;
  const Bwd2Layout L = bwd2_layout<T, HAS_T>(p, TC);
  const int NBp = L.NBp, CP = L.CP, W = L.W;
  float* w_s = smem + L.w_s;    // [NB][C+1] ws | wt
  float* dW_s = smem + L.dW_s;  // [NB][C] wsb | wtb of this block
  float* ptc = smem + L.ptc;    // [R][BB2] the batch's pt columns
  float* u2c = smem + L.u2c;    // [R][BB2] its u2 columns (zeros without u2)
  float* bas = smem + L.bas;    // [BB2][NBp] a | b, then their cotangents
  float* dbas = smem + L.dbas;  // [BB2][NBp] da' | db', then theirs
  float* Ps = smem + L.Ps;      // [BB2][C+1]
  float* Qs = smem + L.Qs;      // [BB2][C+1]
  float* I_s = smem + L.I;      // [BB2][C+1] ctb terms
  float* Pt = smem + L.Pt;      // [BB2][C+1] (torsion)
  float* Qt = smem + L.Qt;      // [BB2][C+1] (torsion)
  float* m_s = smem + L.m_s;    // [BB2]
  int* lst = reinterpret_cast<int*>(smem + L.lst);
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);
  stage_rows(p, p.ws, p.wt, w_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  const int chunks = (p.E + CE - 1) / CE;
  const int G = gridDim.x, BW = W / TC;
  int rpg = (NB * C + NT - 1) / NT;
  rpg = min(WTM, (rpg + 3) & ~3);
  const int ngroups = (NB + rpg - 1) / rpg;

  for (int w0 = blockIdx.x; w0 < chunks; w0 += G * BW) {
    const Window win{w0, G, TC, W, chunks, p.Tn};
    const int nl = list_window<NT>(win, p.m, lst, wcnt, bits, [&](size_t t) {
      for (int r = 0; r < R; ++r) st(p.dpt + (size_t)r * p.Tn + t, 0.f);
    });
    zero_masked_rows<NT>(win, bits, p.dxg, C);
    // ctb rows of the window's edges without a real triplet
    for (int x = tid; x < BW * CE * C; x += NT) {
      const int le = x / C, j = le / CE, ce = le % CE;
      const size_t ch = (size_t)w0 + (size_t)G * j, e = ch * CE + ce;
      if (ch >= (size_t)chunks || e >= (size_t)p.E) continue;
      if (!any_listed(bits, j * TC + ce * K, K)) p.ctb[e * C + x % C] = 0.f;
    }
    // (tid < C) the edge whose ctb entry of channel tid is being summed
    int cur = -1;
    float cacc = 0.f;

    for (int b0 = 0; b0 < nl; b0 += BB2) {
      const int cnt = min(BB2, nl - b0);
      const int* ids = lst + b0;
      __syncthreads();  // the list is written; the previous batch is done
      for (int x = tid; x < R * BB2; x += NT) {
        const int r = x / BB2, i = x % BB2;
        const size_t o = (size_t)r * p.Tn + (i < cnt ? ids[i] : 0);
        ptc[x] = i < cnt ? ld(p.pt + o) : 0.f;
        u2c[x] = i < cnt && p.u2 != nullptr ? ld(p.u2 + o) : 0.f;
      }
      for (int i = tid; i < BB2; i += NT) m_s[i] = i < cnt ? ld(p.m + ids[i]) : 0.f;
      __syncthreads();
      // a | b rounded to T, da' | db' (not rounded); zero past cnt and NB
      for (int x = tid; x < BB2 * NBp; x += NT) {
        const int r = x / BB2, i = x % BB2;
        float v = 0.f, dv = 0.f;
        if (i < cnt && r < NB) {
          int b, y;
          factors(p, r, b, y);
          v = rnd<IS_BF16<T>>(ptc[b * BB2 + i] * ptc[y * BB2 + i]);
          dv = u2c[b * BB2 + i] * ptc[y * BB2 + i] + ptc[b * BB2 + i] * u2c[y * BB2 + i];
        }
        bas[i * NBp + r] = v;
        dbas[i * NBp + r] = dv;
      }
      __syncthreads();
      // sv, tv, dsv, dtv of TEQ triplets a warp; xb, Ps, Qs, Pt, Qt, I
      for (int e0 = warp * TEQ; e0 < cnt; e0 += NW * TEQ) {
        float sv[TEQ][Q], tv[TEQ][Q], dsv[TEQ][Q], dtv[TEQ][Q];
#pragma unroll
        for (int e = 0; e < TEQ; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) sv[e][q] = tv[e][q] = dsv[e][q] = dtv[e][q] = 0.f;
        for (int r = 0; r < NB; r += 4) {
          float4 b4[TEQ], d4[TEQ];
#pragma unroll
          for (int e = 0; e < TEQ; ++e) {
            b4[e] = *reinterpret_cast<const float4*>(bas + (e0 + e) * NBp + r);
            d4[e] = *reinterpret_cast<const float4*>(dbas + (e0 + e) * NBp + r);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = r + j;
            if (rr >= NB) break;
            float wv[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q)
              wv[q] = lane + 32 * q < C ? w_s[rr * (C + 1) + lane + 32 * q] : 0.f;
#pragma unroll
            for (int e = 0; e < TEQ; ++e) {
              const float bv = j == 0 ? b4[e].x : j == 1 ? b4[e].y : j == 2 ? b4[e].z : b4[e].w;
              const float dv = j == 0 ? d4[e].x : j == 1 ? d4[e].y : j == 2 ? d4[e].z : d4[e].w;
#pragma unroll
              for (int q = 0; q < Q; ++q) {
                if (rr < nk) {
                  sv[e][q] = fmaf(bv, wv[q], sv[e][q]);
                  dsv[e][q] = fmaf(dv, wv[q], dsv[e][q]);
                } else {
                  tv[e][q] = fmaf(bv, wv[q], tv[e][q]);
                  dtv[e][q] = fmaf(dv, wv[q], dtv[e][q]);
                }
              }
            }
          }
        }
        if (has_u45) {  // dsv += a @ u4, dtv += b @ u5, each summed alone first
          float a4[TEQ][Q], a5[TEQ][Q];
#pragma unroll
          for (int e = 0; e < TEQ; ++e)
#pragma unroll
            for (int q = 0; q < Q; ++q) a4[e][q] = a5[e][q] = 0.f;
          for (int r = 0; r < NB; r += 4) {
            float4 b4[TEQ];
#pragma unroll
            for (int e = 0; e < TEQ; ++e)
              b4[e] = *reinterpret_cast<const float4*>(bas + (e0 + e) * NBp + r);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = r + j;
              if (rr >= NB) break;
              const float* u = u_row(p, rr);
              float uv[Q];
#pragma unroll
              for (int q = 0; q < Q; ++q)
                uv[q] = u != nullptr && lane + 32 * q < C ? __ldg(u + lane + 32 * q) : 0.f;
#pragma unroll
              for (int e = 0; e < TEQ; ++e) {
                const float bv = j == 0 ? b4[e].x : j == 1 ? b4[e].y : j == 2 ? b4[e].z : b4[e].w;
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                  if (rr < nk) a4[e][q] = fmaf(bv, uv[q], a4[e][q]);
                  else a5[e][q] = fmaf(bv, uv[q], a5[e][q]);
                }
              }
            }
          }
#pragma unroll
          for (int e = 0; e < TEQ; ++e)
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              dsv[e][q] += a4[e][q];
              if constexpr (HAS_T) dtv[e][q] += a5[e][q];
            }
        }
#pragma unroll
        for (int e = 0; e < TEQ; ++e) {
          const int i = e0 + e;
          if (i >= cnt) break;
          const size_t t = (size_t)ids[i];
          const size_t ed = t / K;
          const float m = m_s[i];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < C) {
              const float go = p.ct[ed * C + c] * m;
              const float x = ld(p.xg + t * C + c);
              const float u1 = p.u1 != nullptr ? ld(p.u1 + t * C + c) : 0.f;
              const float s = sv[e][q], ds = dsv[e][q];
              float xb, ps, qs, integ;
              if constexpr (HAS_T) {
                const float tt = tv[e][q], dt = dtv[e][q];
                qs = go * (x * tt);
                ps = go * fmaf(u1, tt, x * dt);
                Pt[i * CP + c] = go * fmaf(u1, s, x * ds);
                Qt[i * CP + c] = go * (x * s);
                xb = go * fmaf(ds, tt, s * dt);
                integ = fmaf(fmaf(u1, s, x * ds), tt, (x * s) * dt);
              } else {
                qs = go * x;
                ps = go * u1;
                xb = go * ds;
                integ = fmaf(u1, s, x * ds);
              }
              st(p.dxg + t * C + c, xb);
              Ps[i * CP + c] = ps;
              Qs[i * CP + c] = qs;
              I_s[i * CP + c] = integ * m;
            }
          }
        }
      }
      __syncthreads();
      // wsb | wtb: item (c, row block), the rows in registers, the batch's
      // triplets in order; the items of the first row block (it = tid < C)
      // also sum ctb[e][c] over each edge's real triplets in order
      for (int it = tid; it < C * ngroups; it += NT) {
        const int c = it % C, r0 = (it / C) * rpg;
        const int r1 = min(NB, r0 + rpg);
        float acc[WTM];
#pragma unroll
        for (int j = 0; j < WTM; ++j) acc[j] = r0 + j < r1 ? dW_s[(r0 + j) * C + c] : 0.f;
        for (int i = 0; i < cnt; ++i) {
          const float ps = Ps[i * CP + c], qs = Qs[i * CP + c];
          const float pt = HAS_T ? Pt[i * CP + c] : 0.f, qt = HAS_T ? Qt[i * CP + c] : 0.f;
          const float* brow = bas + i * NBp + r0;
          const float* drow = dbas + i * NBp + r0;
#pragma unroll
          for (int j4 = 0; j4 < WTM / 4; ++j4) {
            if (r0 + 4 * j4 >= r1) break;
            const float4 b4 = *reinterpret_cast<const float4*>(brow + 4 * j4);
            const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * j4);
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
            const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = r0 + 4 * j4 + j;
              if (rr < r1) {
                const bool sr = rr < nk;
                acc[4 * j4 + j] = fmaf(bv[j], sr ? ps : pt, acc[4 * j4 + j]);
                acc[4 * j4 + j] = fmaf(dv[j], sr ? qs : qt, acc[4 * j4 + j]);
              }
            }
          }
          if (r0 == 0) {
            const int e = ids[i] / K;
            if (e != cur) {
              if (cur >= 0) p.ctb[(size_t)cur * C + c] = cacc;
              cur = e;
              cacc = 0.f;
            }
            cacc += I_s[i * CP + c];
          }
        }
#pragma unroll
        for (int j = 0; j < WTM; ++j)
          if (r0 + j < r1) dW_s[(r0 + j) * C + c] = acc[j];
      }
      __syncthreads();  // a | b and da' | db' are dead: their cotangents go there
      // cotangents of a | b (P @ w^T + Q @ u^T) and of da' | db' (Q @ w^T):
      // TE2 triplets x TR rows a thread, rows of a tile all of ws or all of
      // wt, each sum over c from 0. The row tiles run fastest across a
      // warp (its stores to bas and dbas spread over the banks), but with
      // u4 | u5 the triplet tiles do, so that a warp's reads of their rows
      // (from global) fall on few rows.
      const int rts = (nk + TR - 1) / TR;
      const int rtl = rts + (HAS_T ? (p.ntk + TR - 1) / TR : 0);
      const int etl = (cnt + TE2 - 1) / TE2;
      for (int x = tid; x < etl * rtl; x += NT) {
        const int rt = has_u45 ? x / etl : x % rtl, et = has_u45 ? x % etl : x / rtl;
        const bool sr = rt < rts;
        const int r0 = sr ? rt * TR : nk + (rt - rts) * TR;
        const int r1 = sr ? nk : NB;
        const float* P = sr ? Ps : Pt;
        const float* Qv = sr ? Qs : Qt;
        const float* wr[TR];
        int es[TE2];
#pragma unroll
        for (int i = 0; i < TR; ++i) wr[i] = w_s + min(r0 + i, r1 - 1) * (C + 1);
#pragma unroll
        for (int e = 0; e < TE2; ++e) es[e] = min(et * TE2 + e, cnt - 1) * CP;
        float ga[TE2][TR], gd[TE2][TR];
#pragma unroll
        for (int e = 0; e < TE2; ++e)
#pragma unroll
          for (int i = 0; i < TR; ++i) ga[e][i] = gd[e][i] = 0.f;
        for (int c = 0; c < C; ++c) {
          float pv[TE2], qv[TE2], wv[TR];
#pragma unroll
          for (int e = 0; e < TE2; ++e) {
            pv[e] = P[es[e] + c];
            qv[e] = Qv[es[e] + c];
          }
#pragma unroll
          for (int i = 0; i < TR; ++i) wv[i] = wr[i][c];
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              ga[e][i] = fmaf(pv[e], wv[i], ga[e][i]);
              gd[e][i] = fmaf(qv[e], wv[i], gd[e][i]);
            }
        }
        if (has_u45) {
          const float* ur[TR];
#pragma unroll
          for (int i = 0; i < TR; ++i) ur[i] = u_row(p, min(r0 + i, r1 - 1));
          float gu[TE2][TR];
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) gu[e][i] = 0.f;
          for (int c = 0; c < C; ++c) {
            float qv[TE2], uv[TR];
#pragma unroll
            for (int e = 0; e < TE2; ++e) qv[e] = Qv[es[e] + c];
#pragma unroll
            for (int i = 0; i < TR; ++i) uv[i] = ur[i] != nullptr ? __ldg(ur[i] + c) : 0.f;
#pragma unroll
            for (int e = 0; e < TE2; ++e)
#pragma unroll
              for (int i = 0; i < TR; ++i) gu[e][i] = fmaf(qv[e], uv[i], gu[e][i]);
          }
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) ga[e][i] += gu[e][i];
        }
#pragma unroll
        for (int e = 0; e < TE2; ++e) {
          const int i = et * TE2 + e;
          if (i >= cnt) continue;
#pragma unroll
          for (int k2 = 0; k2 < TR; ++k2)
            if (r0 + k2 < r1) {
              bas[i * NBp + r0 + k2] = ga[e][k2];
              dbas[i * NBp + r0 + k2] = gd[e][k2];
            }
        }
      }
      __syncthreads();
      // ptb: through the assembly against pt and, for the tangent, against u2
      for (int x = tid; x < R * BB2; x += NT) {
        const int r = x / BB2, i = x % BB2;
        if (i >= cnt) continue;
        float v = basis_adjoint(p, bas + i * NBp, ptc, r, i, BB2);
        if (p.u2 != nullptr) v += basis_adjoint(p, dbas + i * NBp, u2c, r, i, BB2);
        st(p.dpt + (size_t)r * p.Tn + ids[i], v);
      }
    }
    if (tid < C && cur >= 0) p.ctb[(size_t)cur * C + tid] = cacc;
  }
  __syncthreads();
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

template <typename T>
Params<T> make_params(const void* xg, const void* pt, const float* ws, const float* wt,
                      const void* m, int E, int K, int C, int n, int k, int has_t) {
  Params<T> p{};
  p.xg = static_cast<const T*>(xg);
  p.pt = static_cast<const T*>(pt);
  p.ws = ws;
  p.wt = has_t ? wt : nullptr;
  p.m = static_cast<const T*>(m);
  p.E = E; p.K = K; p.C = C; p.n = n; p.k = k;
  p.nk = n * k;
  p.ntk = has_t ? n * n * k : 0;
  p.NB = p.nk + p.ntk;
  p.R = p.nk + n + (has_t ? n * n : 0);
  p.Tn = (size_t)E * K;
  return p;
}

// edges per chunk: TC = CE * K triplets, about `triplets` of them
int chunk_edges(int K, int triplets) { return K >= triplets ? 1 : triplets / K; }

constexpr int FWD_TRIPLETS = 32, BWD_TRIPLETS = 32, BWD2_TRIPLETS = 16;

// The forward: its grid is SMs x its occupancy (occupancy_grid), at most
// one block a chunk.
template <typename T, int Q, bool HAS_T>
int fwd_q(Params<T> p, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, FWD_TRIPLETS);
  const size_t smem = fwd_layout(p, p.CE * p.K).total * sizeof(float);
  auto kern = triplet_pt_fwd_kernel<T, Q, HAS_T>;
  int blocks = 0;
  const int rc = occupancy_grid(kern, NT, smem, (p.E + p.CE - 1) / p.CE, &blocks);
  if (rc != 0) return rc;
  kern<<<blocks, NT, smem, strm>>>(p);
  return cudaGetLastError();
}

// The backward of one instance: its grid (occupancy_grid, at most one block
// a chunk) in *blocks, and the launch unless only the grid is asked for
// (run false).
template <typename T, int Q, bool HAS_T, bool DPT>
int bwd_q(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, BWD_TRIPLETS);
  const size_t smem = bwd_layout<T, HAS_T>(p, p.CE * p.K).total * sizeof(float);
  auto kern = triplet_pt_bwd_kernel<T, Q, HAS_T, DPT>;
  const int rc = occupancy_grid(kern, NT, smem, (p.E + p.CE - 1) / p.CE, blocks);
  if (rc != 0 || !run) return rc;
  kern<<<*blocks, NT, smem, strm>>>(p);
  return cudaGetLastError();
}

// The second order likewise.
template <typename T, int Q, bool HAS_T>
int bwd2_q(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, BWD2_TRIPLETS);
  const size_t smem = bwd2_layout<T, HAS_T>(p, p.CE * p.K).total * sizeof(float);
  auto kern = triplet_pt_bwd2_kernel<T, Q, HAS_T>;
  const int rc = occupancy_grid(kern, NT, smem, (p.E + p.CE - 1) / p.CE, blocks);
  if (rc != 0 || !run) return rc;
  kern<<<*blocks, NT, smem, strm>>>(p);
  return cudaGetLastError();
}

// Q = channels a lane: 2 for C <= 64, 4 for C <= 128
template <typename T>
int fwd_c(Params<T> p, cudaStream_t strm) {
  const bool t = p.ntk > 0;
  if (p.C <= 64) return t ? fwd_q<T, 2, true>(p, strm) : fwd_q<T, 2, false>(p, strm);
  if (p.C <= 128) return t ? fwd_q<T, 4, true>(p, strm) : fwd_q<T, 4, false>(p, strm);
  return ERR_SHAPE;
}

template <typename T, int Q>
int bwd_b(Params<T> p, bool dpt, int* blocks, bool run, cudaStream_t strm) {
  if (p.ntk > 0) {
    return dpt ? bwd_q<T, Q, true, true>(p, blocks, run, strm)
               : bwd_q<T, Q, true, false>(p, blocks, run, strm);
  }
  return dpt ? bwd_q<T, Q, false, true>(p, blocks, run, strm)
             : bwd_q<T, Q, false, false>(p, blocks, run, strm);
}

template <typename T>
int bwd_c(Params<T> p, bool dpt, int* blocks, bool run, cudaStream_t strm) {
  if (p.C <= 64) return bwd_b<T, 2>(p, dpt, blocks, run, strm);
  if (p.C <= 128) return bwd_b<T, 4>(p, dpt, blocks, run, strm);
  return ERR_SHAPE;
}

template <typename T>
int bwd2_c(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  const bool t = p.ntk > 0;
  if (p.C <= 64)
    return t ? bwd2_q<T, 2, true>(p, blocks, run, strm) : bwd2_q<T, 2, false>(p, blocks, run, strm);
  if (p.C <= 128)
    return t ? bwd2_q<T, 4, true>(p, blocks, run, strm) : bwd2_q<T, 4, false>(p, blocks, run, strm);
  return ERR_SHAPE;
}

bool bad_shape(int E, int K, int C, int n, int k) {
  return E <= 0 || K <= 0 || C <= 0 || C > 128 || n <= 0 || k <= 0 ||
         (long long)E * K >= (1LL << 31);
}

}  // namespace

extern "C" {

// Number of blocks (rows of the partial-sum scratch) of the backward
// (second_order = 0; with dpt or not) or of the second-order pass, at E
// edges of K triplets, on this card; ERR_SHAPE / ERR_SMEM for a shape the
// kernels do not take, -1 for a CUDA error.
int triplet_pt_blocks(int E, int K, int C, int n, int k, int has_t, int bf16, int dpt,
                      int second_order) {
  if (bad_shape(E, K, C, n, k)) return ERR_SHAPE;
  int blocks = -1, rc;
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, E, K, C, n,
                                        k, has_t);
    rc = second_order ? bwd2_c(p, &blocks, false, nullptr)
                      : bwd_c(p, dpt != 0, &blocks, false, nullptr);
  } else {
    auto p = make_params<float>(nullptr, nullptr, nullptr, nullptr, nullptr, E, K, C, n, k,
                                has_t);
    rc = second_order ? bwd2_c(p, &blocks, false, nullptr)
                      : bwd_c(p, dpt != 0, &blocks, false, nullptr);
  }
  return rc == 0 ? blocks : rc < 0 ? rc : -1;
}

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM. xg, pt, m and out
// share one type: bf16 when bf16 != 0, float32 otherwise. wt is ignored
// without torsion (has_t = 0).
int triplet_pt_fwd(const void* xg, const void* pt, const float* ws, const float* wt,
                   const void* m, void* out, int E, int K, int C, int n, int k, int has_t,
                   int bf16, void* stream) {
  if (bad_shape(E, K, C, n, k)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.out = static_cast<__nv_bfloat16*>(out);
    return fwd_c(p, strm);
  }
  auto p = make_params<float>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
  p.out = static_cast<float*>(out);
  return fwd_c(p, strm);
}

// ct float32 [E, C]; dxg [T, C] in the type of xg; dpt [R, T] in the type
// of pt, or null (not computed); partial: [blocks, (nk + ntk) * C] scratch
// with blocks = triplet_pt_blocks(E, K, C, n, k, has_t, bf16, dpt != null,
// 0); dw [(nk + ntk) * C] receives dws | dwt.
int triplet_pt_bwd(const void* xg, const void* pt, const float* ws, const float* wt,
                   const void* m, const float* ct, void* dxg, void* dpt, float* partial,
                   float* dw, int E, int K, int C, int n, int k, int has_t, int bf16,
                   void* stream) {
  if (bad_shape(E, K, C, n, k)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int blocks = 0, rc, NB;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.ct = ct; p.dxg = static_cast<B*>(dxg); p.dpt = static_cast<B*>(dpt);
    p.partial = partial;
    NB = p.NB;
    rc = bwd_c(p, dpt != nullptr, &blocks, true, strm);
  } else {
    auto p = make_params<float>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.ct = ct; p.dxg = static_cast<float*>(dxg); p.dpt = static_cast<float*>(dpt);
    p.partial = partial;
    NB = p.NB;
    rc = bwd_c(p, dpt != nullptr, &blocks, true, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, NB * C, dw, strm);
}

// Second order. ct float32 [E, C]; u1 [T, C] and u2 [R, T] in the type of
// xg, u4 [nk, C] and u5 [ntk, C] float32, each null when absent. xb [T, C]
// and ptb [R, T] in the type of xg, ctb float32 [E, C]; every element
// written. partial: [blocks, (nk + ntk) * C] with blocks =
// triplet_pt_blocks(E, K, C, n, k, has_t, bf16, 1, 1); dw receives wsb |
// wtb.
int triplet_pt_bwd2(const void* xg, const void* pt, const float* ws, const float* wt,
                    const void* m, const float* ct, const void* u1, const void* u2,
                    const float* u4, const float* u5, void* xb, void* ptb, float* ctb,
                    float* partial, float* dw, int E, int K, int C, int n, int k, int has_t,
                    int bf16, void* stream) {
  if (bad_shape(E, K, C, n, k)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int blocks = 0, rc, NB;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.u2 = static_cast<const B*>(u2);
    p.u4 = u4; p.u5 = has_t ? u5 : nullptr;
    p.dxg = static_cast<B*>(xb); p.dpt = static_cast<B*>(ptb); p.ctb = ctb;
    p.partial = partial;
    NB = p.NB;
    rc = bwd2_c(p, &blocks, true, strm);
  } else {
    auto p = make_params<float>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.u2 = static_cast<const float*>(u2);
    p.u4 = u4; p.u5 = has_t ? u5 : nullptr;
    p.dxg = static_cast<float*>(xb); p.dpt = static_cast<float*>(ptb); p.ctb = ctb;
    p.partial = partial;
    NB = p.NB;
    rc = bwd2_c(p, &blocks, true, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, NB * C, dw, strm);
}

}  // extern "C"
