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
//  - Forward and second order: a block walks chunks of CE whole edges (TC =
//    CE K consecutive triplets) grid-stride. pt's [R, TC] slab of a chunk
//    is staged in shared memory with loads coalesced along the triplets (T
//    is pt's minor axis), and a and b are formed there once per triplet
//    for all C channels; a warp per edge (forward: k walked in order,
//    float32 registers) or per triplet (second order), lanes over C (Q
//    channels a lane); masked triplets are skipped by a warp-uniform
//    branch.
//  - Backward (triplet_pt_bwd_kernel): about 57% of the triplets are
//    masked, and the parent kernel's serial per-entry loops over 32-triplet
//    chunks left it latency-bound (1.7% of its byte bound). A block deals
//    itself the same chunks (b, b + G, ...) a window of about 1024
//    triplets at a time, lists the window's real triplets in triplet order
//    by warp ballots, writes the masked ones' dxg rows and dpt columns as
//    0, and walks the list 64 triplets at a time: a barrier covers 64 real
//    triplets, not 32 of any kind. Products: a warp per 4 triplets, a and b
//    read as float4, each weight loaded once for the 4. Weight cotangents:
//    a thread owns a channel and a block of up to 24 rows (36 at C > 64),
//    kept in registers over the batch and read as float4. da | db: 4 x 3 register
//    tiles. The grid is SMs x the kernel's occupancy (cudaOccupancy...), so
//    it fills the card and depends only on the shapes and the card. ptxas
//    (sm_90a): 104-117 registers a thread at C <= 64, 127-128 at C = 128,
//    no spills; two blocks of 256 threads an SM at SphereNet's widths.
//  - ws | wt (and u4 | u5) are staged in shared memory, rows of C+1 floats,
//    so reads with c across lanes (the products) and with the basis row
//    across lanes (da, db) are free of bank conflicts.
//  - No atomics: each thread owns entries of the weight cotangents and adds
//    its block's real triplets in triplet order; ctb sums an edge's K
//    triplets in order; the per-block weight sums go to a [blocks, ...]
//    scratch that sum_partials_kernel adds in a fixed order: repeated
//    calls give the same bits. dpt and ptb are written column by column
//    along the triplets, each from its own triplet alone.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int FWD_GRID = 1056; // forward: at most 8 blocks per SM
constexpr int BWD2_GRID = 264; // second order: a fixed block count

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

// src[:, t0:t0+cnt] -> dst [R][TC] (zero past cnt or without src)
template <typename T>
__device__ void load_slab(const Params<T>& p, const T* src, size_t t0, int cnt, int TC,
                          float* dst) {
  for (int x = threadIdx.x; x < p.R * TC; x += NT) {
    const int r = x / TC, tl = x % TC;
    dst[x] = (src != nullptr && tl < cnt) ? ld(src + (size_t)r * p.Tn + t0 + tl) : 0.f;
  }
}

template <typename T>
__device__ void load_mask(const Params<T>& p, size_t t0, int cnt, int TC, float* m_s) {
  for (int tl = threadIdx.x; tl < TC; tl += NT) m_s[tl] = tl < cnt ? ld(p.m + t0 + tl) : 0.f;
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

// bas [TC][NB]: a | b of each triplet from the slab ptc [R][TC], rounded to T.
template <typename T>
__device__ void form_basis(const Params<T>& p, const float* ptc, int TC, float* bas) {
  for (int x = threadIdx.x; x < TC * p.NB; x += NT) {
    const int tl = x / p.NB, r = x % p.NB;
    int b, y;
    factors(p, r, b, y);
    bas[x] = rnd<IS_BF16<T>>(ptc[b * TC + tl] * ptc[y * TC + tl]);
  }
}

// dbas [TC][NB]: the tangent of a | b along u2 (product rule, not rounded).
template <typename T>
__device__ void form_tangent(const Params<T>& p, const float* ptc, const float* u2c, int TC,
                             float* dbas) {
  for (int x = threadIdx.x; x < TC * p.NB; x += NT) {
    const int tl = x / p.NB, r = x % p.NB;
    int b, y;
    factors(p, r, b, y);
    dbas[x] = u2c[b * TC + tl] * ptc[y * TC + tl] + ptc[b * TC + tl] * u2c[y * TC + tl];
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

// sv[q] = b[0:nk] @ w[0:nk, c_q], tv[q] = b[nk:NB] @ w[nk:NB, c_q]
// (c_q = lane + 32 q; tv untouched without torsion)
template <int Q, bool HAS_T>
__device__ __forceinline__ void row_products(const float* b, const float* w_s, int nk, int NB,
                                             int C, int lane, float (&sv)[Q], float (&tv)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) sv[q] = 0.f;
  for (int r = 0; r < nk; ++r) {
    const float v = b[r];
    const float* w = w_s + r * (C + 1) + lane;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (lane + 32 * q < C) sv[q] = fmaf(v, w[32 * q], sv[q]);
  }
  if constexpr (HAS_T) {
#pragma unroll
    for (int q = 0; q < Q; ++q) tv[q] = 0.f;
    for (int r = nk; r < NB; ++r) {
      const float v = b[r];
      const float* w = w_s + r * (C + 1) + lane;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane + 32 * q < C) tv[q] = fmaf(v, w[32 * q], tv[q]);
    }
  }
}

// sum_c g[c] * w[r][c] for the row r of w_s (row stride C+1)
__device__ __forceinline__ float row_dot(const float* g, const float* w_s, int r, int C) {
  const float* w = w_s + r * (C + 1);
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(g[c], w[c], acc);
  return acc;
}

// zero the row of triplet t in dst [T, C] (lanes over the row)
template <typename T>
__device__ __forceinline__ void zero_row(T* dst, size_t t, int C, int lane) {
  for (int c = lane; c < C; c += 32) st(dst + t * C + c, 0.f);
}

template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT) triplet_pt_fwd_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, K = p.K, CE = p.CE, TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* w_s = smem;                // [NB][C+1] ws | wt
  float* ptc = w_s + NB * (C + 1);  // [R][TC]
  float* bas = ptc + p.R * TC;      // [TC][NB]
  float* m_s = bas + TC * NB;       // [TC]
  stage_rows(p, p.ws, p.wt, w_s);
  const int chunks = (p.E + CE - 1) / CE;

  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const size_t t0 = (size_t)ch * TC;
    const int cnt = p.Tn - t0 < (size_t)TC ? (int)(p.Tn - t0) : TC;
    __syncthreads();  // the previous chunk is done with the buffers
    load_slab(p, p.pt, t0, cnt, TC, ptc);
    load_mask(p, t0, cnt, TC, m_s);
    __syncthreads();
    form_basis(p, ptc, TC, bas);
    __syncthreads();
    for (int ce = warp; ce < CE; ce += NW) {
      const int e = ch * CE + ce;
      if (e >= p.E) break;
      float acc[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const int tl = ce * K + kk;
        const float m = m_s[tl];
        if (m == 0.f) continue;  // the warp shares the triplet
        float sv[Q], tv[Q];
        row_products<Q, HAS_T>(bas + tl * NB, w_s, p.nk, NB, C, lane, sv, tv);
        const size_t t = t0 + tl;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = lane + 32 * q;
          if (c < C) {
            float prod = ld(p.xg + t * C + c) * sv[q];
            if constexpr (HAS_T) prod *= tv[q];
            acc[q] = fmaf(prod, m, acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        if (c < C) st(p.out + (size_t)e * C + c, acc[q]);
      }
    }
  }
}

// Backward tiles: a batch of BB real triplets; products TE triplets a warp;
// the (a | b) cotangents TE2 triplets x TR rows a thread (TR odd: no bank
// conflicts on the weights' C + 1 stride).
constexpr int BB = 64, TE = 4, TE2 = 4, TR = 3;
constexpr int WINDOW = 1024;  // triplets a block lists at a time

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
// as 0, and the list is walked BB triplets at a time. Per batch: the pt
// columns and a | b (float4 rows); sv, tv, dxg and the cotangents gs, gt of
// sv, tv (a warp per TE triplets, lanes over the channels, each weight
// loaded once for the warp's triplets); the block's dws | dwt (each entry
// owned by one thread, a row block of up to WTM rows kept in registers
// over the batch and read with float4 loads); with DPT, da | db = gs @
// ws^T | gt @ wt^T as TE2 x TR register tiles (over a | b, dead by then)
// and the adjoint of the assembly, a dpt column per triplet. Every sum
// keeps the order of the masked walk over the same chunks: sv, tv and da |
// db over the rows / channels from 0, dws | dwt over the block's real
// triplets in triplet order.
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

template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT) triplet_pt_bwd2_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, nk = p.nk, K = p.K, CE = p.CE, TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const bool has_u45 = p.u4 != nullptr || p.u5 != nullptr;
  float* w_s = smem;                        // [NB][C+1] ws | wt
  float* u_s = w_s + NB * (C + 1);          // [NB][C+1] u4 | u5 (zeros where absent)
  float* dW_s = u_s + NB * (C + 1);         // [NB][C] wsb | wtb of this block
  float* ptc = dW_s + NB * C;               // [R][TC]
  float* u2c = ptc + p.R * TC;              // [R][TC]
  float* bas = u2c + p.R * TC;              // [TC][NB] a | b, then their cotangents
  float* dbas = bas + TC * NB;              // [TC][NB] da' | db', then theirs
  float* Ps = dbas + TC * NB;               // [TC][C]
  float* Qs = Ps + TC * C;                  // [TC][C]
  float* I_s = Qs + TC * C;                 // [TC][C] ctb terms
  float* Pt = I_s + TC * C;                 // [TC][C] (torsion)
  float* Qt = Pt + (HAS_T ? TC * C : 0);    // [TC][C] (torsion)
  float* m_s = Qt + (HAS_T ? TC * C : 0);   // [TC]
  stage_rows(p, p.ws, p.wt, w_s);
  stage_rows(p, p.u4, p.u5, u_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  const int chunks = (p.E + CE - 1) / CE;

  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const size_t t0 = (size_t)ch * TC;
    const int cnt = p.Tn - t0 < (size_t)TC ? (int)(p.Tn - t0) : TC;
    __syncthreads();
    load_slab(p, p.pt, t0, cnt, TC, ptc);
    load_slab(p, p.u2, t0, cnt, TC, u2c);
    load_mask(p, t0, cnt, TC, m_s);
    __syncthreads();
    form_basis(p, ptc, TC, bas);
    form_tangent(p, ptc, u2c, TC, dbas);
    __syncthreads();
    for (int tl = warp; tl < cnt; tl += NW) {
      const size_t t = t0 + tl;
      const float m = m_s[tl];
      if (m == 0.f) {
        zero_row(p.dxg, t, C, lane);
        continue;
      }
      float sv[Q], tv[Q], dsv[Q], dtv[Q];
      row_products<Q, HAS_T>(bas + tl * NB, w_s, nk, NB, C, lane, sv, tv);
      row_products<Q, HAS_T>(dbas + tl * NB, w_s, nk, NB, C, lane, dsv, dtv);
      if (has_u45) {
        float a4[Q], a5[Q];
        row_products<Q, HAS_T>(bas + tl * NB, u_s, nk, NB, C, lane, a4, a5);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          dsv[q] += a4[q];
          if constexpr (HAS_T) dtv[q] += a5[q];
        }
      }
      const size_t e = t / K;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        if (c < C) {
          const float go = p.ct[e * C + c] * m;
          const float x = ld(p.xg + t * C + c);
          const float u1 = p.u1 != nullptr ? ld(p.u1 + t * C + c) : 0.f;
          float xb, ps, qs, integ;
          if constexpr (HAS_T) {
            qs = go * (x * tv[q]);
            ps = go * fmaf(u1, tv[q], x * dtv[q]);
            Pt[tl * C + c] = go * fmaf(u1, sv[q], x * dsv[q]);
            Qt[tl * C + c] = go * (x * sv[q]);
            xb = go * fmaf(dsv[q], tv[q], sv[q] * dtv[q]);
            integ = fmaf(fmaf(u1, sv[q], x * dsv[q]), tv[q], (x * sv[q]) * dtv[q]);
          } else {
            qs = go * x;
            ps = go * u1;
            xb = go * dsv[q];
            integ = fmaf(u1, sv[q], x * dsv[q]);
          }
          st(p.dxg + t * C + c, xb);
          Ps[tl * C + c] = ps;
          Qs[tl * C + c] = qs;
          I_s[tl * C + c] = integ * m;
        }
      }
    }
    __syncthreads();
    // wsb | wtb: a^T P + da'^T Q | b^T P + db'^T Q, triplets in order
    for (int x = tid; x < NB * C; x += NT) {
      const int r = x / C, c = x % C;
      const bool sr = !HAS_T || r < nk;
      const float* P = sr ? Ps : Pt;
      const float* Qv = sr ? Qs : Qt;
      float acc = dW_s[x];
      for (int tl = 0; tl < cnt; ++tl) {
        if (m_s[tl] != 0.f) {
          acc = fmaf(bas[tl * NB + r], P[tl * C + c], acc);
          acc = fmaf(dbas[tl * NB + r], Qv[tl * C + c], acc);
        }
      }
      dW_s[x] = acc;
    }
    // ctb[e] = sum over the edge's K triplets, in order
    for (int x = tid; x < CE * C; x += NT) {
      const int ce = x / C, c = x % C;
      const int e = ch * CE + ce;
      if (e >= p.E) continue;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const int tl = ce * K + kk;
        if (m_s[tl] != 0.f) acc += I_s[tl * C + c];
      }
      p.ctb[(size_t)e * C + c] = acc;
    }
    __syncthreads();
    // cotangents of a | b (P @ w^T + Q @ u^T) -> bas, of da' | db' (Q @ w^T)
    // -> dbas
    for (int x = tid; x < TC * NB; x += NT) {
      const int tl = x / NB, r = x % NB;
      float ga = 0.f, gd = 0.f;
      if (tl < cnt && m_s[tl] != 0.f) {
        const bool sr = !HAS_T || r < nk;
        const float* P = (sr ? Ps : Pt) + tl * C;
        const float* Qv = (sr ? Qs : Qt) + tl * C;
        ga = row_dot(P, w_s, r, C);
        gd = row_dot(Qv, w_s, r, C);
        if (has_u45) ga += row_dot(Qv, u_s, r, C);
      }
      bas[x] = ga;
      dbas[x] = gd;
    }
    __syncthreads();
    // ptb: through the assembly against pt and, for the tangent, against u2
    for (int x = tid; x < p.R * TC; x += NT) {
      const int r = x / TC, tl = x % TC;
      if (tl >= cnt) continue;
      float v = 0.f;
      if (m_s[tl] != 0.f) {
        v = basis_adjoint(p, bas + tl * NB, ptc, r, tl, TC);
        if (p.u2 != nullptr) v += basis_adjoint(p, dbas + tl * NB, u2c, r, tl, TC);
      }
      st(p.dpt + (size_t)r * p.Tn + t0 + tl, v);
    }
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

int grid_of(int work, int cap) { return work < cap ? work : cap; }

// edges per chunk: TC = CE * K triplets, about `triplets` of them
int chunk_edges(int K, int triplets) { return K >= triplets ? 1 : triplets / K; }

constexpr int FWD_TRIPLETS = 128, BWD_TRIPLETS = 32, BWD2_TRIPLETS = 16;

template <typename T, int Q, bool HAS_T>
int fwd_q(Params<T> p, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, FWD_TRIPLETS);
  const size_t TC = (size_t)p.CE * p.K;
  const size_t floats = (size_t)p.NB * (p.C + 1) + p.R * TC + TC * p.NB + TC;
  const int chunks = (p.E + p.CE - 1) / p.CE;
  return launch(triplet_pt_fwd_kernel<T, Q, HAS_T>, grid_of(chunks, FWD_GRID), NT,
                floats * sizeof(float), strm, p);
}

// The backward of one instance: its grid (as many blocks as the card holds
// at once: SMs x the occupancy of this kernel at its shared memory, at most
// one a chunk; it depends only on the shapes and the card) in *blocks, and
// the launch unless only the grid is asked for (run false).
template <typename T, int Q, bool HAS_T, bool DPT>
int bwd_q(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, BWD_TRIPLETS);
  const size_t smem = bwd_layout<T, HAS_T>(p, p.CE * p.K).total * sizeof(float);
  auto kern = triplet_pt_bwd_kernel<T, Q, HAS_T, DPT>;
  int rc = check_smem(smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (p.E + p.CE - 1) / p.CE;
  *blocks = grid_of(chunks, sms * (per_sm > 0 ? per_sm : 1));
  if (!run) return 0;
  kern<<<*blocks, NT, smem, strm>>>(p);
  return cudaGetLastError();
}

template <typename T, int Q, bool HAS_T>
int bwd2_q(Params<T> p, int blocks, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, BWD2_TRIPLETS);
  const size_t TC = (size_t)p.CE * p.K;
  const size_t floats = 2 * (size_t)p.NB * (p.C + 1) + (size_t)p.NB * p.C + 2 * p.R * TC +
                        2 * TC * p.NB + (HAS_T ? 5 : 3) * TC * p.C + TC;
  return launch(triplet_pt_bwd2_kernel<T, Q, HAS_T>, blocks, NT, floats * sizeof(float), strm,
                p);
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
int bwd2_c(Params<T> p, int blocks, cudaStream_t strm) {
  const bool t = p.ntk > 0;
  if (p.C <= 64) return t ? bwd2_q<T, 2, true>(p, blocks, strm) : bwd2_q<T, 2, false>(p, blocks, strm);
  if (p.C <= 128) return t ? bwd2_q<T, 4, true>(p, blocks, strm) : bwd2_q<T, 4, false>(p, blocks, strm);
  return ERR_SHAPE;
}

bool bad_shape(int E, int K, int C, int n, int k) {
  return E <= 0 || K <= 0 || C <= 0 || C > 128 || n <= 0 || k <= 0 ||
         (long long)E * K >= (1LL << 31);
}

}  // namespace

extern "C" {

// Number of blocks (rows of the partial-sum scratch) of the backward
// (second_order = 0; with dpt or not, on this card) or of the second-order
// pass, at E edges of K triplets; ERR_SHAPE / ERR_SMEM for a shape the
// kernels do not take, -1 for a CUDA error.
int triplet_pt_blocks(int E, int K, int C, int n, int k, int has_t, int bf16, int dpt,
                      int second_order) {
  if (bad_shape(E, K, C, n, k)) return ERR_SHAPE;
  if (second_order) {
    const int CE = chunk_edges(K, BWD2_TRIPLETS);
    return grid_of((E + CE - 1) / CE, BWD2_GRID);
  }
  int blocks = -1, rc;
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, E, K, C, n,
                                        k, has_t);
    rc = bwd_c(p, dpt != 0, &blocks, false, nullptr);
  } else {
    auto p = make_params<float>(nullptr, nullptr, nullptr, nullptr, nullptr, E, K, C, n, k,
                                has_t);
    rc = bwd_c(p, dpt != 0, &blocks, false, nullptr);
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
  const int blocks = triplet_pt_blocks(E, K, C, n, k, has_t, bf16, 1, 1);
  int rc, NB;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.u2 = static_cast<const B*>(u2);
    p.u4 = u4; p.u5 = has_t ? u5 : nullptr;
    p.dxg = static_cast<B*>(xb); p.dpt = static_cast<B*>(ptb); p.ctb = ctb;
    p.partial = partial;
    NB = p.NB;
    rc = bwd2_c(p, blocks, strm);
  } else {
    auto p = make_params<float>(xg, pt, ws, wt, m, E, K, C, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.u2 = static_cast<const float*>(u2);
    p.u4 = u4; p.u5 = has_t ? u5 : nullptr;
    p.dxg = static_cast<float*>(xb); p.dpt = static_cast<float*>(ptb); p.ctb = ctb;
    p.partial = partial;
    NB = p.NB;
    rc = bwd2_c(p, blocks, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, NB * C, dw, strm);
}

}  // extern "C"
