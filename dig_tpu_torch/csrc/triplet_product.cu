// Fused triplet interaction on the [N, K] neighbour-table layout (SphereNet
// and, without torsion, DimeNet++): forward, backward and second-order
// backward, for NVIDIA Hopper (sm_90a). Plain C interface, loaded through
// ctypes by dig_tpu_torch/ops/triplet_product.py.
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_triplet.py:
// _run_fwd (pl.pallas_call at :263, _fwd_kernel), _run_bwd (:312,
// _bwd_kernel) and _run_bwd2 (:386, _bwd2_kernel).
//
//   out[e] = sum_k m[e,k] * xg[t] * s[t] * tv[t],  t = e*K + k
//   s = sbf[t] @ ws,  tv = tbf[t] @ wt  (tv = 1 without torsion)
//
// xg [T, C], sbf [T, S1], tbf [T, S2], mask [E, K] share one type (float32
// or bf16); ws [S1, C] and wt [S2, C] arrive as float32 values of the
// caller's weights. Every product and sum is float32; each output is
// rounded to its type once.
//
// Backward (per triplet, go = ct[e] m): dxg = go s tv, gs = go xg tv and
// gt = go xg s are the cotangents of s and tv; dsbf = gs @ ws^T and
// dtbf = gt @ wt^T (only with basis gradients); dws = sum_t sbf^T gs and
// dwt = sum_t tbf^T gt. Second order, from the cotangents u1..u5 of
// (dxg, dsbf, dtbf, dws, dwt), with P = u2 @ ws + sbf @ u4 and
// Q = u3 @ wt + tbf @ u5 (the algebra of _bwd2_kernel's docstring):
//   xb  = go (tv P + s Q)
//   sb  = A @ ws^T + (go xg tv) @ u4^T,    A = go (tv u1 + xg Q)
//   tb  = B @ wt^T + (go xg s) @ u5^T,     B = go (s u1 + xg P)
//   wsb = sum_t sbf^T A + u2^T (go xg tv), wtb likewise with B, u3, go xg s
//   ctb[e] = sum_k m (u1 s tv + xg (tv P + s Q))
// Without torsion tv = 1 and Q = 0. A triplet with m = 0 contributes
// nothing to any output and its rows of dxg, dsbf, dtbf, xb, sb and tb are
// 0: the kernels skip it (the inputs may hold garbage there, as
// expand_kj_raw's rows do) and write zeros.
//
// What bounds it on this card. Per real triplet (m != 0) the forward does
// 2 C (S1 + S2) flops for the two basis products and 3 C for the triple
// product; it must read that triplet's xg, sbf and tbf rows and write
// out [E, C]. At SphereNet's force-bench widths on the unblocked layout
// (E = 44,544, K = 16, C = 64, S1 = 18, S2 = 54, bf16; 304,774 of the
// 712,704 triplet rows real in chip_smoke.py's batch) that is 2.87 GFLOP
// against 90.0 MB: the bytes bound it (0.027 ms at 3.35 TB/s against
// 0.003 ms of bf16 tensor-core work). The backward reads the same rows and
// writes dxg [T, C] and, with basis gradients, dsbf and dtbf in full: 8.5
// GFLOP and 281 MB, 0.084 ms, the bytes again. The second order reads
// twice the rows (u1, u2, u3 beside xg, sbf, tbf) and writes xb, sb, tb in
// full: 14.4 GFLOP and 370 MB, 0.110 ms. chip_smoke.py counts both bounds
// from its inputs.
//
// What the design does about it (simple and right first; wgmma for the
// basis products and TMA are later work):
//  - Every input row is read once per pass and every output written once;
//    masked triplets are skipped (warp-uniform branch) and their output
//    rows written as zeros. T is not padded: the kernels bound every index.
//  - ws | wt (and u4 | u5) are staged in shared memory, rows of C+1 floats,
//    so reads with c across lanes (the products) and with the basis row
//    across lanes (dsbf, sb) are free of bank conflicts.
//  - Forward: a warp per edge, lanes over C (Q channels a lane), k walked in
//    order, float32 registers; the warp stages each triplet's basis row in
//    shared memory. Blocks walk the edges grid-stride.
//  - Backward and second order: a block takes chunks of CE whole edges
//    (TC = CE K triplets), a warp per triplet forms the per-channel
//    cotangents into shared memory; then each thread owns entries of the
//    weight cotangents (dws | dwt, wsb | wtb) and adds the chunk's triplets
//    in order, and the second order's ctb sums each edge's K triplets in
//    order. The per-block weight sums go to a [blocks, ...] scratch and
//    sum_partials_kernel adds them in a fixed order. The block count
//    depends only on the shapes, and no atomics are used: repeated calls
//    give the same bits.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int FWD_GRID = 1056; // forward: at most 8 blocks per SM
constexpr int BWD_GRID = 264;  // backward passes: a fixed block count

template <typename T>
struct Params {
  const T* xg;      // [T, C]
  const T* sbf;     // [T, S1]
  const T* tbf;     // [T, S2] (torsion only)
  const float* ws;  // [S1, C]
  const float* wt;  // [S2, C] (torsion only)
  const T* mask;    // [E, K]
  const float* ct;  // [E, C] (backward, second order)
  const T* u1;      // [T, C] or null: cotangent of dxg
  const T* u2;      // [T, S1] or null: cotangent of dsbf
  const T* u3;      // [T, S2] or null: cotangent of dtbf
  const float* u4;  // [S1, C] or null: cotangent of dws
  const float* u5;  // [S2, C] or null: cotangent of dwt
  T* out;           // [E, C] (forward)
  T* dxg;           // [T, C] (backward: dxg; second order: xb)
  T* dsbf;          // [T, S1] (backward with basis gradients: dsbf; second order: sb)
  T* dtbf;          // [T, S2] (likewise dtbf; tb)
  float* ctb;       // [E, C] (second order)
  float* partial;   // [blocks, NB * C]
  int E, K, C, S1, S2, NB, CE;
};

// rows [0, S1) of w_s <- src1 [S1, C], rows [S1, NB) <- src2 [S2, C], row
// stride C+1 floats.
template <typename T>
__device__ void stage_rows(const Params<T>& p, const float* src1, const float* src2,
                           float* w_s) {
  const int C = p.C;
  for (int x = threadIdx.x; x < p.NB * C; x += NT) {
    const int r = x / C, c = x % C;
    w_s[r * (C + 1) + c] = r < p.S1 ? src1[x] : src2[x - p.S1 * C];
  }
}

// b[0, S1) <- a1[t, :], b[S1, NB) <- a2[t, :] (zeros where a pointer is null)
template <typename T>
__device__ __forceinline__ void load_row(const Params<T>& p, const T* a1, const T* a2,
                                         size_t t, float* b, int lane) {
  for (int r = lane; r < p.NB; r += 32) {
    float v = 0.f;
    if (r < p.S1) {
      if (a1 != nullptr) v = ld(a1 + t * p.S1 + r);
    } else if (a2 != nullptr) {
      v = ld(a2 + t * p.S2 + (r - p.S1));
    }
    b[r] = v;
  }
}

// sv[q] = b[0:S1] @ w[0:S1, c_q], tv[q] = b[S1:NB] @ w[S1:NB, c_q]
// (c_q = lane + 32 q; tv untouched without torsion)
template <int Q, bool HAS_T>
__device__ __forceinline__ void row_products(const float* b, const float* w_s, int S1, int NB,
                                             int C, int lane, float (&sv)[Q], float (&tv)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) sv[q] = 0.f;
  for (int r = 0; r < S1; ++r) {
    const float v = b[r];
    const float* w = w_s + r * (C + 1) + lane;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (lane + 32 * q < C) sv[q] = fmaf(v, w[32 * q], sv[q]);
  }
  if constexpr (HAS_T) {
#pragma unroll
    for (int q = 0; q < Q; ++q) tv[q] = 0.f;
    for (int r = S1; r < NB; ++r) {
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

template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT) triplet_product_fwd_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, K = p.K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* w_s = smem;                                 // [NB][C+1]
  float* bas = w_s + NB * (C + 1) + warp * NB;       // [NB] per warp
  stage_rows(p, p.ws, p.wt, w_s);
  __syncthreads();

  for (int e = blockIdx.x * NW + warp; e < p.E; e += gridDim.x * NW) {
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.f;
    for (int k = 0; k < K; ++k) {
      const size_t t = (size_t)e * K + k;
      const float m = ld(p.mask + t);
      if (m == 0.f) continue;  // the warp shares t
      load_row(p, p.sbf, p.tbf, t, bas, lane);
      __syncwarp();
      float sv[Q], tv[Q];
      row_products<Q, HAS_T>(bas, w_s, p.S1, NB, C, lane, sv, tv);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        if (c < C) {
          float prod = ld(p.xg + t * C + c) * sv[q];
          if constexpr (HAS_T) prod *= tv[q];
          acc[q] = fmaf(prod, m, acc[q]);
        }
      }
      __syncwarp();  // bas is rewritten by the next triplet
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      if (c < C) st(p.out + (size_t)e * C + c, acc[q]);
    }
  }
}

// zero the rows of triplet t in dst [T, width] (lanes over the row)
template <typename T>
__device__ __forceinline__ void zero_row(T* dst, size_t t, int width, int lane) {
  if (dst == nullptr) return;
  for (int r = lane; r < width; r += 32) st(dst + t * width + r, 0.f);
}

template <typename T, int Q, bool HAS_T, bool BASIS>
__global__ void __launch_bounds__(NT) triplet_product_bwd_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, S1 = p.S1, K = p.K;
  const int TC = p.CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  float* w_s = smem;                   // [NB][C+1]
  float* dW_s = w_s + NB * (C + 1);    // [NB][C] dws | dwt of this block
  float* bas = dW_s + NB * C;          // [TC][NB] sbf | tbf rows
  float* gs = bas + TC * NB;           // [TC][C] cotangent of s
  float* gt = gs + TC * C;             // [TC][C] cotangent of tv (torsion)
  float* m_s = gt + (HAS_T ? TC * C : 0);  // [TC]
  stage_rows(p, p.ws, p.wt, w_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  const size_t Tn = (size_t)p.E * K;
  const int chunks = (p.E + p.CE - 1) / p.CE;

  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const size_t t0 = (size_t)ch * TC;
    __syncthreads();  // the previous chunk's sums are done with the buffers
    for (int tl = warp; tl < TC; tl += NW) {
      const size_t t = t0 + tl;
      const float m = t < Tn ? ld(p.mask + t) : 0.f;
      if (lane == 0) m_s[tl] = m;
      if (t >= Tn) continue;
      if (m == 0.f) {
        zero_row(p.dxg, t, C, lane);
        if constexpr (BASIS) {
          zero_row(p.dsbf, t, S1, lane);
          if constexpr (HAS_T) zero_row(p.dtbf, t, p.S2, lane);
        }
        continue;
      }
      float* b = bas + tl * NB;
      load_row(p, p.sbf, p.tbf, t, b, lane);
      __syncwarp();
      float sv[Q], tv[Q];
      row_products<Q, HAS_T>(b, w_s, S1, NB, C, lane, sv, tv);
      const size_t e = t / K;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        if (c < C) {
          const float go = p.ct[e * C + c] * m;
          const float x = ld(p.xg + t * C + c);
          float d = go * sv[q], g1 = go * x;
          if constexpr (HAS_T) {
            d *= tv[q];
            gt[tl * C + c] = g1 * sv[q];
            g1 *= tv[q];
          }
          st(p.dxg + t * C + c, d);
          gs[tl * C + c] = g1;
        }
      }
      __syncwarp();
      if constexpr (BASIS) {
        // dsbf = gs @ ws^T, dtbf = gt @ wt^T: lanes over the basis row
        for (int r = lane; r < NB; r += 32) {
          if (r < S1) {
            st(p.dsbf + t * S1 + r, row_dot(gs + tl * C, w_s, r, C));
          } else if constexpr (HAS_T) {
            st(p.dtbf + t * p.S2 + (r - S1), row_dot(gt + tl * C, w_s, r, C));
          }
        }
      }
    }
    __syncthreads();
    // dws | dwt: each (row, c) entry owned by one thread, triplets in order
    const int cnt = Tn - t0 < (size_t)TC ? (int)(Tn - t0) : TC;
    for (int x = tid; x < NB * C; x += NT) {
      const int r = x / C, c = x % C;
      const float* src = (HAS_T && r >= S1) ? gt : gs;
      float acc = dW_s[x];
      for (int tl = 0; tl < cnt; ++tl)
        if (m_s[tl] != 0.f) acc = fmaf(bas[tl * NB + r], src[tl * C + c], acc);
      dW_s[x] = acc;
    }
  }
  __syncthreads();
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

// Second order. Per real triplet and channel: A and B as in the header
// (B torsion only), G_t = go xg tv (the cotangent term of u4's product),
// G_s = go xg s (u5's), I = m (u1 s tv + xg (tv P + s Q)).
template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT) triplet_product_bwd2_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, S1 = p.S1, K = p.K, CE = p.CE;
  const int TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const bool has_u45 = p.u4 != nullptr || p.u5 != nullptr;
  float* w_s = smem;                    // [NB][C+1] ws | wt
  float* u_s = w_s + NB * (C + 1);      // [NB][C+1] u4 | u5 (zeros where absent)
  float* dW_s = u_s + NB * (C + 1);     // [NB][C] wsb | wtb of this block
  float* bas = dW_s + NB * C;           // [TC][NB] sbf | tbf rows
  float* ubas = bas + TC * NB;          // [TC][NB] u2 | u3 rows
  float* A_s = ubas + TC * NB;          // [TC][C]
  float* Gt_s = A_s + TC * C;           // [TC][C]
  float* I_s = Gt_s + TC * C;           // [TC][C]
  float* B_s = I_s + TC * C;            // [TC][C] (torsion)
  float* Gs_s = B_s + (HAS_T ? TC * C : 0);  // [TC][C] (torsion)
  float* m_s = Gs_s + (HAS_T ? TC * C : 0);  // [TC]
  stage_rows(p, p.ws, p.wt, w_s);
  for (int x = tid; x < NB * C; x += NT) {
    const int r = x / C, c = x % C;
    const float* u = r < S1 ? p.u4 : p.u5;
    const int ro = r < S1 ? r : r - S1;
    u_s[r * (C + 1) + c] = u != nullptr ? u[ro * C + c] : 0.f;
    dW_s[x] = 0.f;
  }
  const size_t Tn = (size_t)p.E * K;
  const int chunks = (p.E + CE - 1) / CE;

  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const size_t t0 = (size_t)ch * TC;
    const int e0 = ch * CE;
    __syncthreads();
    for (int tl = warp; tl < TC; tl += NW) {
      const size_t t = t0 + tl;
      const float m = t < Tn ? ld(p.mask + t) : 0.f;
      if (lane == 0) m_s[tl] = m;
      if (t >= Tn) continue;
      if (m == 0.f) {
        zero_row(p.dxg, t, C, lane);
        zero_row(p.dsbf, t, S1, lane);
        if constexpr (HAS_T) zero_row(p.dtbf, t, p.S2, lane);
        continue;
      }
      float* b = bas + tl * NB;
      float* ub = ubas + tl * NB;
      load_row(p, p.sbf, p.tbf, t, b, lane);
      load_row(p, p.u2, p.u3, t, ub, lane);
      __syncwarp();
      float sv[Q], tv[Q], P[Q], Qv[Q], a4[Q], a5[Q];
      row_products<Q, HAS_T>(b, w_s, S1, NB, C, lane, sv, tv);
      row_products<Q, HAS_T>(ub, w_s, S1, NB, C, lane, P, Qv);  // u2 @ ws, u3 @ wt
      if (has_u45) {
        row_products<Q, HAS_T>(b, u_s, S1, NB, C, lane, a4, a5);  // sbf @ u4, tbf @ u5
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          P[q] += a4[q];
          if constexpr (HAS_T) Qv[q] += a5[q];
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
          float core, A, Gt, integ;
          if constexpr (HAS_T) {
            core = tv[q] * P[q] + sv[q] * Qv[q];
            A = go * (tv[q] * u1 + x * Qv[q]);
            B_s[tl * C + c] = go * (sv[q] * u1 + x * P[q]);
            Gs_s[tl * C + c] = (go * x) * sv[q];
            Gt = (go * x) * tv[q];
            integ = (u1 * sv[q]) * tv[q] + x * core;
          } else {
            core = P[q];
            A = go * u1;
            Gt = go * x;
            integ = u1 * sv[q] + x * core;
          }
          st(p.dxg + t * C + c, go * core);
          A_s[tl * C + c] = A;
          Gt_s[tl * C + c] = Gt;
          I_s[tl * C + c] = integ * m;
        }
      }
      __syncwarp();
      // sb = A @ ws^T + Gt @ u4^T, tb = B @ wt^T + Gs @ u5^T
      for (int r = lane; r < NB; r += 32) {
        if (r < S1) {
          float v = row_dot(A_s + tl * C, w_s, r, C);
          if (p.u4 != nullptr) v += row_dot(Gt_s + tl * C, u_s, r, C);
          st(p.dsbf + t * S1 + r, v);
        } else if constexpr (HAS_T) {
          float v = row_dot(B_s + tl * C, w_s, r, C);
          if (p.u5 != nullptr) v += row_dot(Gs_s + tl * C, u_s, r, C);
          st(p.dtbf + t * p.S2 + (r - S1), v);
        }
      }
    }
    __syncthreads();
    const int cnt = Tn - t0 < (size_t)TC ? (int)(Tn - t0) : TC;
    // wsb | wtb: sbf^T A + u2^T Gt | tbf^T B + u3^T Gs, triplets in order
    for (int x = tid; x < NB * C; x += NT) {
      const int r = x / C, c = x % C;
      const bool sr = !HAS_T || r < S1;
      const float* P1 = sr ? A_s : B_s;
      const float* P2 = sr ? Gt_s : Gs_s;
      float acc = dW_s[x];
      for (int tl = 0; tl < cnt; ++tl) {
        if (m_s[tl] != 0.f) {
          acc = fmaf(bas[tl * NB + r], P1[tl * C + c], acc);
          acc = fmaf(ubas[tl * NB + r], P2[tl * C + c], acc);
        }
      }
      dW_s[x] = acc;
    }
    // ctb[e] = sum over the edge's K triplets, in order
    for (int x = tid; x < CE * C; x += NT) {
      const int ce = x / C, c = x % C;
      const int e = e0 + ce;
      if (e >= p.E) continue;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const int tl = ce * K + k;
        if (m_s[tl] != 0.f) acc += I_s[tl * C + c];
      }
      p.ctb[(size_t)e * C + c] = acc;
    }
  }
  __syncthreads();
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

template <typename T>
Params<T> make_params(const void* xg, const void* sbf, const void* tbf, const float* ws,
                      const float* wt, const void* mask, int E, int K, int C, int S1, int S2) {
  Params<T> p{};
  p.xg = static_cast<const T*>(xg);
  p.sbf = static_cast<const T*>(sbf);
  p.tbf = static_cast<const T*>(tbf);
  p.ws = ws;
  p.wt = wt;
  p.mask = static_cast<const T*>(mask);
  p.E = E; p.K = K; p.C = C; p.S1 = S1; p.S2 = S2;
  p.NB = S1 + S2;
  return p;
}

int grid_of(int work, int cap) { return work < cap ? work : cap; }

// edges per chunk of the backward passes: TC = CE * K triplets, about 32
// (16 for the second order, which keeps more per triplet)
int chunk_edges(int K, int triplets) { return K >= triplets ? 1 : triplets / K; }

template <typename T, int Q, bool HAS_T>
int fwd_q(Params<T> p, cudaStream_t strm) {
  const size_t smem = ((size_t)p.NB * (p.C + 1) + (size_t)NW * p.NB) * sizeof(float);
  return launch(triplet_product_fwd_kernel<T, Q, HAS_T>, grid_of((p.E + NW - 1) / NW, FWD_GRID),
                NT, smem, strm, p);
}

template <typename T, int Q, bool HAS_T, bool BASIS>
int bwd_q(Params<T> p, int blocks, cudaStream_t strm) {
  const size_t TC = (size_t)p.CE * p.K;
  const size_t floats = (size_t)p.NB * (p.C + 1) + (size_t)p.NB * p.C + TC * p.NB +
                        (HAS_T ? 2 : 1) * TC * p.C + TC;
  return launch(triplet_product_bwd_kernel<T, Q, HAS_T, BASIS>, blocks, NT,
                floats * sizeof(float), strm, p);
}

template <typename T, int Q, bool HAS_T>
int bwd2_q(Params<T> p, int blocks, cudaStream_t strm) {
  const size_t TC = (size_t)p.CE * p.K;
  const size_t floats = 2 * (size_t)p.NB * (p.C + 1) + (size_t)p.NB * p.C + 2 * TC * p.NB +
                        (HAS_T ? 5 : 3) * TC * p.C + TC;
  return launch(triplet_product_bwd2_kernel<T, Q, HAS_T>, blocks, NT, floats * sizeof(float),
                strm, p);
}

// Q = channels a lane: 2 for C <= 64, 4 for C <= 128
template <typename T>
int fwd_c(Params<T> p, cudaStream_t strm) {
  const bool t = p.S2 > 0;
  if (p.C <= 64) return t ? fwd_q<T, 2, true>(p, strm) : fwd_q<T, 2, false>(p, strm);
  if (p.C <= 128) return t ? fwd_q<T, 4, true>(p, strm) : fwd_q<T, 4, false>(p, strm);
  return ERR_SHAPE;
}

template <typename T, int Q>
int bwd_b(Params<T> p, int basis, int blocks, cudaStream_t strm) {
  if (p.S2 > 0) {
    return basis ? bwd_q<T, Q, true, true>(p, blocks, strm)
                 : bwd_q<T, Q, true, false>(p, blocks, strm);
  }
  return basis ? bwd_q<T, Q, false, true>(p, blocks, strm)
               : bwd_q<T, Q, false, false>(p, blocks, strm);
}

template <typename T>
int bwd_c(Params<T> p, int basis, int blocks, cudaStream_t strm) {
  if (p.C <= 64) return bwd_b<T, 2>(p, basis, blocks, strm);
  if (p.C <= 128) return bwd_b<T, 4>(p, basis, blocks, strm);
  return ERR_SHAPE;
}

template <typename T>
int bwd2_c(Params<T> p, int blocks, cudaStream_t strm) {
  const bool t = p.S2 > 0;
  if (p.C <= 64) return t ? bwd2_q<T, 2, true>(p, blocks, strm) : bwd2_q<T, 2, false>(p, blocks, strm);
  if (p.C <= 128) return t ? bwd2_q<T, 4, true>(p, blocks, strm) : bwd2_q<T, 4, false>(p, blocks, strm);
  return ERR_SHAPE;
}

bool bad_shape(int E, int K, int C, int S1, int S2) {
  return E <= 0 || K <= 0 || C <= 0 || C > 128 || S1 <= 0 || S2 < 0;
}

}  // namespace

extern "C" {

// Number of blocks (rows of the partial-sum scratch) of the backward
// (second_order = 0) or second-order pass at E edges of K triplets.
int triplet_product_blocks(int E, int K, int second_order) {
  const int CE = chunk_edges(K, second_order ? 16 : 32);
  return grid_of((E + CE - 1) / CE, BWD_GRID);
}

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM. xg, sbf, tbf, mask
// and out share one type: bf16 when bf16 != 0, float32 otherwise. tbf and
// wt are null (S2 = 0) without torsion.
int triplet_product_fwd(const void* xg, const void* sbf, const void* tbf, const float* ws,
                        const float* wt, const void* mask, void* out, int E, int K, int C, int S1,
                        int S2, int bf16, void* stream) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.out = static_cast<__nv_bfloat16*>(out);
    return fwd_c(p, strm);
  }
  auto p = make_params<float>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
  p.out = static_cast<float*>(out);
  return fwd_c(p, strm);
}

// ct float32 [E, C]; dxg [T, C], dsbf [T, S1], dtbf [T, S2] in the type of
// xg (dsbf and dtbf written only when basis != 0); partial: [blocks,
// (S1 + S2) * C] scratch with blocks = triplet_product_blocks(E, K, 0);
// dw [(S1 + S2) * C] receives dws | dwt.
int triplet_product_bwd(const void* xg, const void* sbf, const void* tbf, const float* ws,
                        const float* wt, const void* mask, const float* ct, void* dxg, void* dsbf,
                        void* dtbf, float* partial, float* dw, int E, int K, int C, int S1, int S2,
                        int bf16, int basis, void* stream) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int blocks = triplet_product_blocks(E, K, 0);
  const int CE = chunk_edges(K, 32);
  int rc;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.dxg = static_cast<B*>(dxg); p.dsbf = static_cast<B*>(dsbf);
    p.dtbf = static_cast<B*>(dtbf); p.partial = partial; p.CE = CE;
    rc = bwd_c(p, basis, blocks, strm);
  } else {
    auto p = make_params<float>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.dxg = static_cast<float*>(dxg); p.dsbf = static_cast<float*>(dsbf);
    p.dtbf = static_cast<float*>(dtbf); p.partial = partial; p.CE = CE;
    rc = bwd_c(p, basis, blocks, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, (S1 + S2) * C, dw, strm);
}

// Second order. ct float32 [E, C]; u1 [T, C], u2 [T, S1], u3 [T, S2] in
// the type of xg and u4 [S1, C], u5 [S2, C] float32, each null when absent.
// xb [T, C], sb [T, S1], tb [T, S2] in the type of xg; ctb float32 [E, C];
// every element written. partial: [blocks, (S1 + S2) * C] with blocks =
// triplet_product_blocks(E, K, 1); dw receives wsb | wtb.
int triplet_product_bwd2(const void* xg, const void* sbf, const void* tbf, const float* ws,
                         const float* wt, const void* mask, const float* ct, const void* u1,
                         const void* u2, const void* u3, const float* u4, const float* u5,
                         void* xb, void* sb, void* tb, float* ctb, float* partial, float* dw,
                         int E, int K, int C, int S1, int S2, int bf16, void* stream) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int blocks = triplet_product_blocks(E, K, 1);
  const int CE = chunk_edges(K, 16);
  int rc;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.u2 = static_cast<const B*>(u2);
    p.u3 = static_cast<const B*>(u3); p.u4 = u4; p.u5 = u5;
    p.dxg = static_cast<B*>(xb); p.dsbf = static_cast<B*>(sb); p.dtbf = static_cast<B*>(tb);
    p.ctb = ctb; p.partial = partial; p.CE = CE;
    rc = bwd2_c(p, blocks, strm);
  } else {
    auto p = make_params<float>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.u2 = static_cast<const float*>(u2);
    p.u3 = static_cast<const float*>(u3); p.u4 = u4; p.u5 = u5;
    p.dxg = static_cast<float*>(xb); p.dsbf = static_cast<float*>(sb);
    p.dtbf = static_cast<float*>(tb); p.ctb = ctb; p.partial = partial; p.CE = CE;
    rc = bwd2_c(p, blocks, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, (S1 + S2) * C, dw, strm);
}

}  // extern "C"
