// Slot-resident fused triplet interaction (SphereNet / DimeNet++), forward,
// backward and second-order backward, for NVIDIA Hopper (sm_90a). Plain C
// interface, loaded through ctypes by dig_tpu_torch/ops/triplet_slot.py.
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_triplet_slot.py:
// _run_fwd (pl.pallas_call at :429), _run_bwd (:458) and _run_bwd2 (:501).
//
//   out[e] = sum_s m2T[s,e] * x[(slot(e)*A + lj[e])*K + s] * sv * tv
//   sv = sbf[e,s] @ ws,  sbf[l*k+m] = bt[l*k+m] * y0[l]
//   tv = tbf[e,s] @ wt,  tbf[i]     = yt[i/k] * bt[i % nk]     (has_t only)
//   slot(e) = e / (A*K); bt, y0, yt = rows [0,nk), [nk,nk+n), [nk+n,R) of
//   pt[s, :, e]; nk = n*k, ntk = n*n*k, R = nk + n (+ n*n with has_t).
//
// What bounds it on this card. Per real triplet (m2T != 0) the forward
// costs 2 C (nk + ntk) flops for the two basis products plus a few C for
// the triple product. The bytes it must move are pt's column and the
// gathered x row of each real triplet, m2T and lj in full, and out. At the
// flagship shape (E = 44,544, K = 16, C = 64, n = 3, k = 6, bf16; 276,892
// real triplets gathering 23,217 distinct x rows in chip_smoke.py's batch)
// that is 2.62 GFLOP and 26.9 MB per layer, so the bytes bound it (0.0080
// ms at 3.35 TB/s against 0.0027 ms of bf16 tensor-core work;
// chip_smoke.py recounts both from its inputs). The backward recomputes sv
// and tv and adds the weight-gradient products: 5.25 GFLOP and 29.9 MB
// (the cotangent rows of the edges that own a real triplet in, dx out),
// 0.0089 ms, still bound by the bytes; pt's gradient, when asked for, adds
// 2.6 GFLOP and writes all of dpt (42.8 MB): 72.6 MB, 0.0217 ms. Every
// byte count takes each tensor in the type the function takes or returns
// (bf16 here), as the Pallas calls declare them; the kernels' float32
// outputs, which the wrapper casts back, are this port's staging, not work
// the function needs.
//
// The second-order backward takes the cotangents (u1, u2, u4, u5) of
// (dx, dpt, dws, dwt) as a tangent (dx, dpt, dws, dwt) of the forward and
// returns the gradients (xb, ptb, wsb, wtb, ctb) of <u, backward> with
// respect to (x, pt, ws, wt, ct). Per real triplet, with g = x[row],
// a = sbf, b = tbf, dg = u1[row], da/db the product-rule tangents of
// sbf/tbf from u2, dsv = da@ws + a@u4, dtv = db@wt + b@u5, go = ct[e]*m:
//   ctb[e]   = sum_s m (dg sv tv + g dsv tv + g sv dtv)     (the JVP)
//   xb[row] += go (dsv tv + sv dtv)
//   wsb     += a (x) go (dg tv + g dtv) + da (x) go g tv,   wtb likewise
//   ptb      = the product rule of sbf/tbf applied to the basis cotangents
//              (P @ w^T + Q @ u4^T through pt, Q @ w^T through u2).
// Per real triplet that is about 12 C (nk + ntk) flops (the four basis
// products sv, tv, dsv, dtv, the weight-gradient products and the basis
// cotangents); its bytes are pt's and u2's columns and the x, u1 rows of
// each real triplet, the ct rows of the edges that own one, and xb, ctb
// ([E, C]) and all of ptb ([K, R, E]) out, in the operands' types. One
// layer of the force bench's batch (buckets of 16, 24 and 29 atoms,
// E = 35,488 in all, 297,624 real triplets, bf16) needs 17.0 GFLOP
// (0.017 ms at the bf16 tensor-core peak) and 89.6 MB (0.027 ms at
// 3.35 TB/s): the bytes bound it (chip_smoke.py counts both from its
// inputs).
//
// What the design does about it:
//  - The expand gather x[sender, s] happens in the kernel: nothing of size
//    [T, C] (T = E*K triplets) exists in device memory, only E-sized x and
//    out and the [K, R, E] basis table, each read once per pass.
//  - Triplets with m2T = 0 (padding, k == i, slots beyond the degree)
//    contribute exactly zero to every output and are skipped (warp-uniform
//    branch: a warp shares one edge).
//  - Forward: a block owns 32 consecutive edges and walks s in a loop; the
//    basis rows of the 32 edges for one s are staged in shared memory
//    (coalesced over e), sbf and tbf are formed there once, and each thread
//    keeps out[e, c] for its edges in float32 registers across all s.
//  - Backward: a block owns one (slot, s). The dx rows (j, s) of the slot
//    receive only from the slot's edges, so the block sums them in shared
//    memory in edge order (each thread owns a set of rows): no atomics.
//    dws/dwt are per-block shared-memory sums (each entry owned by one
//    thread), written to a [blocks, ...] scratch and summed by a second
//    kernel in a fixed tree order: two backwards give the same bits.
//    dpt is row-local and only computed when asked for.
//  - Second order: two kernels. ctb sums over s, so it is a "tangent
//    forward" in the forward's layout (32 edges a block, s in a loop, f32
//    registers). xb, ptb, wsb and wtb take the backward's layout (a block
//    per (slot, s), xb rows summed in shared memory, ptb row-local,
//    wsb/wtb per-block partials summed in a fixed order): no atomics, so
//    two runs give the same bits. Every element of xb and ptb is written,
//    zeros included. A None cotangent is a null pointer and its terms are
//    skipped.
//  - Products run on the FP32 pipes. In bf16 the operands the TPU kernel
//    rounds (sbf, tbf, the gathered x) are bf16 values; bf16 x bf16 is exact
//    in f32 and sums are f32 (the TPU kernel sums over s in bf16; here out
//    is rounded once). Tangents (u1, u2 and the da, db formed from them)
//    are not rounded. wgmma for the basis products is later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int ET = 32;   // edges per chunk

template <typename T>
constexpr bool IS_BF16 = sizeof(T) == 2;

template <typename T>
struct Params {
  const T* x;       // [E, C]
  const T* pt;      // [K, R, E]
  const T* m2T;     // [K, E]
  const float* ws;  // [nk, C]
  const float* wt;  // [ntk, C]
  const int* lj;    // [E]
  const float* ct;  // [E, C] (backward, second order)
  const T* u1;      // [E, C] or null: cotangent of dx (second order)
  const T* u2;      // [K, R, E] or null: cotangent of dpt
  const float* u4;  // [nk, C] or null: cotangent of dws
  const float* u5;  // [ntk, C] or null: cotangent of dwt
  T* out;           // [E, C] (forward)
  float* dx;        // [E, C] (backward: dx; second order: xb)
  float* dpt;       // [K, R, E] or null (backward: dpt; second order: ptb)
  float* ctb;       // [E, C] (second order)
  float* partial;   // [blocks, (nk + ntk) * C]
  int E, A, K, n, k, has_t;
  int nk, ntk, NB, R;
};

// ws / wt rows in shared memory with a row stride of C+1 floats: reads with
// c across lanes (the products) and with the row across lanes (the basis
// gradient) are both free of bank conflicts.
template <int C, typename T>
__device__ void load_weights(const Params<T>& p, float* ws_s, float* wt_s) {
  for (int x = threadIdx.x; x < p.nk * C; x += NT) ws_s[(x / C) * (C + 1) + x % C] = p.ws[x];
  for (int x = threadIdx.x; x < p.ntk * C; x += NT) wt_s[(x / C) * (C + 1) + x % C] = p.wt[x];
}

// pt[s, :, e0:e0+cnt] -> ptc [R][ET] (zero past cnt), m2T and lj likewise.
template <typename T>
__device__ void load_chunk(const Params<T>& p, int s, int e0, int cnt, float* ptc,
                           float* m2c, int* ljc) {
  for (int x = threadIdx.x; x < p.R * ET; x += NT) {
    const int r = x / ET, ec = x % ET;
    ptc[x] = ec < cnt ? ld(p.pt + ((size_t)s * p.R + r) * p.E + e0 + ec) : 0.f;
  }
  for (int ec = threadIdx.x; ec < ET; ec += NT) {
    float m = 0.f;
    int j = 0;
    if (ec < cnt) {
      j = p.lj[e0 + ec];
      m = (j >= 0 && j < p.A) ? ld(p.m2T + (size_t)s * p.E + e0 + ec) : 0.f;
    }
    m2c[ec] = m;
    ljc[ec] = m != 0.f ? j : 0;
  }
}

// bas [ET][NB]: sbf (rows < nk) then tbf, rounded to T.
template <typename T>
__device__ void form_basis(const Params<T>& p, const float* ptc, float* bas) {
  const int nk = p.nk, k = p.k;
  for (int x = threadIdx.x; x < ET * p.NB; x += NT) {
    const int ec = x / p.NB, r = x % p.NB;
    float v;
    if (r < nk) {
      v = ptc[r * ET + ec] * ptc[(nk + r / k) * ET + ec];
    } else {
      const int i = r - nk;
      v = ptc[(nk + p.n + i / k) * ET + ec] * ptc[(i % nk) * ET + ec];
    }
    bas[x] = rnd<IS_BF16<T>>(v);
  }
}

// sv = sbf @ ws[:, c], tv = tbf @ wt[:, c] (tv = 1 without torsion).
template <int C>
__device__ __forceinline__ void basis_products(const float* b, const float* ws_s,
                                               const float* wt_s, int nk, int ntk, int c,
                                               float& sv, float& tv) {
  sv = 0.f;
  for (int r = 0; r < nk; ++r) sv = fmaf(b[r], ws_s[r * (C + 1) + c], sv);
  tv = 1.f;
  if (ntk > 0) {
    tv = 0.f;
    for (int i = 0; i < ntk; ++i) tv = fmaf(b[nk + i], wt_s[i * (C + 1) + c], tv);
  }
}

// u2[s, :, e0:e0+cnt] -> u2c [R][ET] (zero past cnt or without u2).
template <typename T>
__device__ void load_tangent_chunk(const Params<T>& p, int s, int e0, int cnt, float* u2c) {
  for (int x = threadIdx.x; x < p.R * ET; x += NT) {
    const int r = x / ET, ec = x % ET;
    u2c[x] = (p.u2 != nullptr && ec < cnt) ? ld(p.u2 + ((size_t)s * p.R + r) * p.E + e0 + ec)
                                           : 0.f;
  }
}

// dbas [ET][NB]: the tangents of sbf and tbf along u2 (product rule), not
// rounded: d sbf[l*k+m] = ub y0 + bt uy0, d tbf[i] = uyt bt + yt ub.
template <typename T>
__device__ void form_tangent(const Params<T>& p, const float* ptc, const float* u2c,
                             float* dbas) {
  const int nk = p.nk, k = p.k;
  for (int x = threadIdx.x; x < ET * p.NB; x += NT) {
    const int ec = x / p.NB, r = x % p.NB;
    int b, y;  // the bt row and the y0 / yt row of this product
    if (r < nk) {
      b = r;
      y = nk + r / k;
    } else {
      const int i = r - nk;
      b = i % nk;
      y = nk + p.n + i / k;
    }
    dbas[x] = u2c[b * ET + ec] * ptc[y * ET + ec] + ptc[b * ET + ec] * u2c[y * ET + ec];
  }
}

// dsv = da @ ws[:, c] + a @ u4[:, c], dtv = db @ wt[:, c] + b @ u5[:, c]
// (dtv = 0 without torsion); u4 / u5 terms only when given.
template <int C, typename T>
__device__ __forceinline__ void tangent_products(const Params<T>& p, const float* b,
                                                 const float* db, const float* ws_s,
                                                 const float* wt_s, int c, float& dsv,
                                                 float& dtv) {
  const int nk = p.nk, ntk = p.ntk;
  dsv = 0.f;
  for (int r = 0; r < nk; ++r) dsv = fmaf(db[r], ws_s[r * (C + 1) + c], dsv);
  if (p.u4 != nullptr)
    for (int r = 0; r < nk; ++r) dsv = fmaf(b[r], __ldg(p.u4 + r * C + c), dsv);
  dtv = 0.f;
  if (ntk > 0) {
    for (int i = 0; i < ntk; ++i) dtv = fmaf(db[nk + i], wt_s[i * (C + 1) + c], dtv);
    if (p.u5 != nullptr)
      for (int i = 0; i < ntk; ++i) dtv = fmaf(b[nk + i], __ldg(p.u5 + i * C + c), dtv);
  }
}

// The adjoint of forming sbf / tbf from the pt rows in src: given the
// cotangent d [NB] of (sbf | tbf) of edge ec, the cotangent of pt row r
// (bt: d sbf y0 + sum_a d tbf yt; y0: sum_m d sbf bt; yt: sum_m d tbf bt).
template <typename T>
__device__ __forceinline__ float basis_adjoint(const Params<T>& p, const float* d,
                                               const float* src, int r, int ec) {
  const int nk = p.nk, n = p.n, k = p.k;
  float v = 0.f;
  if (r < nk) {
    const int l = r / k;
    v = d[r] * src[(nk + l) * ET + ec];
    for (int a = 0; a < (p.ntk > 0 ? n : 0); ++a)
      v = fmaf(d[nk + a * nk + r], src[(nk + n + a * n + l) * ET + ec], v);
  } else if (r < nk + n) {
    const int l = r - nk;
    for (int mm = 0; mm < k; ++mm) v = fmaf(d[l * k + mm], src[(l * k + mm) * ET + ec], v);
  } else {
    const int q = r - nk - n;
    for (int mm = 0; mm < k; ++mm)
      v = fmaf(d[nk + q * k + mm], src[((q * k + mm) % nk) * ET + ec], v);
  }
  return v;
}

template <typename T, int C>
__global__ void __launch_bounds__(NT) triplet_slot_fwd_kernel(Params<T> p) {
  constexpr int EG = NT / C;    // edge groups
  constexpr int EPT = ET / EG;  // edges per thread
  extern __shared__ __align__(16) float smem[];
  float* ws_s = smem;                           // [nk][C+1]
  float* wt_s = ws_s + p.nk * (C + 1);          // [ntk][C+1]
  float* ptc = wt_s + p.ntk * (C + 1);          // [R][ET]
  float* bas = ptc + p.R * ET;                  // [ET][NB]
  float* m2c = bas + ET * p.NB;                 // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int e0 = blockIdx.x * ET;
  const int cnt = min(ET, p.E - e0);
  const int SE = p.A * p.K;
  load_weights<C>(p, ws_s, wt_s);

  float acc[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) acc[q] = 0.f;

  for (int s = 0; s < p.K; ++s) {
    __syncthreads();
    load_chunk(p, s, e0, cnt, ptc, m2c, ljc);
    __syncthreads();
    form_basis(p, ptc, bas);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int ec = eg + EG * q;
      const float m = m2c[ec];
      if (m != 0.f) {
        const int e = e0 + ec;
        const size_t row = ((size_t)(e / SE) * p.A + ljc[ec]) * p.K + s;
        float sv, tv;
        basis_products<C>(bas + ec * p.NB, ws_s, wt_s, p.nk, p.ntk, c, sv, tv);
        const float xv = m * rnd<IS_BF16<T>>(ld(p.x + row * C + c));
        acc[q] += (xv * sv) * tv;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int ec = eg + EG * q;
    if (ec < cnt) st(p.out + (size_t)(e0 + ec) * C + c, acc[q]);
  }
}

template <typename T, int C, bool DPT>
__global__ void __launch_bounds__(NT) triplet_slot_bwd_kernel(Params<T> p) {
  constexpr int EG = NT / C;
  constexpr int EPT = ET / EG;
  extern __shared__ __align__(16) float smem[];
  const int nk = p.nk, ntk = p.ntk, NB = p.NB, A = p.A, K = p.K;
  float* ws_s = smem;                           // [nk][C+1]
  float* wt_s = ws_s + nk * (C + 1);            // [ntk][C+1]
  float* dW_s = wt_s + ntk * (C + 1);           // [NB][C] weight-gradient sums
  float* dx_s = dW_s + NB * C;                  // [A][C]
  float* ptc = dx_s + A * C;                    // [R][ET]
  float* bas = ptc + p.R * ET;                  // [ET][NB]
  float* dsv = bas + ET * NB;                   // [ET][C]
  float* dtv = dsv + ET * C;                    // [ET][C]
  float* dxg = dtv + ET * C;                    // [ET][C]
  float* dbas = dxg + ET * C;                   // [ET][NB] (DPT only)
  float* m2c = dbas + (DPT ? ET * NB : 0);      // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int g = blockIdx.x / K, s = blockIdx.x % K;
  const int SE = A * K, base = g * SE;
  load_weights<C>(p, ws_s, wt_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  for (int x = tid; x < A * C; x += NT) dx_s[x] = 0.f;

  for (int c0 = 0; c0 < SE; c0 += ET) {
    const int cnt = min(ET, SE - c0);
    const int e0 = base + c0;
    __syncthreads();
    load_chunk(p, s, e0, cnt, ptc, m2c, ljc);
    __syncthreads();
    form_basis(p, ptc, bas);
    __syncthreads();
    // per-triplet cotangents: dxg = m g sv tv, dsv = g tv xv, dtv = g xv sv
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int ec = eg + EG * q;
      const float m = m2c[ec];
      float a = 0.f, b = 0.f, d = 0.f;
      if (m != 0.f) {
        const size_t row = ((size_t)g * A + ljc[ec]) * K + s;
        float sv, tv;
        basis_products<C>(bas + ec * NB, ws_s, wt_s, nk, ntk, c, sv, tv);
        const float xv = m * rnd<IS_BF16<T>>(ld(p.x + row * C + c));
        const float go = p.ct[(size_t)(e0 + ec) * C + c];
        const float gt = go * tv;
        a = (gt * sv) * m;
        b = gt * xv;
        d = go * (xv * sv);
      }
      dxg[ec * C + c] = a;
      dsv[ec * C + c] = b;
      dtv[ec * C + c] = d;
    }
    __syncthreads();
    // weight gradients: each (row, c) entry owned by one thread, edge order
    for (int x = tid; x < NB * C; x += NT) {
      const int r = x / C, cc = x % C;
      const float* src = r < nk ? dsv : dtv;
      float acc = dW_s[x];
      for (int ec = 0; ec < cnt; ++ec) {
        if (m2c[ec] != 0.f) acc = fmaf(bas[ec * NB + r], src[ec * C + cc], acc);
      }
      dW_s[x] = acc;
    }
    // dx rows (j, s): thread (c, jg) owns the rows j with j % EG == jg
    for (int ec = 0; ec < cnt; ++ec) {
      const int j = ljc[ec];
      if (m2c[ec] != 0.f && j % EG == eg) dx_s[j * C + c] += dxg[ec * C + c];
    }
    if constexpr (DPT) {
      // d sbf = dsv @ ws^T, d tbf = dtv @ wt^T
      for (int x = tid; x < ET * NB; x += NT) {
        const int ec = x / NB, r = x % NB;
        float acc = 0.f;
        if (m2c[ec] != 0.f) {
          const float* src = r < nk ? dsv + ec * C : dtv + ec * C;
          const float* w = r < nk ? ws_s + r * (C + 1) : wt_s + (r - nk) * (C + 1);
          for (int cc = 0; cc < C; ++cc) acc = fmaf(src[cc], w[cc], acc);
        }
        dbas[x] = acc;
      }
      __syncthreads();
      // back through the products: d bt, d y0, d yt
      for (int x = tid; x < p.R * ET; x += NT) {
        const int r = x / ET, ec = x % ET;
        if (ec >= cnt) continue;
        p.dpt[((size_t)s * p.R + r) * p.E + e0 + ec] = basis_adjoint(p, dbas + ec * NB, ptc, r, ec);
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < A * C; x += NT) {
    const int j = x / C, cc = x % C;
    p.dx[(((size_t)g * A + j) * K + s) * C + cc] = dx_s[x];
  }
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

// Second order, part 1: ctb[e] = sum_s m (dg sv tv + g dsv tv + g sv dtv),
// the forward's linearisation along (u1, u2, u4, u5), in the forward's
// layout (32 edges a block, s in a loop, f32 registers).
template <typename T, int C>
__global__ void __launch_bounds__(NT) triplet_slot_jvp_kernel(Params<T> p) {
  constexpr int EG = NT / C;
  constexpr int EPT = ET / EG;
  extern __shared__ __align__(16) float smem[];
  float* ws_s = smem;                           // [nk][C+1]
  float* wt_s = ws_s + p.nk * (C + 1);          // [ntk][C+1]
  float* ptc = wt_s + p.ntk * (C + 1);          // [R][ET]
  float* u2c = ptc + p.R * ET;                  // [R][ET]
  float* bas = u2c + p.R * ET;                  // [ET][NB]
  float* dbas = bas + ET * p.NB;                // [ET][NB]
  float* m2c = dbas + ET * p.NB;                // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int e0 = blockIdx.x * ET;
  const int cnt = min(ET, p.E - e0);
  const int SE = p.A * p.K;
  load_weights<C>(p, ws_s, wt_s);

  float acc[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) acc[q] = 0.f;

  for (int s = 0; s < p.K; ++s) {
    __syncthreads();
    load_chunk(p, s, e0, cnt, ptc, m2c, ljc);
    load_tangent_chunk(p, s, e0, cnt, u2c);
    __syncthreads();
    form_basis(p, ptc, bas);
    form_tangent(p, ptc, u2c, dbas);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int ec = eg + EG * q;
      const float m = m2c[ec];
      if (m != 0.f) {
        const int e = e0 + ec;
        const size_t row = ((size_t)(e / SE) * p.A + ljc[ec]) * p.K + s;
        float sv, tv, dsv, dtv;
        basis_products<C>(bas + ec * p.NB, ws_s, wt_s, p.nk, p.ntk, c, sv, tv);
        tangent_products<C>(p, bas + ec * p.NB, dbas + ec * p.NB, ws_s, wt_s, c, dsv, dtv);
        const float gv = m * rnd<IS_BF16<T>>(ld(p.x + row * C + c));
        const float dg = p.u1 != nullptr ? m * ld(p.u1 + row * C + c) : 0.f;
        acc[q] += fmaf(dg, sv, gv * dsv) * tv + (gv * sv) * dtv;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int ec = eg + EG * q;
    if (ec < cnt) p.ctb[(size_t)(e0 + ec) * C + c] = acc[q];
  }
}

// Second order, part 2: xb, ptb and the wsb / wtb partials, one block per
// (slot, s) as the backward. Per real triplet and channel, with
// go = ct m: Psv = go (dg tv + g dtv) and Ptv = go (dg sv + g dsv) are the
// cotangents of sv and tv, Qsv = go g tv and Qtv = go g sv those of dsv and
// dtv, and xg = go (dsv tv + sv dtv) that of the gathered x row.
template <typename T, int C>
__global__ void __launch_bounds__(NT) triplet_slot_bwd2_kernel(Params<T> p) {
  constexpr int EG = NT / C;
  constexpr int EPT = ET / EG;
  extern __shared__ __align__(16) float smem[];
  const int nk = p.nk, ntk = p.ntk, NB = p.NB, A = p.A, K = p.K;
  float* ws_s = smem;                           // [nk][C+1]
  float* wt_s = ws_s + nk * (C + 1);            // [ntk][C+1]
  float* dW_s = wt_s + ntk * (C + 1);           // [NB][C] wsb | wtb sums
  float* dx_s = dW_s + NB * C;                  // [A][C] xb rows
  float* ptc = dx_s + A * C;                    // [R][ET]
  float* u2c = ptc + p.R * ET;                  // [R][ET]
  float* bas = u2c + p.R * ET;                  // [ET][NB] a|b, then d(a|b)
  float* dbas = bas + ET * NB;                  // [ET][NB] da|db, then d(da|db)
  float* Psv = dbas + ET * NB;                  // [ET][C]
  float* Ptv = Psv + ET * C;                    // [ET][C]
  float* Qsv = Ptv + ET * C;                    // [ET][C]
  float* Qtv = Qsv + ET * C;                    // [ET][C]
  float* xg = Qtv + ET * C;                     // [ET][C]
  float* m2c = xg + ET * C;                     // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int g = blockIdx.x / K, s = blockIdx.x % K;
  const int SE = A * K, base = g * SE;
  load_weights<C>(p, ws_s, wt_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  for (int x = tid; x < A * C; x += NT) dx_s[x] = 0.f;

  for (int c0 = 0; c0 < SE; c0 += ET) {
    const int cnt = min(ET, SE - c0);
    const int e0 = base + c0;
    __syncthreads();
    load_chunk(p, s, e0, cnt, ptc, m2c, ljc);
    load_tangent_chunk(p, s, e0, cnt, u2c);
    __syncthreads();
    form_basis(p, ptc, bas);
    form_tangent(p, ptc, u2c, dbas);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int ec = eg + EG * q;
      const float m = m2c[ec];
      float ps = 0.f, pt = 0.f, qs = 0.f, qt = 0.f, xv = 0.f;
      if (m != 0.f) {
        const size_t row = ((size_t)g * A + ljc[ec]) * K + s;
        float sv, tv, dsv, dtv;
        basis_products<C>(bas + ec * NB, ws_s, wt_s, nk, ntk, c, sv, tv);
        tangent_products<C>(p, bas + ec * NB, dbas + ec * NB, ws_s, wt_s, c, dsv, dtv);
        const float gv = rnd<IS_BF16<T>>(ld(p.x + row * C + c));
        const float dg = p.u1 != nullptr ? ld(p.u1 + row * C + c) : 0.f;
        const float go = p.ct[(size_t)(e0 + ec) * C + c] * m;
        qs = go * (gv * tv);
        qt = go * (gv * sv);
        ps = go * fmaf(dg, tv, gv * dtv);
        pt = go * fmaf(dg, sv, gv * dsv);
        xv = go * fmaf(dsv, tv, sv * dtv);
      }
      Psv[ec * C + c] = ps;
      Ptv[ec * C + c] = pt;
      Qsv[ec * C + c] = qs;
      Qtv[ec * C + c] = qt;
      xg[ec * C + c] = xv;
    }
    __syncthreads();
    // wsb | wtb: each (row, c) entry owned by one thread, edge order
    for (int x = tid; x < NB * C; x += NT) {
      const int r = x / C, cc = x % C;
      const float* P = r < nk ? Psv : Ptv;
      const float* Q = r < nk ? Qsv : Qtv;
      float acc = dW_s[x];
      for (int ec = 0; ec < cnt; ++ec) {
        if (m2c[ec] != 0.f) {
          acc = fmaf(bas[ec * NB + r], P[ec * C + cc], acc);
          acc = fmaf(dbas[ec * NB + r], Q[ec * C + cc], acc);
        }
      }
      dW_s[x] = acc;
    }
    // xb rows (j, s): thread (c, jg) owns the rows j with j % EG == jg
    for (int ec = 0; ec < cnt; ++ec) {
      const int j = ljc[ec];
      if (m2c[ec] != 0.f && j % EG == eg) dx_s[j * C + c] += xg[ec * C + c];
    }
    __syncthreads();
    // cotangents of (a | b) -> bas and of (da | db) -> dbas:
    // d(a|b) = P @ w^T + Q @ u^T, d(da|db) = Q @ w^T
    for (int x = tid; x < ET * NB; x += NT) {
      const int ec = x / NB, r = x % NB;
      float gt = 0.f, gd = 0.f;
      if (m2c[ec] != 0.f) {
        const bool sr = r < nk;
        const float* P = (sr ? Psv : Ptv) + ec * C;
        const float* Q = (sr ? Qsv : Qtv) + ec * C;
        const float* w = sr ? ws_s + r * (C + 1) : wt_s + (r - nk) * (C + 1);
        for (int cc = 0; cc < C; ++cc) {
          gt = fmaf(P[cc], w[cc], gt);
          gd = fmaf(Q[cc], w[cc], gd);
        }
        const float* u = sr ? p.u4 : p.u5;
        if (u != nullptr) {
          const float* ur = u + (size_t)(sr ? r : r - nk) * C;
          for (int cc = 0; cc < C; ++cc) gt = fmaf(Q[cc], __ldg(ur + cc), gt);
        }
      }
      bas[x] = gt;
      dbas[x] = gd;
    }
    __syncthreads();
    // ptb through the products: from (a | b) against pt, (da | db) against u2
    for (int x = tid; x < p.R * ET; x += NT) {
      const int r = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      p.dpt[((size_t)s * p.R + r) * p.E + e0 + ec] =
          basis_adjoint(p, bas + ec * NB, ptc, r, ec) + basis_adjoint(p, dbas + ec * NB, u2c, r, ec);
    }
  }
  __syncthreads();
  for (int x = tid; x < A * C; x += NT) {
    const int j = x / C, cc = x % C;
    p.dx[(((size_t)g * A + j) * K + s) * C + cc] = dx_s[x];
  }
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

template <typename T>
Params<T> make_params(const void* x, const void* pt, const void* m2T, const float* ws,
                      const float* wt, const int* lj, int E, int A, int K, int n, int k,
                      int has_t) {
  Params<T> p{};
  p.x = static_cast<const T*>(x);
  p.pt = static_cast<const T*>(pt);
  p.m2T = static_cast<const T*>(m2T);
  p.ws = ws;
  p.wt = wt;
  p.lj = lj;
  p.E = E; p.A = A; p.K = K; p.n = n; p.k = k; p.has_t = has_t;
  p.nk = n * k;
  p.ntk = has_t ? n * n * k : 0;
  p.NB = p.nk + p.ntk;
  p.R = p.nk + n + (has_t ? n * n : 0);
  return p;
}

template <typename T, int C>
int fwd_t(Params<T> p, cudaStream_t strm) {
  const size_t smem = ((size_t)(p.nk + p.ntk) * (C + 1) + p.R * ET + ET * p.NB + 2 * ET) *
                      sizeof(float);
  const int grid = (p.E + ET - 1) / ET;
  return launch(triplet_slot_fwd_kernel<T, C>, grid, NT, smem, strm, p);
}

template <typename T, int C>
int bwd_t(Params<T> p, int need_dpt, int blocks, cudaStream_t strm) {
  const size_t floats = (size_t)(p.nk + p.ntk) * (C + 1) + (size_t)p.NB * C +
                        (size_t)p.A * C + p.R * ET + ET * p.NB + 3 * ET * C +
                        (need_dpt ? ET * p.NB : 0) + 2 * ET;
  const size_t smem = floats * sizeof(float);
  if (need_dpt) return launch(triplet_slot_bwd_kernel<T, C, true>, blocks, NT, smem, strm, p);
  return launch(triplet_slot_bwd_kernel<T, C, false>, blocks, NT, smem, strm, p);
}

template <typename T, int C>
int bwd2_t(Params<T> p, int blocks, cudaStream_t strm) {
  const size_t jvp = ((size_t)(p.nk + p.ntk) * (C + 1) + 2 * p.R * ET + 2 * ET * p.NB + 2 * ET) *
                     sizeof(float);
  int rc = launch(triplet_slot_jvp_kernel<T, C>, (p.E + ET - 1) / ET, NT, jvp, strm, p);
  if (rc != 0) return rc;
  const size_t floats = (size_t)(p.nk + p.ntk) * (C + 1) + (size_t)p.NB * C +
                        (size_t)p.A * C + 2 * p.R * ET + 2 * ET * p.NB + 5 * ET * C + 2 * ET;
  return launch(triplet_slot_bwd2_kernel<T, C>, blocks, NT, floats * sizeof(float), strm, p);
}

template <typename T>
int fwd_c(Params<T> p, int C, cudaStream_t strm) {
  switch (C) {
    case 32: return fwd_t<T, 32>(p, strm);
    case 64: return fwd_t<T, 64>(p, strm);
    case 128: return fwd_t<T, 128>(p, strm);
    default: return ERR_SHAPE;
  }
}

template <typename T>
int bwd_c(Params<T> p, int C, int need_dpt, int blocks, cudaStream_t strm) {
  switch (C) {
    case 32: return bwd_t<T, 32>(p, need_dpt, blocks, strm);
    case 64: return bwd_t<T, 64>(p, need_dpt, blocks, strm);
    case 128: return bwd_t<T, 128>(p, need_dpt, blocks, strm);
    default: return ERR_SHAPE;
  }
}

template <typename T>
int bwd2_c(Params<T> p, int C, int blocks, cudaStream_t strm) {
  switch (C) {
    case 32: return bwd2_t<T, 32>(p, blocks, strm);
    case 64: return bwd2_t<T, 64>(p, blocks, strm);
    case 128: return bwd2_t<T, 128>(p, blocks, strm);
    default: return ERR_SHAPE;
  }
}

}  // namespace

extern "C" {

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM. x, pt, m2T and out
// are bf16 when bf16 != 0, float32 otherwise.
int triplet_slot_fwd(const void* x, const void* pt, const void* m2T, const float* ws,
                     const float* wt, const int* lj, void* out, int E, int A, int K, int n,
                     int k, int has_t, int C, int bf16, void* stream) {
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(x, pt, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.out = static_cast<__nv_bfloat16*>(out);
    return fwd_c(p, C, strm);
  }
  auto p = make_params<float>(x, pt, m2T, ws, wt, lj, E, A, K, n, k, has_t);
  p.out = static_cast<float*>(out);
  return fwd_c(p, C, strm);
}

// ct, dx, dpt float32; dpt may be null when need_dpt == 0. partial:
// [blocks, (nk+ntk)*C] scratch, blocks = (E / (A*K)) * K; dw: [(nk+ntk)*C]
// receives dws | dwt.
int triplet_slot_bwd(const void* x, const void* pt, const void* m2T, const float* ws,
                     const float* wt, const int* lj, const float* ct, float* dx, float* dpt,
                     float* partial, float* dw, int E, int A, int K, int n, int k, int has_t,
                     int C, int bf16, int need_dpt, int blocks, void* stream) {
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int rc;
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(x, pt, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.dx = dx; p.dpt = dpt; p.partial = partial;
    rc = bwd_c(p, C, need_dpt, blocks, strm);
  } else {
    auto p = make_params<float>(x, pt, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.dx = dx; p.dpt = dpt; p.partial = partial;
    rc = bwd_c(p, C, need_dpt, blocks, strm);
  }
  if (rc != 0) return rc;
  const int size = (n * k + (has_t ? n * n * k : 0)) * C;
  return sum_partials(partial, blocks, size, dw, strm);
}

// Second order. ct float32; u1 / u2 in the type of x and pt, u4 / u5
// float32, each null when absent. xb, ptb, ctb float32 (every element
// written); partial and dw as for the backward (dw receives wsb | wtb).
int triplet_slot_bwd2(const void* x, const void* pt, const void* m2T, const float* ws,
                      const float* wt, const int* lj, const float* ct, const void* u1,
                      const void* u2, const float* u4, const float* u5, float* xb, float* ptb,
                      float* partial, float* dw, float* ctb, int E, int A, int K, int n, int k,
                      int has_t, int C, int bf16, int blocks, void* stream) {
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int rc;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(x, pt, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.u2 = static_cast<const B*>(u2);
    p.u4 = u4; p.u5 = u5; p.dx = xb; p.dpt = ptb; p.ctb = ctb; p.partial = partial;
    rc = bwd2_c(p, C, blocks, strm);
  } else {
    auto p = make_params<float>(x, pt, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.u2 = static_cast<const float*>(u2);
    p.u4 = u4; p.u5 = u5; p.dx = xb; p.dpt = ptb; p.ctb = ctb; p.partial = partial;
    rc = bwd2_c(p, C, blocks, strm);
  }
  if (rc != 0) return rc;
  const int size = (n * k + (has_t ? n * n * k : 0)) * C;
  return sum_partials(partial, blocks, size, dw, strm);
}

}  // extern "C"
