// The slot contraction of the triplet_slot family for NVIDIA Hopper
// (sm_90a): the forward, backward and second-order kernels, templated on
// where a chunk's basis rows come from. csrc/triplet_slot.cu reads them
// from the packed table pt [K, R, E] (PtRows, below); csrc/triplet_slot_geom.cu
// evaluates them from the per-triplet geometry (its GeomRows). Everything
// else, and so every rounding and every sum, is the same code. The design
// notes and bounds are in the two sources.
//
//   out[e] = sum_s m2T[s,e] * x[(slot(e)*A + lj[e])*K + s] * sv * tv
//   sv = sbf[e,s] @ ws,  sbf[l*k+m] = bt[l*k+m] * y0[l]
//   tv = tbf[e,s] @ wt,  tbf[i]     = yt[i/k] * bt[i % nk]     (has_t only)
//   slot(e) = e / (A*K); bt, y0, yt = rows [0,nk), [nk,nk+n), [nk+n,R) of
//   the chunk's rows ptc; nk = n*k, ntk = n*n*k, R = nk + n (+ n*n with has_t).
//
// A row source Rows provides, for one chunk of ET edges and one s:
//   Rows::load(p, s, e0, cnt, ptc, m2c, ljc, u2c, rs): the rows ptc [R][ET]
//     in float32 (zero past cnt), the mask m2c [ET] (0 where lj is outside
//     [0, A)), the ids ljc [ET] and, when u2c is not null, the rows' tangent
//     u2c [R][ET] (the cotangent of the rows' gradient in the second order);
//   Rows::write_dpt(p, s, e0, cnt, dbas, ptc, m2c, rs): the backward's
//     output from the cotangent dbas [ET][NB] of (sbf | tbf);
//   Rows::write_ptb(p, s, e0, cnt, bas, dbas, ptc, u2c, m2c, rs): the second
//     order's output from the cotangents bas of (a | b) and dbas of (da | db).
// rs is RS floats of shared scratch for the row source.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per block
constexpr int ET = 32;      // edges per chunk
constexpr int RS = 8 * ET;  // floats of shared scratch for the row source

template <typename T>
constexpr bool IS_BF16 = sizeof(T) == 2;

template <typename T>
struct Params {
  const T* x;       // [E, C]
  const T* pt;      // [K, R, E] (the table's rows)
  const T* m2T;     // [K, E]
  const float* ws;  // [nk, C]
  const float* wt;  // [ntk, C]
  const int* lj;    // [E]
  const float* ct;  // [E, C] (backward, second order)
  const T* u1;      // [E, C] or null: cotangent of dx (second order)
  const T* u2;      // [K, R, E] or null: cotangent of dpt
  const float* u4;  // [nk, C] or null: cotangent of dws
  const float* u5;  // [ntk, C] or null: cotangent of dwt
  const float* geo; // [K, NG, E] (the geometry's rows)
  const float* ug;  // [K, NG, E] or null: cotangent of dgeo
  T* out;           // [E, C] (forward)
  float* dx;        // [E, C] (backward: dx; second order: xb)
  float* dpt;       // [K, R, E] or null (backward: dpt; second order: ptb)
  float* dgeo;      // [K, NG, E] or null (backward: dgeo; second order: geob)
  float* ctb;       // [E, C] (second order)
  float* partial;   // [blocks, (nk + ntk) * C]
  int E, A, K, n, k, has_t;
  int nk, ntk, NB, R, NG;
};

// ws / wt rows in shared memory with a row stride of C+1 floats: reads with
// c across lanes (the products) and with the row across lanes (the basis
// gradient) are both free of bank conflicts.
template <int C, typename T>
__device__ void load_weights(const Params<T>& p, float* ws_s, float* wt_s) {
  for (int x = threadIdx.x; x < p.nk * C; x += NT) ws_s[(x / C) * (C + 1) + x % C] = p.ws[x];
  for (int x = threadIdx.x; x < p.ntk * C; x += NT) wt_s[(x / C) * (C + 1) + x % C] = p.wt[x];
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

// The adjoint of forming sbf / tbf from the rows in src: given the
// cotangent d [NB] of (sbf | tbf) of edge ec, the cotangent of row r
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

// The packed table as the row source: pt[s, :, e0:e0+cnt] (and u2's) read
// as they are; dpt and ptb written row by row.
struct PtRows {
  template <typename T>
  static __device__ void load(const Params<T>& p, int s, int e0, int cnt, float* ptc,
                              float* m2c, int* ljc, float* u2c, float*) {
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
    if (u2c == nullptr) return;
    for (int x = threadIdx.x; x < p.R * ET; x += NT) {
      const int r = x / ET, ec = x % ET;
      u2c[x] = (p.u2 != nullptr && ec < cnt) ? ld(p.u2 + ((size_t)s * p.R + r) * p.E + e0 + ec)
                                             : 0.f;
    }
  }

  template <typename T>
  static __device__ void write_dpt(const Params<T>& p, int s, int e0, int cnt, const float* dbas,
                                   const float* ptc, const float*, const float*) {
    for (int x = threadIdx.x; x < p.R * ET; x += NT) {
      const int r = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      p.dpt[((size_t)s * p.R + r) * p.E + e0 + ec] = basis_adjoint(p, dbas + ec * p.NB, ptc, r, ec);
    }
  }

  template <typename T>
  static __device__ void write_ptb(const Params<T>& p, int s, int e0, int cnt, const float* bas,
                                   const float* dbas, const float* ptc, const float* u2c,
                                   const float*, const float*) {
    for (int x = threadIdx.x; x < p.R * ET; x += NT) {
      const int r = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      p.dpt[((size_t)s * p.R + r) * p.E + e0 + ec] =
          basis_adjoint(p, bas + ec * p.NB, ptc, r, ec) + basis_adjoint(p, dbas + ec * p.NB, u2c, r, ec);
    }
  }
};

template <typename T, int C, typename Rows>
__global__ void __launch_bounds__(NT) slot_fwd_kernel(Params<T> p) {
  constexpr int EG = NT / C;    // edge groups
  constexpr int EPT = ET / EG;  // edges per thread
  extern __shared__ __align__(16) float smem[];
  float* ws_s = smem;                           // [nk][C+1]
  float* wt_s = ws_s + p.nk * (C + 1);          // [ntk][C+1]
  float* ptc = wt_s + p.ntk * (C + 1);          // [R][ET]
  float* bas = ptc + p.R * ET;                  // [ET][NB]
  float* m2c = bas + ET * p.NB;                 // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]
  float* rs = reinterpret_cast<float*>(ljc + ET);  // [RS]

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
    Rows::load(p, s, e0, cnt, ptc, m2c, ljc, nullptr, rs);
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

template <typename T, int C, bool DPT, typename Rows>
__global__ void __launch_bounds__(NT) slot_bwd_kernel(Params<T> p) {
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
  float* rs = reinterpret_cast<float*>(ljc + ET);  // [RS]

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
    Rows::load(p, s, e0, cnt, ptc, m2c, ljc, nullptr, rs);
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
      // back through the products to the rows: d bt, d y0, d yt
      Rows::write_dpt(p, s, e0, cnt, dbas, ptc, m2c, rs);
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
template <typename T, int C, typename Rows>
__global__ void __launch_bounds__(NT) slot_jvp_kernel(Params<T> p) {
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
  float* rs = reinterpret_cast<float*>(ljc + ET);  // [RS]

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
    Rows::load(p, s, e0, cnt, ptc, m2c, ljc, u2c, rs);
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

// Second order, part 2: xb, the rows' cotangent and the wsb / wtb partials,
// one block per (slot, s) as the backward. Per real triplet and channel,
// with go = ct m: Psv = go (dg tv + g dtv) and Ptv = go (dg sv + g dsv) are
// the cotangents of sv and tv, Qsv = go g tv and Qtv = go g sv those of dsv
// and dtv, and xg = go (dsv tv + sv dtv) that of the gathered x row.
template <typename T, int C, typename Rows>
__global__ void __launch_bounds__(NT) slot_bwd2_kernel(Params<T> p) {
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
  float* rs = reinterpret_cast<float*>(ljc + ET);  // [RS]

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
    Rows::load(p, s, e0, cnt, ptc, m2c, ljc, u2c, rs);
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
    // the rows' cotangent through the products: from (a | b) against the
    // rows, (da | db) against their tangent
    Rows::write_ptb(p, s, e0, cnt, bas, dbas, ptc, u2c, m2c, rs);
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
Params<T> make_params(const void* x, const void* m2T, const float* ws, const float* wt,
                      const int* lj, int E, int A, int K, int n, int k, int has_t) {
  Params<T> p{};
  p.x = static_cast<const T*>(x);
  p.m2T = static_cast<const T*>(m2T);
  p.ws = ws;
  p.wt = wt;
  p.lj = lj;
  p.E = E; p.A = A; p.K = K; p.n = n; p.k = k; p.has_t = has_t;
  p.nk = n * k;
  p.ntk = has_t ? n * n * k : 0;
  p.NB = p.nk + p.ntk;
  p.R = p.nk + n + (has_t ? n * n : 0);
  p.NG = 2 + (has_t ? 1 : 0);
  return p;
}

template <typename Rows, typename T, int C>
int fwd_t(Params<T> p, cudaStream_t strm) {
  const size_t smem = ((size_t)(p.nk + p.ntk) * (C + 1) + p.R * ET + ET * p.NB + 2 * ET + RS) *
                      sizeof(float);
  const int grid = (p.E + ET - 1) / ET;
  return launch(slot_fwd_kernel<T, C, Rows>, grid, NT, smem, strm, p);
}

template <typename Rows, typename T, int C>
int bwd_t(Params<T> p, int need_rows, int blocks, cudaStream_t strm) {
  const size_t floats = (size_t)(p.nk + p.ntk) * (C + 1) + (size_t)p.NB * C +
                        (size_t)p.A * C + p.R * ET + ET * p.NB + 3 * ET * C +
                        (need_rows ? ET * p.NB : 0) + 2 * ET + RS;
  const size_t smem = floats * sizeof(float);
  if (need_rows) return launch(slot_bwd_kernel<T, C, true, Rows>, blocks, NT, smem, strm, p);
  return launch(slot_bwd_kernel<T, C, false, Rows>, blocks, NT, smem, strm, p);
}

template <typename Rows, typename T, int C>
int bwd2_t(Params<T> p, int blocks, cudaStream_t strm) {
  const size_t jvp =
      ((size_t)(p.nk + p.ntk) * (C + 1) + 2 * p.R * ET + 2 * ET * p.NB + 2 * ET + RS) *
      sizeof(float);
  int rc = launch(slot_jvp_kernel<T, C, Rows>, (p.E + ET - 1) / ET, NT, jvp, strm, p);
  if (rc != 0) return rc;
  const size_t floats = (size_t)(p.nk + p.ntk) * (C + 1) + (size_t)p.NB * C +
                        (size_t)p.A * C + 2 * p.R * ET + 2 * ET * p.NB + 5 * ET * C + 2 * ET +
                        RS;
  return launch(slot_bwd2_kernel<T, C, Rows>, blocks, NT, floats * sizeof(float), strm, p);
}

template <typename Rows, typename T>
int fwd_c(Params<T> p, int C, cudaStream_t strm) {
  switch (C) {
    case 32: return fwd_t<Rows, T, 32>(p, strm);
    case 64: return fwd_t<Rows, T, 64>(p, strm);
    case 128: return fwd_t<Rows, T, 128>(p, strm);
    default: return ERR_SHAPE;
  }
}

template <typename Rows, typename T>
int bwd_c(Params<T> p, int C, int need_rows, int blocks, cudaStream_t strm) {
  switch (C) {
    case 32: return bwd_t<Rows, T, 32>(p, need_rows, blocks, strm);
    case 64: return bwd_t<Rows, T, 64>(p, need_rows, blocks, strm);
    case 128: return bwd_t<Rows, T, 128>(p, need_rows, blocks, strm);
    default: return ERR_SHAPE;
  }
}

template <typename Rows, typename T>
int bwd2_c(Params<T> p, int C, int blocks, cudaStream_t strm) {
  switch (C) {
    case 32: return bwd2_t<Rows, T, 32>(p, blocks, strm);
    case 64: return bwd2_t<Rows, T, 64>(p, blocks, strm);
    case 128: return bwd2_t<Rows, T, 128>(p, blocks, strm);
    default: return ERR_SHAPE;
  }
}

}  // namespace
