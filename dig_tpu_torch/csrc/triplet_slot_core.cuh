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
// A row source Rows provides, for one chunk of up to ET triplets (position
// ec of the chunk is triplet ids[ec] = s E + e, or (s, e0 + ec) when ids is
// null):
//   Rows::load<MODE>(p, s, e0, ids, cnt, ptc, m2c, ljc, u2c, rs): the rows
//     ptc [R][ET] in float32 (zero past cnt), the mask m2c [ET] (0 where lj
//     is outside [0, A)), the ids ljc [ET] and, in modes ROWS_TANGENT and
//     ROWS_JET, the rows' tangent u2c [R][ET] (the cotangent of the rows'
//     gradient in the second order); ROWS_GRAD also keeps in rs what
//     write_dpt needs, ROWS_JET what write_ptb needs;
//   Rows::write_dpt(p, s, ids, cnt, dbas, ptc, rs, spare): the backward's
//     output from the cotangent dbas [ET][NB] of (sbf | tbf), every chunk
//     position a real triplet; spare is Rows::dpt_spare(p) floats;
//   Rows::write_ptb(p, s, ids, cnt, bas, dbas, ptc, u2c, m2c, rs, spare): the
//     second order's output from the cotangents bas of (a | b) and dbas of
//     (da | db); spare is max(5 ET C, Rows::spare(p)) floats of dead shared
//     memory;
//   Rows::scratch(p, MODE): the floats of rs (shared scratch) it uses;
//   Rows::spare(p): the floats of spare that write_ptb uses;
//   Rows::dpt_spare(p): the floats of spare that write_dpt uses;
//   Rows::GEO: whether the rows' cotangent goes to dgeo [K, NG, E] (else
//     to dpt [K, R, E]); Rows::BWD2_THREADS: the threads of a second-order
//     block.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per block (slot_bwd2_kernel: Rows::BWD2_THREADS)
constexpr int ET = 32;      // edges per chunk: a warp's lanes (the second order's ballots)

// what Rows::load evaluates: the rows; the rows and what the backward's
// write_dpt needs; the rows and their tangent; the rows, their tangent and
// what the second order's write_ptb needs
enum RowsMode { ROWS_VALUE, ROWS_GRAD, ROWS_TANGENT, ROWS_JET };

// The (s, e) of chunk position ec: ids[ec] = s E + e (a triplet), or
// (s, e0 + ec) when ids is null.
__device__ __forceinline__ void triplet_at(int E, int s, int e0, const int* ids, int ec, int& ts,
                                           int& te) {
  if (ids == nullptr) {
    ts = s;
    te = e0 + ec;
  } else {
    ts = ids[ec] / E;
    te = ids[ec] - ts * E;
  }
}

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
  for (int x = threadIdx.x; x < p.nk * C; x += blockDim.x) ws_s[(x / C) * (C + 1) + x % C] = p.ws[x];
  for (int x = threadIdx.x; x < p.ntk * C; x += blockDim.x) wt_s[(x / C) * (C + 1) + x % C] = p.wt[x];
}

// bas [ET][NB]: sbf (rows < nk) then tbf, rounded to T.
template <typename T>
__device__ void form_basis(const Params<T>& p, const float* ptc, float* bas) {
  const int nk = p.nk, k = p.k;
  for (int x = threadIdx.x; x < ET * p.NB; x += blockDim.x) {
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

// dbas [ET][NB]: the tangents of sbf and tbf along u2 (product rule), not
// rounded: d sbf[l*k+m] = ub y0 + bt uy0, d tbf[i] = uyt bt + yt ub.
template <typename T>
__device__ void form_tangent(const Params<T>& p, const float* ptc, const float* u2c,
                             float* dbas) {
  const int nk = p.nk, k = p.k;
  for (int x = threadIdx.x; x < ET * p.NB; x += blockDim.x) {
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

// sv, tv of the chunk positions eg + EG q, q < nq, at channel c (the
// basis products' chains, below) and their tangents dsv = da @ ws[:, c] + a @
// u4[:, c], dtv = db @ wt[:, c] + b @ u5[:, c] (dtv = 0 without torsion;
// the u4 / u5 terms only when given), as a register tile: each weight is
// loaded once for the thread's positions.
template <int C, int EG, int EPT, typename T>
__device__ __forceinline__ void tiled_products(const Params<T>& p, const float* bas,
                                               const float* dbas, const float* ws_s,
                                               const float* wt_s, int c, int eg, int nq,
                                               float (&sv)[EPT], float (&tv)[EPT],
                                               float (&dsv)[EPT], float (&dtv)[EPT]) {
  const int nk = p.nk, ntk = p.ntk, NB = p.NB;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    sv[q] = dsv[q] = dtv[q] = 0.f;
    tv[q] = ntk > 0 ? 0.f : 1.f;
  }
  const float* b0 = bas + eg * NB;
  const float* d0 = dbas + eg * NB;
  for (int r = 0; r < nk; ++r) {
    const float w = ws_s[r * (C + 1) + c];
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      if (q < nq) {
        sv[q] = fmaf(b0[q * EG * NB + r], w, sv[q]);
        dsv[q] = fmaf(d0[q * EG * NB + r], w, dsv[q]);
      }
    }
  }
  if (p.u4 != nullptr) {
    for (int r = 0; r < nk; ++r) {
      const float u = __ldg(p.u4 + r * C + c);
#pragma unroll
      for (int q = 0; q < EPT; ++q)
        if (q < nq) dsv[q] = fmaf(b0[q * EG * NB + r], u, dsv[q]);
    }
  }
  for (int i = 0; i < ntk; ++i) {
    const float w = wt_s[i * (C + 1) + c];
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      if (q < nq) {
        tv[q] = fmaf(b0[q * EG * NB + nk + i], w, tv[q]);
        dtv[q] = fmaf(d0[q * EG * NB + nk + i], w, dtv[q]);
      }
    }
  }
  if (ntk > 0 && p.u5 != nullptr) {
    for (int i = 0; i < ntk; ++i) {
      const float u = __ldg(p.u5 + i * C + c);
#pragma unroll
      for (int q = 0; q < EPT; ++q)
        if (q < nq) dtv[q] = fmaf(b0[q * EG * NB + nk + i], u, dtv[q]);
    }
  }
}

// Floats of slot_jvp_kernel's stage: the chunk's rows, their tangent and
// sbf / tbf, then the four [ET][C] factors of its terms over the same place.
template <typename T>
__host__ __device__ inline int jvp_stage(const Params<T>& p, int C) {
  const int rows = 2 * p.R * ET + 2 * ET * p.NB;
  return rows > 4 * ET * C ? rows : 4 * ET * C;
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

// The packed table as the row source: pt[s, :, e] (and u2's) read as they
// are; dpt and ptb written row by row.
struct PtRows {
  static constexpr bool GEO = false;
  static constexpr int BWD2_THREADS = 256;

  template <typename T>
  static __host__ __device__ int scratch(const Params<T>&, int) { return 0; }
  template <typename T>
  static __host__ __device__ int spare(const Params<T>&) { return 0; }
  template <typename T>
  static int dpt_spare(const Params<T>&) { return 0; }

  template <int MODE, typename T>
  static __device__ void load(const Params<T>& p, int s, int e0, const int* ids, int cnt,
                              float* ptc, float* m2c, int* ljc, float* u2c, float*) {
    for (int x = threadIdx.x; x < p.R * ET; x += blockDim.x) {
      const int r = x / ET, ec = x % ET;
      float v = 0.f, u = 0.f;
      if (ec < cnt) {
        int ts, te;
        triplet_at(p.E, s, e0, ids, ec, ts, te);
        const size_t at = ((size_t)ts * p.R + r) * p.E + te;
        v = ld(p.pt + at);
        if (MODE >= ROWS_TANGENT && p.u2 != nullptr) u = ld(p.u2 + at);
      }
      ptc[x] = v;
      if constexpr (MODE >= ROWS_TANGENT) u2c[x] = u;
    }
    for (int ec = threadIdx.x; ec < ET; ec += blockDim.x) {
      float m = 0.f;
      int j = 0;
      if (ec < cnt) {
        int ts, te;
        triplet_at(p.E, s, e0, ids, ec, ts, te);
        j = p.lj[te];
        m = (j >= 0 && j < p.A) ? ld(p.m2T + (size_t)ts * p.E + te) : 0.f;
      }
      m2c[ec] = m;
      ljc[ec] = m != 0.f ? j : 0;
    }
  }

  template <typename T>
  static __device__ void write_dpt(const Params<T>& p, int s, const int* ids, int cnt,
                                   const float* dbas, const float* ptc, const float*, float*) {
    for (int x = threadIdx.x; x < p.R * ET; x += blockDim.x) {
      const int r = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      p.dpt[((size_t)s * p.R + r) * p.E + ids[ec] - s * p.E] =
          basis_adjoint(p, dbas + ec * p.NB, ptc, r, ec);
    }
  }

  template <typename T>
  static __device__ void write_ptb(const Params<T>& p, int s, const int* ids, int cnt,
                                   const float* bas, const float* dbas, const float* ptc,
                                   const float* u2c, const float*, const float*, float*) {
    for (int x = threadIdx.x; x < p.R * ET; x += blockDim.x) {
      const int r = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      p.dpt[((size_t)s * p.R + r) * p.E + ids[ec] - s * p.E] =
          basis_adjoint(p, bas + ec * p.NB, ptc, r, ec) + basis_adjoint(p, dbas + ec * p.NB, u2c, r, ec);
    }
  }
};

// The basis products: sv = sbf @ ws[:, c] and tv = tbf @ wt[:, c] (tv = 1
// without torsion), each a chain of fmaf in row order from 0. Here of the
// chunk positions q0 .. q0 + EPT - 1 from the basis by rows, bas [NB][ET],
// as a register tile: each weight loaded once for the thread's positions,
// their basis values 16 bytes at a time.
template <int C, int EPT, typename T>
__device__ __forceinline__ void tiled_sv_tv_by_row(const Params<T>& p, const float* bas,
                                                   const float* ws_s, const float* wt_s, int c,
                                                   int q0, float (&sv)[EPT], float (&tv)[EPT]) {
  static_assert(EPT % 4 == 0, "positions come four at a time");
  const int nk = p.nk, ntk = p.ntk;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    sv[q] = 0.f;
    tv[q] = ntk > 0 ? 0.f : 1.f;
  }
  for (int r = 0; r < nk; ++r) {
    const float w = ws_s[r * (C + 1) + c];
    const float4* b = reinterpret_cast<const float4*>(bas + r * ET + q0);
#pragma unroll
    for (int u = 0; u < EPT / 4; ++u) {
      const float4 v = b[u];
      sv[4 * u] = fmaf(v.x, w, sv[4 * u]);
      sv[4 * u + 1] = fmaf(v.y, w, sv[4 * u + 1]);
      sv[4 * u + 2] = fmaf(v.z, w, sv[4 * u + 2]);
      sv[4 * u + 3] = fmaf(v.w, w, sv[4 * u + 3]);
    }
  }
  for (int i = 0; i < ntk; ++i) {
    const float w = wt_s[i * (C + 1) + c];
    const float4* b = reinterpret_cast<const float4*>(bas + (nk + i) * ET + q0);
#pragma unroll
    for (int u = 0; u < EPT / 4; ++u) {
      const float4 v = b[u];
      tv[4 * u] = fmaf(v.x, w, tv[4 * u]);
      tv[4 * u + 1] = fmaf(v.y, w, tv[4 * u + 1]);
      tv[4 * u + 2] = fmaf(v.z, w, tv[4 * u + 2]);
      tv[4 * u + 3] = fmaf(v.w, w, tv[4 * u + 3]);
    }
  }
}

// The rows whose product is basis row r (sbf | tbf): fa[r] and fb[r], so
// that form_basis takes bas[r] = ptc[fa[r]] ptc[fb[r]], for r < NB, by the
// block's threads.
template <typename T>
__device__ void basis_factors(const Params<T>& p, int* fa, int* fb) {
  const int nk = p.nk, k = p.k;
  for (int r = threadIdx.x; r < p.NB; r += blockDim.x) {
    const int i = r - nk;
    fa[r] = r < nk ? r : nk + p.n + i / k;
    fb[r] = r < nk ? nk + r / k : i % nk;
  }
}

// bas [NB][ET]: form_basis by rows, from the factor rows fa, fb.
template <typename T>
__device__ void form_basis_by_row(const Params<T>& p, const int* fa, const int* fb,
                                  const float* ptc, float* bas) {
  for (int x = threadIdx.x; x < ET * p.NB; x += blockDim.x) {
    const int r = x / ET, ec = x % ET;
    bas[x] = rnd<IS_BF16<T>>(ptc[fa[r] * ET + ec] * ptc[fb[r] * ET + ec]);
  }
}

// The real triplets (lj inside the slot, m2T set) of the ne edges from e0,
// s-major, a ballot per (s, warp): smask[s] the ballot of s, pairs[0, nl)
// their s E + e and, when loc is given, loc[0, nl) their s ET + e - e0.
// Returns nl; ends with the list written and visible.
template <typename T>
__device__ int list_edge_triplets(const Params<T>& p, int e0, int ne, unsigned* smask,
                                  int* pairs, int* loc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int s = warp; s < p.K; s += nw) {
    bool real = false;
    if (lane < ne) {
      const int j = p.lj[e0 + lane];
      real = j >= 0 && j < p.A && ld(p.m2T + (size_t)s * p.E + e0 + lane) != 0.f;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) smask[s] = mask;
  }
  __syncthreads();
  int nl = 0;
  for (int s = 0; s < p.K; ++s) nl += __popc(smask[s]);
  for (int s = warp; s < p.K; s += nw) {
    int at = 0;
    for (int s2 = 0; s2 < s; ++s2) at += __popc(smask[s2]);
    const unsigned mask = smask[s];
    if ((mask >> lane) & 1u) {
      const int q = at + __popc(mask & ((1u << lane) - 1u));
      pairs[q] = s * p.E + e0 + lane;
      if (loc != nullptr) loc[q] = s * ET + lane;
    }
  }
  __syncthreads();
  return nl;
}

// The floats of slot_fwd_kernel's shared memory.
template <typename Rows, int C, typename T>
__host__ int fwd_floats(const Params<T>& p) {
  return p.NB * ET + p.R * ET + 3 * ET * C + (p.nk + p.ntk) * (C + 1) + 3 * ET + 2 * p.NB +
         p.K * (2 * ET + 1) + Rows::scratch(p, ROWS_VALUE);
}

// The forward. A block owns ET edges (out's rows) and first lists their
// real triplets (lj inside the slot, m2T set) s-major, a ballot per s, then
// walks the list ET triplets at a time: the rows, sbf / tbf and the
// products only where they count (57-60% of the triplets are masked at the
// force bench's buckets). Per chunk, thread (c, eg) forms sv and tv of the
// chunk positions EPT eg .. EPT eg + EPT - 1 as a register tile, and
// leaves xv sv and tv in shared memory; then the thread owning each (edge,
// channel) (edges b with b % EG == eg) adds its edge's terms acc +=
// (xv sv) tv in list order, that is in s order, as the walk over every s
// added them: every output keeps its bits. Edges without a real triplet
// get 0. The basis rows' factors and each listed triplet's (s, edge) are
// tabled once a block, so that no runtime division is left in the walk
// but the row source's own.
template <typename T, int C, typename Rows>
__global__ void __launch_bounds__(NT) slot_fwd_kernel(Params<T> p) {
  constexpr int EG = NT / C;    // position groups
  constexpr int EPT = ET / EG;  // positions a thread
  extern __shared__ __align__(16) float smem[];
  const int K = p.K;
  float* bas = smem;                            // [NB][ET] sbf | tbf by row
  float* ptc = bas + p.NB * ET;                 // [R][ET]
  float* fp = ptc + p.R * ET;                   // [ET][C] xv sv of each position
  float* ftv = fp + ET * C;                     // [ET][C] tv of each position
  float* acc = ftv + ET * C;                    // [ET][C] out of the block's edges
  float* ws_s = acc + ET * C;                   // [nk][C+1]
  float* wt_s = ws_s + p.nk * (C + 1);          // [ntk][C+1]
  float* m2c = wt_s + p.ntk * (C + 1);          // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]
  int* xbs = ljc + ET;                          // [ET] slot(e0 + b) A
  int* fa = xbs + ET;                           // [NB] basis_factors
  int* fb = fa + p.NB;                          // [NB]
  unsigned* smask = reinterpret_cast<unsigned*>(fb + p.NB);  // [K] real edges of each s
  int* pairs = reinterpret_cast<int*>(smask + K);            // [K * ET] s E + e, s-major
  int* loc = pairs + K * ET;                                 // [K * ET] s ET + e - e0
  float* rs = reinterpret_cast<float*>(loc + K * ET);        // [Rows::scratch]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int e0 = blockIdx.x * ET;
  const int ne = min(ET, p.E - e0);
  load_weights<C>(p, ws_s, wt_s);
  basis_factors(p, fa, fb);
  // x's rows of edge e0 + b are (xbs[b] + lj) K + s
  for (int b = tid; b < ET; b += NT) xbs[b] = (e0 + b) / (p.A * K) * p.A;
  for (int x = tid; x < ET * C; x += NT) acc[x] = 0.f;
  const int nl = list_edge_triplets(p, e0, ne, smask, pairs, loc);

  for (int c0 = 0; c0 < nl; c0 += ET) {
    const int cnt = min(ET, nl - c0);
    // the previous chunk read bas before its last barrier and ptc, m2c,
    // ljc before that; its sums read fp and ftv, written again only after
    // this chunk's next two barriers
    Rows::template load<ROWS_VALUE>(p, 0, 0, pairs + c0, cnt, ptc, m2c, ljc, nullptr, rs);
    __syncthreads();
    form_basis_by_row(p, fa, fb, ptc, bas);
    __syncthreads();
    {
      const int q0 = eg * EPT;
      float sv[EPT], tv[EPT];
      tiled_sv_tv_by_row<C, EPT>(p, bas, ws_s, wt_s, c, q0, sv, tv);
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int ec = q0 + q;
        if (ec < cnt) {
          const int l = loc[c0 + ec], s = l / ET, b = l % ET;
          const size_t row = ((size_t)xbs[b] + ljc[ec]) * K + s;
          const float xv = m2c[ec] * rnd<IS_BF16<T>>(ld(p.x + row * C + c));
          fp[ec * C + c] = xv * sv[q];
          ftv[ec * C + c] = tv[q];
        }
      }
    }
    __syncthreads();
    // thread (c, eg) owns the edges b with b % EG == eg
    for (int ec = 0; ec < cnt; ++ec) {
      const int b = loc[c0 + ec] % ET;
      if (b % EG == eg) acc[b * C + c] = fmaf(fp[ec * C + c], ftv[ec * C + c], acc[b * C + c]);
    }
  }
  // each thread writes the entries it owns (x = b C + c, b % EG == eg)
  for (int x = tid; x < ne * C; x += NT) st(p.out + (size_t)e0 * C + x, acc[x]);
}

// sv and tv of the chunk positions eg + EG q, q < nq, from the basis by
// positions, bas [ET][NB]: the basis products' chains as a register tile,
// each weight loaded once for the thread's positions.
template <int C, int EG, int EPT, typename T>
__device__ __forceinline__ void tiled_sv_tv(const Params<T>& p, const float* bas,
                                            const float* ws_s, const float* wt_s, int c, int eg,
                                            int nq, float (&sv)[EPT], float (&tv)[EPT]) {
  const int nk = p.nk, ntk = p.ntk, NB = p.NB;
  const float* b0 = bas + eg * NB;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    sv[q] = 0.f;
    tv[q] = ntk > 0 ? 0.f : 1.f;
  }
  for (int r = 0; r < nk; ++r) {
    const float w = ws_s[r * (C + 1) + c];
#pragma unroll
    for (int q = 0; q < EPT; ++q)
      if (q < nq) sv[q] = fmaf(b0[q * EG * NB + r], w, sv[q]);
  }
  for (int i = 0; i < ntk; ++i) {
    const float w = wt_s[i * (C + 1) + c];
#pragma unroll
    for (int q = 0; q < EPT; ++q)
      if (q < nq) tv[q] = fmaf(b0[q * EG * NB + nk + i], w, tv[q]);
  }
}

// The floats of slot_bwd_kernel's shared memory from ws_s on (bwd_t).
template <typename Rows, int C, typename T>
__host__ int bwd_floats(const Params<T>& p, bool dpt) {
  const int NTW = NT / 32;
  return (p.nk + p.ntk) * (C + 1) + p.NB * C + p.A * C + p.R * ET + ET * p.NB + 3 * ET * C +
         (dpt ? ET * p.NB : 0) + 2 * ET + p.A * p.K + NTW + NT / C +
         Rows::scratch(p, dpt && Rows::GEO ? ROWS_GRAD : ROWS_VALUE) +
         (dpt ? Rows::dpt_spare(p) : 0);
}

// The backward: one block per (slot, s). The block first lists its real
// triplets' edges in edge order (a ballot a warp, as slot_bwd2_kernel; the
// rows' cotangent of every other edge is written as zeros) and walks them
// in chunks of ET, so the rows, the products and every cotangent are formed
// only where they count. Per chunk: the rows (with DPT over the geometry,
// also the rows' gradients, each once per (row, real triplet) across the
// block); sv, tv and the per-triplet cotangents dxg = m g sv tv, dsv = g tv
// xv, dtv = g xv sv as a register tile of EPT edges a thread; the weight
// gradients (the thread's entries, rows eg + EG i at channel c, WT rows in
// registers at a time) and, in the same phase, the dx rows (thread (c, jg)
// walks only the chunk's edges of its rows, from a ballot per row group)
// and with DPT the basis cotangents d sbf | d tbf = dsv @ ws^T | dtv @
// wt^T as TE x TR tiles; then Rows::write_dpt. Every sum keeps its order
// over the real edges (edge order), as the masked walk over all edges added
// them: the outputs do not depend on the chunking.
template <typename T, int C, bool DPT, typename Rows>
__global__ void __launch_bounds__(NT, 2) slot_bwd_kernel(Params<T> p) {
  constexpr int EG = NT / C;
  constexpr int EPT = ET / EG;
  constexpr int WT = 18;          // weight-gradient rows of a register tile
  constexpr int TE = 4, TR = 3;   // basis-cotangent tile: edges x rows (TR odd: no bank
                                  // conflicts on the weights' C + 1 stride)
  constexpr int MODE = DPT && Rows::GEO ? ROWS_GRAD : ROWS_VALUE;
  extern __shared__ __align__(16) float smem[];
  const int nk = p.nk, ntk = p.ntk, NB = p.NB, A = p.A, K = p.K;
  const int SE = A * K;
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
  int* live = ljc + ET;                         // [SE] the real triplets, s E + e
  int* wcnt = live + SE;                        // [NT / 32]
  unsigned* jm = reinterpret_cast<unsigned*>(wcnt + NT / 32);  // [EG] chunk edges per row group
  float* rs = reinterpret_cast<float*>(jm + EG);               // [Rows::scratch]
  float* spare = rs + (DPT ? Rows::scratch(p, MODE) : 0);      // [Rows::dpt_spare] (DPT)

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x / K, s = blockIdx.x % K;
  const int base = g * SE;
  load_weights<C>(p, ws_s, wt_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  for (int x = tid; x < A * C; x += NT) dx_s[x] = 0.f;

  // the real triplets (lj inside the slot, m2T set), in edge order; with
  // DPT the rows' cotangent of the others is 0
  float* rows_out = Rows::GEO ? p.dgeo : p.dpt;
  const int nout = Rows::GEO ? p.NG : p.R;
  int nl = 0;
  for (int b0 = 0; b0 < SE; b0 += NT) {
    const int e = base + b0 + tid;
    bool real = false;
    if (b0 + tid < SE) {
      const int j = p.lj[e];
      real = j >= 0 && j < A && ld(p.m2T + (size_t)s * p.E + e) != 0.f;
      if (DPT && !real) {
        for (int i = 0; i < nout; ++i) rows_out[((size_t)s * nout + i) * p.E + e] = 0.f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) wcnt[warp] = __popc(mask);
    __syncthreads();
    int at = nl;
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) at += wcnt[w];
      nl += wcnt[w];
    }
    if (real) live[at + __popc(mask & ((1u << lane) - 1u))] = s * p.E + e;
    __syncthreads();
  }

  for (int c0 = 0; c0 < nl; c0 += ET) {
    const int cnt = min(ET, nl - c0);
    const int* ids = live + c0;
    __syncthreads();
    Rows::template load<MODE>(p, s, 0, ids, cnt, ptc, m2c, ljc, nullptr, rs);
    __syncthreads();
    form_basis(p, ptc, bas);
    if (warp == 0) {
      // the chunk's edges of each row group jg (rows j with j % EG == jg)
      const int j = lane < cnt ? ljc[lane] : -1;
      for (int jg = 0; jg < EG; ++jg) {
        const unsigned m = __ballot_sync(0xffffffffu, j >= 0 && j % EG == jg);
        if (lane == 0) jm[jg] = m;
      }
    }
    __syncthreads();
    // per-triplet cotangents: dxg = m g sv tv, dsv = g tv xv, dtv = g xv sv
    {
      float sv[EPT], tv[EPT];
      const int nq = min(EPT, (cnt - eg + EG - 1) / EG);
      tiled_sv_tv<C, EG, EPT>(p, bas, ws_s, wt_s, c, eg, nq, sv, tv);
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        if (q < nq) {
          const int ec = eg + EG * q;
          const float m = m2c[ec];
          const size_t row = ((size_t)g * A + ljc[ec]) * K + s;
          const float xv = m * rnd<IS_BF16<T>>(ld(p.x + row * C + c));
          const float go = p.ct[(size_t)(ids[ec] - s * p.E) * C + c];
          const float gt = go * tv[q];
          dxg[ec * C + c] = (gt * sv[q]) * m;
          dsv[ec * C + c] = gt * xv;
          dtv[ec * C + c] = go * (xv * sv[q]);
        }
      }
    }
    __syncthreads();
    // weight gradients: the thread's entries (rows eg + EG i, channel c),
    // WT rows in registers at a time, each in edge order
    for (int i0 = 0; i0 * EG + eg < NB; i0 += WT) {
      float acc[WT];
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        const int r = eg + EG * (i0 + t);
        acc[t] = r < NB ? dW_s[r * C + c] : 0.f;
      }
      for (int ec = 0; ec < cnt; ++ec) {
        const float ds = dsv[ec * C + c], dt = dtv[ec * C + c];
        const float* b = bas + ec * NB;
#pragma unroll
        for (int t = 0; t < WT; ++t) {
          const int r = eg + EG * (i0 + t);
          if (r < NB) acc[t] = fmaf(b[r], r < nk ? ds : dt, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        const int r = eg + EG * (i0 + t);
        if (r < NB) dW_s[r * C + c] = acc[t];
      }
    }
    // dx rows (j, s): thread (c, jg) adds its rows' edges, in edge order
    for (unsigned m = jm[eg]; m != 0u; m &= m - 1u) {
      const int ec = __ffs(m) - 1;
      dx_s[ljc[ec] * C + c] += dxg[ec * C + c];
    }
    if constexpr (DPT) {
      // d sbf = dsv @ ws^T, d tbf = dtv @ wt^T: TE edges x TR rows a thread,
      // rows of one tile all of sbf's or all of tbf's, each sum over c from 0
      const int rts = (nk + TR - 1) / TR;
      const int rtl = rts + (ntk + TR - 1) / TR;
      const int etl = (cnt + TE - 1) / TE;
      for (int t = tid; t < etl * rtl; t += NT) {
        const int et = t / rtl, rt = t % rtl;
        const bool sr = rt < rts;
        const int r0 = sr ? rt * TR : nk + (rt - rts) * TR;
        const int r1 = sr ? nk : NB;
        const float* P = sr ? dsv : dtv;
        const float* w[TR];
        int ecs[TE];
#pragma unroll
        for (int i = 0; i < TR; ++i) w[i] = ws_s + min(r0 + i, r1 - 1) * (C + 1);
#pragma unroll
        for (int e = 0; e < TE; ++e) ecs[e] = min(et * TE + e, cnt - 1) * C;
        float gacc[TE][TR];
#pragma unroll
        for (int e = 0; e < TE; ++e)
#pragma unroll
          for (int i = 0; i < TR; ++i) gacc[e][i] = 0.f;
        for (int cc = 0; cc < C; ++cc) {
          float pv[TE], wv[TR];
#pragma unroll
          for (int e = 0; e < TE; ++e) pv[e] = P[ecs[e] + cc];
#pragma unroll
          for (int i = 0; i < TR; ++i) wv[i] = w[i][cc];
#pragma unroll
          for (int e = 0; e < TE; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) gacc[e][i] = fmaf(pv[e], wv[i], gacc[e][i]);
        }
#pragma unroll
        for (int e = 0; e < TE; ++e) {
          const int ec = et * TE + e;
          if (ec >= cnt) continue;
#pragma unroll
          for (int i = 0; i < TR; ++i)
            if (r0 + i < r1) dbas[ec * NB + r0 + i] = gacc[e][i];
        }
      }
      __syncthreads();
      // back through the products to the rows
      Rows::write_dpt(p, s, ids, cnt, dbas, ptc, rs, spare);
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
// the forward's linearisation along (u1, u2, u4, u5). A block owns 32
// edges (ctb's rows) and first lists their real triplets s-major (a ballot
// per s), then walks the list 32 triplets at a time: the rows, sbf / tbf
// and the products only where m2T is set. Each triplet's factors go to
// shared memory (over the chunk's dead rows) and its term is added to its
// edge's sum by the thread owning that (edge, channel), in list order:
// each edge's terms in s order, as the walk over s added them, and as
// acc + fma(Y, dtv, X tv) with X = fma(dg, sv, g dsv), Y = g sv, the
// rounding the walk's acc += X tv + Y dtv compiled to (its ctb bits).
template <typename T, int C, typename Rows>
__global__ void __launch_bounds__(NT) slot_jvp_kernel(Params<T> p) {
  constexpr int EG = NT / C;
  constexpr int EPT = ET / EG;
  extern __shared__ __align__(16) float smem[];
  const int K = p.K;
  float* ws_s = smem;                           // [nk][C+1]
  float* wt_s = ws_s + p.nk * (C + 1);          // [ntk][C+1]
  float* ptc = wt_s + p.ntk * (C + 1);          // [R][ET]
  float* u2c = ptc + p.R * ET;                  // [R][ET]
  float* bas = u2c + p.R * ET;                  // [ET][NB]
  float* dbas = bas + ET * p.NB;                // [ET][NB]
  float* fx = ptc;                              // [ET][C] X, then Y, tv, dtv over the
  float* fy = fx + ET * C;                      // rows' region once the products are
  float* ftv = fy + ET * C;                     // formed (jvp_stage floats in all)
  float* fdtv = ftv + ET * C;
  float* acc = ptc + jvp_stage(p, C);           // [ET][C] ctb of the block's edges
  float* m2c = acc + ET * C;                    // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]
  int* eb = ljc + ET;                           // [ET] the chunk's edges - e0
  unsigned* smask = reinterpret_cast<unsigned*>(eb + ET);  // [K] real edges of each s
  int* pairs = reinterpret_cast<int*>(smask + K);          // [K * ET] s E + e, s-major
  float* rs = reinterpret_cast<float*>(pairs + K * ET);    // [Rows::scratch]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int e0 = blockIdx.x * ET;
  const int ne = min(ET, p.E - e0);
  const int SE = p.A * K;
  load_weights<C>(p, ws_s, wt_s);
  for (int x = tid; x < ET * C; x += NT) acc[x] = 0.f;
  const int nl = list_edge_triplets(p, e0, ne, smask, pairs, nullptr);

  for (int c0 = 0; c0 < nl; c0 += ET) {
    const int cnt = min(ET, nl - c0);
    const int* ids = pairs + c0;
    __syncthreads();
    Rows::template load<ROWS_TANGENT>(p, 0, 0, ids, cnt, ptc, m2c, ljc, u2c, rs);
    __syncthreads();
    form_basis(p, ptc, bas);
    form_tangent(p, ptc, u2c, dbas);
    __syncthreads();
    {
      float sv[EPT], tv[EPT], dsv[EPT], dtv[EPT], X[EPT], Y[EPT];
      const int nq = min(EPT, (cnt - eg + EG - 1) / EG);
      tiled_products<C, EG, EPT>(p, bas, dbas, ws_s, wt_s, c, eg, nq, sv, tv, dsv, dtv);
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        X[q] = Y[q] = 0.f;
        if (q < nq) {
          const int ec = eg + EG * q;
          int s, e;
          triplet_at(p.E, 0, 0, ids, ec, s, e);
          const float m = m2c[ec];
          const size_t row = ((size_t)(e / SE) * p.A + ljc[ec]) * K + s;
          const float gv = m * rnd<IS_BF16<T>>(ld(p.x + row * C + c));
          const float dg = p.u1 != nullptr ? m * ld(p.u1 + row * C + c) : 0.f;
          X[q] = fmaf(dg, sv[q], gv * dsv[q]);
          Y[q] = gv * sv[q];
          if (c == 0) eb[ec] = e - e0;
        }
      }
      __syncthreads();  // the rows' region is dead: the factors go there
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        if (q < nq) {
          const int at = (eg + EG * q) * C + c;
          fx[at] = X[q];
          fy[at] = Y[q];
          ftv[at] = tv[q];
          fdtv[at] = dtv[q];
        }
      }
    }
    __syncthreads();
    // thread (c, eg) owns the edges b with b % EG == eg
    for (int ec = 0; ec < cnt; ++ec) {
      const int b = eb[ec];
      if (b % EG == eg) {
        const int at = ec * C + c;
        acc[b * C + c] =
            __fadd_rn(acc[b * C + c], fmaf(fy[at], fdtv[at], __fmul_rn(fx[at], ftv[at])));
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < ne * C; x += NT) p.ctb[(size_t)e0 * C + x] = acc[x];
}

// Second order, part 2: xb, the rows' cotangent and the wsb / wtb partials,
// one block per (slot, s) as the backward. Per real triplet and channel,
// with go = ct m: Psv = go (dg tv + g dtv) and Ptv = go (dg sv + g dsv) are
// the cotangents of sv and tv, Qsv = go g tv and Qtv = go g sv those of dsv
// and dtv, and xg = go (dsv tv + sv dtv) that of the gathered x row.
//
// The block first lists its real triplets' edges in edge order (a ballot a
// warp; the rows' cotangent of every other edge is written as zeros) and
// walks them in chunks of ET: every edge of a chunk is real, so the rows,
// the products and the cotangents are formed only where they count. Every
// sum still runs in edge order over the real edges, as the masked walk over
// all edges added them, so the outputs do not depend on the chunking.
// Register tiles: each thread's sv, tv, dsv, dtv over its EPT edges (a
// weight loaded once for all of them); the wsb | wtb entries a thread owns
// (its channel, rows eg + EG i) WT at a time, P and Q loaded once an edge;
// the (a | b) cotangents as TE edges x TR rows, P, Q and the weights loaded
// once a channel. No entry's chain of fmaf changes.
// The floats from Psv to m2c in slot_bwd2_kernel: P, Q and xg, or what
// Rows::write_ptb puts there once they are dead, whichever is more.
template <typename Rows, int C, typename T>
__host__ __device__ int bwd2_spare(const Params<T>& p) {
  const int pq = 5 * ET * C, w = Rows::spare(p);
  return pq > w ? pq : w;
}

template <typename T, int C, typename Rows>
__global__ void __launch_bounds__(Rows::BWD2_THREADS, 512 / Rows::BWD2_THREADS)
slot_bwd2_kernel(Params<T> p) {
  constexpr int NTB = Rows::BWD2_THREADS;
  constexpr int EG = NTB / C;
  constexpr int EPT = ET / EG;
  static_assert(NTB % C == 0 && ET % EG == 0, "channels must tile the block and the chunk");
  constexpr int WT = 9;          // wsb | wtb rows of a register tile
  constexpr int TE = 4, TR = 3;  // (a | b) cotangent tile: edges x rows (TR odd: no bank
                                 // conflicts on the weights' C + 1 stride)
  extern __shared__ __align__(16) float smem[];
  const int nk = p.nk, ntk = p.ntk, NB = p.NB, A = p.A, K = p.K;
  const int SE = A * K;
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
  float* m2c = Psv + bwd2_spare<Rows, C>(p);    // [ET]
  int* ljc = reinterpret_cast<int*>(m2c + ET);  // [ET]
  int* live = ljc + ET;                         // [SE] the real triplets, s E + e
  int* wcnt = live + SE;                        // [NTB / 32]
  float* rs = reinterpret_cast<float*>(wcnt + NTB / 32);  // [Rows::scratch]

  const int tid = threadIdx.x, c = tid % C, eg = tid / C;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x / K, s = blockIdx.x % K;
  const int base = g * SE;
  load_weights<C>(p, ws_s, wt_s);
  for (int x = tid; x < NB * C; x += NTB) dW_s[x] = 0.f;
  for (int x = tid; x < A * C; x += NTB) dx_s[x] = 0.f;

  // the real triplets (lj inside the slot, m2T set), in edge order; the
  // rows' cotangent of the others is 0
  float* rows_out = Rows::GEO ? p.dgeo : p.dpt;
  const int nout = Rows::GEO ? p.NG : p.R;
  int nl = 0;
  for (int b0 = 0; b0 < SE; b0 += NTB) {
    const int e = base + b0 + tid;
    bool real = false;
    if (b0 + tid < SE) {
      const int j = p.lj[e];
      real = j >= 0 && j < A && ld(p.m2T + (size_t)s * p.E + e) != 0.f;
      if (!real) {
        for (int i = 0; i < nout; ++i) rows_out[((size_t)s * nout + i) * p.E + e] = 0.f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) wcnt[warp] = __popc(mask);
    __syncthreads();
    int at = nl;
    for (int w = 0; w < NTB / 32; ++w) {
      if (w < warp) at += wcnt[w];
      nl += wcnt[w];
    }
    if (real) live[at + __popc(mask & ((1u << lane) - 1u))] = s * p.E + e;
    __syncthreads();
  }

  for (int c0 = 0; c0 < nl; c0 += ET) {
    const int cnt = min(ET, nl - c0);
    const int* ids = live + c0;
    __syncthreads();
    Rows::template load<ROWS_JET>(p, s, 0, ids, cnt, ptc, m2c, ljc, u2c, rs);
    __syncthreads();
    form_basis(p, ptc, bas);
    form_tangent(p, ptc, u2c, dbas);
    __syncthreads();
    {
      float sv[EPT], tv[EPT], dsv[EPT], dtv[EPT];
      const int nq = min(EPT, (cnt - eg + EG - 1) / EG);  // the thread's edges in the chunk
      tiled_products<C, EG, EPT>(p, bas, dbas, ws_s, wt_s, c, eg, nq, sv, tv, dsv, dtv);
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        if (q < nq) {
          const int ec = eg + EG * q;
          const size_t row = ((size_t)g * A + ljc[ec]) * K + s;
          const float gv = rnd<IS_BF16<T>>(ld(p.x + row * C + c));
          const float dg = p.u1 != nullptr ? ld(p.u1 + row * C + c) : 0.f;
          const float go = p.ct[(size_t)(ids[ec] - s * p.E) * C + c] * m2c[ec];
          Qsv[ec * C + c] = go * (gv * tv[q]);
          Qtv[ec * C + c] = go * (gv * sv[q]);
          Psv[ec * C + c] = go * fmaf(dg, tv[q], gv * dtv[q]);
          Ptv[ec * C + c] = go * fmaf(dg, sv[q], gv * dsv[q]);
          xg[ec * C + c] = go * fmaf(dsv[q], tv[q], sv[q] * dtv[q]);
        }
      }
    }
    __syncthreads();
    // wsb | wtb: the thread's entries (rows eg + EG i, channel c), WT rows
    // in registers at a time, each in edge order
    for (int i0 = 0; i0 * EG + eg < NB; i0 += WT) {
      float acc[WT];
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        const int r = eg + EG * (i0 + t);
        acc[t] = r < NB ? dW_s[r * C + c] : 0.f;
      }
      for (int ec = 0; ec < cnt; ++ec) {
        const float ps = Psv[ec * C + c], pt = Ptv[ec * C + c];
        const float qs = Qsv[ec * C + c], qt = Qtv[ec * C + c];
        const float* b = bas + ec * NB;
        const float* d = dbas + ec * NB;
#pragma unroll
        for (int t = 0; t < WT; ++t) {
          const int r = eg + EG * (i0 + t);
          if (r < NB) {
            const bool sr = r < nk;
            acc[t] = fmaf(b[r], sr ? ps : pt, acc[t]);
            acc[t] = fmaf(d[r], sr ? qs : qt, acc[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        const int r = eg + EG * (i0 + t);
        if (r < NB) dW_s[r * C + c] = acc[t];
      }
    }
    // xb rows (j, s): thread (c, jg) owns the rows j with j % EG == jg
    for (int ec = 0; ec < cnt; ++ec) {
      const int j = ljc[ec];
      if (j % EG == eg) dx_s[j * C + c] += xg[ec * C + c];
    }
    __syncthreads();
    // cotangents of (a | b) -> bas and of (da | db) -> dbas:
    // d(a|b) = P @ w^T + Q @ u^T, d(da|db) = Q @ w^T; tiles of TE edges x
    // TR rows, rows of one tile all of sbf's or all of tbf's
    {
      const int rts = (nk + TR - 1) / TR;
      const int rtl = rts + (ntk + TR - 1) / TR;
      const int etl = (cnt + TE - 1) / TE;
      for (int t = tid; t < etl * rtl; t += NTB) {
        const int et = t / rtl, rt = t % rtl;
        const bool sr = rt < rts;
        const int r0 = sr ? rt * TR : nk + (rt - rts) * TR;
        const int r1 = sr ? nk : NB;
        const float* P = sr ? Psv : Ptv;
        const float* Q = sr ? Qsv : Qtv;
        const float* w[TR];
        int ecs[TE];
#pragma unroll
        for (int i = 0; i < TR; ++i) w[i] = ws_s + min(r0 + i, r1 - 1) * (C + 1);
#pragma unroll
        for (int e = 0; e < TE; ++e) ecs[e] = min(et * TE + e, cnt - 1) * C;
        float gt[TE][TR], gd[TE][TR];
#pragma unroll
        for (int e = 0; e < TE; ++e)
#pragma unroll
          for (int i = 0; i < TR; ++i) gt[e][i] = gd[e][i] = 0.f;
        for (int cc = 0; cc < C; ++cc) {
          float pv[TE], qv[TE], wv[TR];
#pragma unroll
          for (int e = 0; e < TE; ++e) {
            pv[e] = P[ecs[e] + cc];
            qv[e] = Q[ecs[e] + cc];
          }
#pragma unroll
          for (int i = 0; i < TR; ++i) wv[i] = w[i][cc];
#pragma unroll
          for (int e = 0; e < TE; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              gt[e][i] = fmaf(pv[e], wv[i], gt[e][i]);
              gd[e][i] = fmaf(qv[e], wv[i], gd[e][i]);
            }
        }
        const float* u = sr ? p.u4 : p.u5;
        if (u != nullptr) {
          const float* ur[TR];
#pragma unroll
          for (int i = 0; i < TR; ++i) ur[i] = u + (size_t)(min(r0 + i, r1 - 1) - (sr ? 0 : nk)) * C;
          for (int cc = 0; cc < C; ++cc) {
            float qv[TE], uv[TR];
#pragma unroll
            for (int e = 0; e < TE; ++e) qv[e] = Q[ecs[e] + cc];
#pragma unroll
            for (int i = 0; i < TR; ++i) uv[i] = __ldg(ur[i] + cc);
#pragma unroll
            for (int e = 0; e < TE; ++e)
#pragma unroll
              for (int i = 0; i < TR; ++i) gt[e][i] = fmaf(qv[e], uv[i], gt[e][i]);
          }
        }
#pragma unroll
        for (int e = 0; e < TE; ++e) {
          const int ec = et * TE + e;
          if (ec >= cnt) continue;
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            if (r0 + i < r1) {
              bas[ec * NB + r0 + i] = gt[e][i];
              dbas[ec * NB + r0 + i] = gd[e][i];
            }
          }
        }
      }
    }
    __syncthreads();
    // the rows' cotangent through the products: from (a | b) against the
    // rows, (da | db) against their tangent (P, Q and xg are dead: spare)
    Rows::write_ptb(p, s, ids, cnt, bas, dbas, ptc, u2c, m2c, rs, Psv);
  }
  __syncthreads();
  for (int x = tid; x < A * C; x += NTB) {
    const int j = x / C, cc = x % C;
    p.dx[(((size_t)g * A + j) * K + s) * C + cc] = dx_s[x];
  }
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NTB) part[x] = dW_s[x];
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
  const size_t smem = (size_t)fwd_floats<Rows, C>(p) * sizeof(float);
  const int grid = (p.E + ET - 1) / ET;
  return launch(slot_fwd_kernel<T, C, Rows>, grid, NT, smem, strm, p);
}

template <typename Rows, typename T, int C>
int bwd_t(Params<T> p, int need_rows, int blocks, cudaStream_t strm) {
  const size_t smem = (size_t)bwd_floats<Rows, C>(p, need_rows != 0) * sizeof(float);
  if (need_rows) return launch(slot_bwd_kernel<T, C, true, Rows>, blocks, NT, smem, strm, p);
  return launch(slot_bwd_kernel<T, C, false, Rows>, blocks, NT, smem, strm, p);
}

template <typename Rows, typename T, int C>
int bwd2_t(Params<T> p, int blocks, cudaStream_t strm) {
  const size_t jvp = ((size_t)(p.nk + p.ntk) * (C + 1) + jvp_stage(p, C) + ET * C + 3 * ET +
                      (size_t)p.K * (ET + 1) + Rows::scratch(p, ROWS_TANGENT)) *
                     sizeof(float);
  int rc = launch(slot_jvp_kernel<T, C, Rows>, (p.E + ET - 1) / ET, NT, jvp, strm, p);
  if (rc != 0) return rc;
  const size_t floats = (size_t)(p.nk + p.ntk) * (C + 1) + (size_t)p.NB * C +
                        (size_t)p.A * C + 2 * p.R * ET + 2 * ET * p.NB +
                        bwd2_spare<Rows, C>(p) + 2 * ET +
                        (size_t)p.A * p.K + Rows::BWD2_THREADS / 32 + Rows::scratch(p, ROWS_JET);
  return launch(slot_bwd2_kernel<T, C, Rows>, blocks, Rows::BWD2_THREADS, floats * sizeof(float),
                strm, p);
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
