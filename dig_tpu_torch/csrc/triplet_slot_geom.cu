// Slot-resident fused triplet interaction with the basis evaluated in the
// kernel (SphereNet / DimeNet++ rows from the per-triplet geometry):
// forward, backward and second-order backward, for NVIDIA Hopper (sm_90a).
// Plain C interface, loaded through ctypes by
// dig_tpu_torch/ops/triplet_slot.py (fused_triplet_slot_geom).
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_triplet_slot.py:
// _run_fwd_g (pl.pallas_call at :565), _run_bwd_g (:588) and _run_bwd2_g
// (:626), the op fused_triplet_slot_geom (:733).
//
// The contraction is that of csrc/triplet_slot.cu (the kernels of
// triplet_slot_core.cuh), but the rows bt, y0, yt of a triplet are not read
// from a [K, R, E] table: they are evaluated here in float32 from
// geo [K, NG, E] = (theta[, phi], x = d_kj / cutoff), NG = 2 + has_t, by
// the closed forms printed from the repo's sympy bases into the generated
// header geom_rows.cuh (ops/basis.py basis_row_code: rows, gradients,
// second derivatives, for one (num_spherical, num_radial, has_t)). No
// [K, R, E] tensor exists in device memory at any derivative level.
//
// The rows and their derivatives are evaluated in float64 and rounded to
// float32, as the plain version evaluates them (a deliberate deviation from
// the TPU kernel's float32 evaluation): the Bessel closed forms cancel
// catastrophically at short d_kj, and two float32 evaluations of them
// (the TPU body's, torch's, this kernel's) disagree by up to 3e-4 of the
// largest row gradient at x = 0.013, the shortest k-j distance of a
// path-7a batch; in float64 each is the float32 rounding of the closed form.
//
//   rows  = f(theta, phi, x'),  x' = x where the triplet is real, else 1
//           (the Bessel closed forms have 1/x^l poles; theta and phi are
//           not substituted)
//   J     = d rows / d(theta, phi, x), H_r = the second derivatives of row r
//   backward:     dgeo = J^T dpt, dpt the rows' cotangent of the slot backward
//   second order: u2 = J ug enters the slot second order where the table's
//                 tangent u2 enters it; geob = J^T ptb + (sum_r dpt_r H_r) ug,
//                 ptb its rows' cotangent, dpt recomputed in the kernel
// At a masked triplet (m2T = 0 or lj outside [0, A)) dgeo and geob are 0.
// Rounding is the table's: sbf and tbf are formed in float32 from the
// float32 rows and rounded to x's type; the rows themselves are never
// rounded (in bf16 this op therefore differs from the pt chain, whose table
// is stored in bf16).
//
// What bounds it on this card. Per real triplet the forward evaluates the R
// rows (R = 30 at n = 3, k = 6 with torsion: 18 Bessel rows of one sine
// each, 3 + 9 spherical harmonics of cos / sin of theta and phi) and then
// does the slot contraction's 2 C (nk + ntk) flops; its bytes are the geo
// column and the gathered x row of each real triplet, m2T and lj, and out.
// At path 7a's shape (E = 44,544, K = 16, C = 64, n = 3, k = 6, bf16;
// chip_smoke.py recounts from its batch) the FP32 work, about 2.6 GFLOP, is
// 0.04 ms at 67 TF/s, the special-function operations (a few tens per
// triplet) a few microseconds at 16 per SM and clock, and the bytes about
// 10 MB (0.003 ms): the float32 operations bound it, as the backward (the
// rows' gradient added, 5-8 GFLOP) and the second order (the rows'
// Hessians added, 15-20 GFLOP). chip_smoke.py prints the three counts for
// each kernel from its inputs and takes the largest.
//
// What the design does about it:
//  - The slot kernels of triplet_slot.cu, unchanged (GeomRows is their row
//    source): each walks only real triplets, 32 at a time (the forward a
//    block's 32 edges s-major, the backward and second order a (slot, s)
//    block's edges); the chunk's geometry, mask and the second order's ug
//    staged in shared memory; the rows (and, where the second order needs
//    it, their tangent J ug) evaluated once per (row, real triplet) by one
//    thread, a warp sharing one row, so the generated switch over rows
//    never diverges within a warp. The forward's first design evaluated
//    the float64 rows of masked triplets too.
//  - dgeo (the backward walks only the real triplets' edges, see
//    slot_bwd_kernel): each (row, edge) is evaluated once, by row (the
//    value) and row_grad (the derivatives along the row's variables), when
//    the chunk's rows are loaded, the derivatives kept in shared memory.
//    At the end of the chunk the rows' cotangent dpt_r is formed for every
//    (row, edge) across the block, then one thread per (geometry variable,
//    edge) sums d row_r / dv dpt_r over the rows that depend on its
//    variable (x: the Bessel rows; theta: the harmonics; phi: the Y_l^m
//    rows) in row order: no serial evaluation of the rows, no atomics, the
//    same bits on every call. ptxas (sm_90a): 101-113 registers a thread
//    at C = 64 and 128 (the serial walk held 169-179), two blocks an SM.
//  - geob (the second order; 512 threads a block, the real triplets' edges
//    only, see slot_bwd2_kernel): each (row, edge) is evaluated once, by
//    row_jet (the value, gradient and second derivatives from one set of
//    common subexpressions), when the chunk's rows are loaded; the row's
//    derivatives and (H ug) along its variables stay in shared memory. At
//    the end of the chunk the rows' cotangent ptb_r and the first-order
//    dpt_r are formed for every (row, edge) across the block, then one
//    thread per (geometry variable, edge) sums d row_r / dv ptb_r + dpt_r
//    (H_r ug)_v over its variable's rows in row order: no serial
//    evaluation of the rows, no atomics, the same bits on every call.
//  - dx, dws, dwt and the second order's xb, wsb, wtb, ctb: the slot
//    kernels' own sums (a block per (slot, s), per-block weight partials
//    summed by sum_partials_kernel in a fixed order).
//  - Products on the FP32 pipes; the rows' closed forms on the FP64 pipes
//    (accurate sin / cos, no fast-math), rounded to float32 once.
#include "triplet_slot_core.cuh"

#include "geom_rows.cuh"

namespace {

// The rows that depend on geometry variable v (0 theta, 1 phi, 2 x):
// x the Bessel rows [0, nk); theta the harmonics [nk, R); phi the Y_l^m
// rows [nk + n, R).
template <typename T>
__device__ __forceinline__ void rows_of(const Params<T>& p, int v, int& r0, int& r1) {
  r0 = v == 2 ? 0 : (v == 0 ? p.nk : p.nk + p.n);
  r1 = v == 2 ? p.nk : p.R;
}

// The variable of geo's row gi: (theta, phi, x) with torsion, (theta, x)
// without.
template <typename T>
__device__ __forceinline__ int var_of(const Params<T>& p, int gi) {
  return gi == p.NG - 1 ? 2 : gi;
}

// (H ug)_v for the second derivatives h = (tt, tp, tx, pp, px, xx).
__device__ __forceinline__ double hess_dot(const double* h, int v, double u0, double u1,
                                           double u2) {
  return v == 0   ? h[0] * u0 + h[1] * u1 + h[2] * u2
         : v == 1 ? h[1] * u0 + h[3] * u1 + h[4] * u2
                  : h[2] * u0 + h[4] * u1 + h[5] * u2;
}

// The geometry as the row source. rs holds the chunk's (theta, phi, x')
// [3][ET] and ug [3][ET] (zero when absent or masked); in ROWS_JET mode
// also, per (row, edge), the row's derivative and (H ug) along its first
// variable (x for the Bessel rows, theta for the harmonics), jv and hv
// [R][ET], and along phi for the Y_l^m rows, jp and hp [n^2][ET]: the
// second order's write_ptb reads them instead of evaluating the rows again.
// In ROWS_GRAD mode (the backward's) the derivatives alone, jv [R][ET] and
// jp [n^2][ET], from row_grad (the row's value still from row, as in
// ROWS_VALUE), for write_dpt.
struct GeomRows {
  static constexpr bool GEO = true;
  static constexpr int BWD2_THREADS = 512;

  template <typename T>
  static __host__ __device__ int scratch(const Params<T>& p, int mode) {
    const int nyl = p.has_t ? p.n * p.n : 0;
    return 6 * ET + (mode == ROWS_JET ? 2 * (p.R + nyl) * ET
                     : mode == ROWS_GRAD ? (p.R + nyl) * ET : 0);
  }
  // write_ptb's ptb and dpt [R][ET] each
  template <typename T>
  static __host__ __device__ int spare(const Params<T>& p) { return 2 * p.R * ET; }
  // write_dpt's dpt [R][ET]
  template <typename T>
  static int dpt_spare(const Params<T>& p) { return p.R * ET; }

  template <int MODE, typename T>
  static __device__ void load(const Params<T>& p, int s, int e0, const int* ids, int cnt,
                              float* ptc, float* m2c, int* ljc, float* u2c, float* rs) {
    float* gv = rs;            // [3][ET]
    float* uv = rs + 3 * ET;   // [3][ET]
    for (int ec = threadIdx.x; ec < ET; ec += blockDim.x) {
      float m = 0.f;
      int j = 0;
      float g[3] = {0.f, 0.f, 1.f}, u[3] = {0.f, 0.f, 0.f};
      if (ec < cnt) {
        int ts, e;
        triplet_at(p.E, s, e0, ids, ec, ts, e);
        j = p.lj[e];
        m = (j >= 0 && j < p.A) ? ld(p.m2T + (size_t)ts * p.E + e) : 0.f;
        for (int gi = 0; gi < p.NG; ++gi) {
          const int v = var_of(p, gi);
          const size_t at = ((size_t)ts * p.NG + gi) * p.E + e;
          if (v != 2 || m != 0.f) g[v] = p.geo[at];
          if (MODE >= ROWS_TANGENT && p.ug != nullptr && m != 0.f) u[v] = p.ug[at];
        }
      }
      m2c[ec] = m;
      ljc[ec] = m != 0.f ? j : 0;
      for (int v = 0; v < 3; ++v) {
        gv[v * ET + ec] = g[v];
        uv[v * ET + ec] = u[v];
      }
    }
    __syncthreads();
    const int nk = p.nk, ny = p.nk + p.n;  // the Y_l^m rows start at ny
    float* jv = rs + 6 * ET;
    float* hv = jv + p.R * ET;
    float* jp = MODE == ROWS_GRAD ? hv : hv + p.R * ET;
    float* hp = jp + (p.R - ny) * ET;
    for (int x = threadIdx.x; x < p.R * ET; x += blockDim.x) {
      const int r = x / ET, ec = x % ET;
      float val = 0.f, tg = 0.f;
      if (ec < cnt) {
        const double th = gv[ec], ph = gv[ET + ec], xx = gv[2 * ET + ec];
        const double u0 = uv[ec], u1 = uv[ET + ec], u2 = uv[2 * ET + ec];
        if constexpr (MODE == ROWS_VALUE) {
          val = (float)geom_rows::row<double>(r, th, ph, xx);
        } else if constexpr (MODE == ROWS_GRAD) {
          val = (float)geom_rows::row<double>(r, th, ph, xx);
          double g[3];
          geom_rows::row_grad<double>(r, th, ph, xx, g);
          jv[x] = (float)g[r < nk ? 2 : 0];
          if (r >= ny) jp[x - ny * ET] = (float)g[1];
        } else if constexpr (MODE == ROWS_TANGENT) {
          double g[3];
          val = (float)geom_rows::row_grad<double>(r, th, ph, xx, g);
          tg = (float)(g[0] * u0 + g[1] * u1 + g[2] * u2);
        } else {
          double g[3], h[6];
          val = (float)geom_rows::row_jet<double>(r, th, ph, xx, g, h);
          tg = (float)(g[0] * u0 + g[1] * u1 + g[2] * u2);
          const int v = r < nk ? 2 : 0;
          jv[x] = (float)g[v];
          hv[x] = (float)hess_dot(h, v, u0, u1, u2);
          if (r >= ny) {
            jp[x - ny * ET] = (float)g[1];
            hp[x - ny * ET] = (float)hess_dot(h, 1, u0, u1, u2);
          }
        }
      }
      ptc[x] = val;
      if constexpr (MODE >= ROWS_TANGENT) u2c[x] = tg;
    }
  }

  // dgeo[s, gi, e] = sum over the rows r of gi's variable v, in row order,
  // of d row_r / dv * dpt_r, dpt_r the adjoint of the basis cotangent dbas:
  // dpt_r formed first for every (row, edge) across the block, into spare;
  // the derivatives from load's ROWS_GRAD (row_grad once per (row, edge)).
  // Every edge of the chunk is a real triplet's.
  template <typename T>
  static __device__ void write_dpt(const Params<T>& p, int s, const int* ids, int cnt,
                                   const float* dbas, const float* ptc, const float* rs,
                                   float* spare) {
    float* dp = spare;  // [R][ET]
    for (int x = threadIdx.x; x < p.R * ET; x += blockDim.x) {
      const int r = x / ET, ec = x % ET;
      if (ec < cnt) dp[x] = basis_adjoint(p, dbas + ec * p.NB, ptc, r, ec);
    }
    __syncthreads();
    const int ny = p.nk + p.n;
    const float* jv = rs + 6 * ET;
    const float* jp = jv + p.R * ET;
    for (int x = threadIdx.x; x < p.NG * ET; x += blockDim.x) {
      const int gi = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      const int v = var_of(p, gi);
      int r0, r1;
      rows_of(p, v, r0, r1);
      // phi's derivatives are kept for the Y_l^m rows only
      const float* J = v == 1 ? jp - ny * ET : jv;
      float acc = 0.f;
      for (int r = r0; r < r1; ++r) acc = fmaf(J[r * ET + ec], dp[r * ET + ec], acc);
      p.dgeo[((size_t)s * p.NG + gi) * p.E + ids[ec] - s * p.E] = acc;
    }
  }

  // geob[s, gi, e] = sum over the rows r of gi's variable v, in row order,
  // of d row_r / dv * ptb_r + dpt_r * (H_r ug)_v, with ptb_r the rows'
  // cotangent (from (a | b) against the rows, (da | db) against their
  // tangent J ug) and dpt_r the first-order one (from (da | db)'s cotangent,
  // which is the backward's basis cotangent, against the rows). ptb_r and
  // dpt_r are formed first for every (row, edge) across the block, into
  // spare; the derivatives come from load's jets. Every edge of the chunk
  // is a real triplet's.
  template <typename T>
  static __device__ void write_ptb(const Params<T>& p, int s, const int* ids, int cnt,
                                   const float* bas, const float* dbas, const float* ptc,
                                   const float* u2c, const float*, const float* rs,
                                   float* spare) {
    float* pb = spare;                // [R][ET] ptb
    float* dp = spare + p.R * ET;     // [R][ET] dpt
    for (int x = threadIdx.x; x < p.R * ET; x += blockDim.x) {
      const int r = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      const float* bd = dbas + ec * p.NB;
      pb[x] = basis_adjoint(p, bas + ec * p.NB, ptc, r, ec) + basis_adjoint(p, bd, u2c, r, ec);
      dp[x] = basis_adjoint(p, bd, ptc, r, ec);
    }
    __syncthreads();
    const int ny = p.nk + p.n;
    const float* jv = rs + 6 * ET;
    const float* hv = jv + p.R * ET;
    const float* jp = hv + p.R * ET;
    const float* hp = jp + (p.R - ny) * ET;
    for (int x = threadIdx.x; x < p.NG * ET; x += blockDim.x) {
      const int gi = x / ET, ec = x % ET;
      if (ec >= cnt) continue;
      const int v = var_of(p, gi);
      int r0, r1;
      rows_of(p, v, r0, r1);
      // phi's derivatives are kept for the Y_l^m rows only
      const float* J = v == 1 ? jp - ny * ET : jv;
      const float* H = v == 1 ? hp - ny * ET : hv;
      float acc = 0.f;
      for (int r = r0; r < r1; ++r) {
        const int at = r * ET + ec;
        acc = fmaf(J[at], pb[at], fmaf(dp[at], H[at], acc));
      }
      p.dgeo[((size_t)s * p.NG + gi) * p.E + ids[ec] - s * p.E] = acc;
    }
  }
};

// 0 unless the library's generated rows are those of (n, k, has_t).
int check_rows(int n, int k, int has_t) {
  return (n == geom_rows::NUM_SPHERICAL && k == geom_rows::NUM_RADIAL &&
          (has_t != 0) == (geom_rows::HAS_T != 0))
             ? 0
             : ERR_SHAPE;
}

template <typename T>
Params<T> geom_params(const void* x, const float* geo, const void* m2T, const float* ws,
                      const float* wt, const int* lj, int E, int A, int K, int n, int k,
                      int has_t) {
  auto p = make_params<T>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
  p.geo = geo;
  return p;
}

}  // namespace

extern "C" {

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM (ERR_SHAPE also when
// (n, k, has_t) are not those this library's rows were generated for). x,
// m2T and out are bf16 when bf16 != 0, float32 otherwise; geo float32.
int triplet_slot_geom_fwd(const void* x, const float* geo, const void* m2T, const float* ws,
                          const float* wt, const int* lj, void* out, int E, int A, int K, int n,
                          int k, int has_t, int C, int bf16, void* stream) {
  int rc = check_rows(n, k, has_t);
  if (rc != 0) return rc;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = geom_params<__nv_bfloat16>(x, geo, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.out = static_cast<__nv_bfloat16*>(out);
    return fwd_c<GeomRows>(p, C, strm);
  }
  auto p = geom_params<float>(x, geo, m2T, ws, wt, lj, E, A, K, n, k, has_t);
  p.out = static_cast<float*>(out);
  return fwd_c<GeomRows>(p, C, strm);
}

// ct, dx, dgeo float32; dgeo may be null when need_dgeo == 0. partial:
// [blocks, (nk+ntk)*C] scratch, blocks = (E / (A*K)) * K; dw: [(nk+ntk)*C]
// receives dws | dwt.
int triplet_slot_geom_bwd(const void* x, const float* geo, const void* m2T, const float* ws,
                          const float* wt, const int* lj, const float* ct, float* dx,
                          float* dgeo, float* partial, float* dw, int E, int A, int K, int n,
                          int k, int has_t, int C, int bf16, int need_dgeo, int blocks,
                          void* stream) {
  int rc = check_rows(n, k, has_t);
  if (rc != 0) return rc;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = geom_params<__nv_bfloat16>(x, geo, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.dx = dx; p.dgeo = dgeo; p.partial = partial;
    rc = bwd_c<GeomRows>(p, C, need_dgeo, blocks, strm);
  } else {
    auto p = geom_params<float>(x, geo, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.dx = dx; p.dgeo = dgeo; p.partial = partial;
    rc = bwd_c<GeomRows>(p, C, need_dgeo, blocks, strm);
  }
  if (rc != 0) return rc;
  const int size = (n * k + (has_t ? n * n * k : 0)) * C;
  return sum_partials(partial, blocks, size, dw, strm);
}

// Second order. ct, ug float32; u1 in the type of x, u4 / u5 float32, each
// null when absent. xb, geob, ctb float32 (every element written); partial
// and dw as for the backward (dw receives wsb | wtb).
int triplet_slot_geom_bwd2(const void* x, const float* geo, const void* m2T, const float* ws,
                           const float* wt, const int* lj, const float* ct, const void* u1,
                           const float* ug, const float* u4, const float* u5, float* xb,
                           float* geob, float* partial, float* dw, float* ctb, int E, int A,
                           int K, int n, int k, int has_t, int C, int bf16, int blocks,
                           void* stream) {
  int rc = check_rows(n, k, has_t);
  if (rc != 0) return rc;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = geom_params<B>(x, geo, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.ug = ug;
    p.u4 = u4; p.u5 = u5; p.dx = xb; p.dgeo = geob; p.ctb = ctb; p.partial = partial;
    rc = bwd2_c<GeomRows>(p, C, blocks, strm);
  } else {
    auto p = geom_params<float>(x, geo, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.ug = ug;
    p.u4 = u4; p.u5 = u5; p.dx = xb; p.dgeo = geob; p.ctb = ctb; p.partial = partial;
    rc = bwd2_c<GeomRows>(p, C, blocks, strm);
  }
  if (rc != 0) return rc;
  const int size = (n * k + (has_t ? n * n * k : 0)) * C;
  return sum_partials(partial, blocks, size, dw, strm);
}

}  // extern "C"
