// Fused continuous-filter convolution (SchNet cfconv), forward and backward,
// for NVIDIA Hopper (sm_90a). Plain C interface, loaded through ctypes by
// dig_tpu_torch/ops/cfconv.py.
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_cfconv.py:
// _fused_fwd (pl.pallas_call at :273) and _fused_bwd (:320).
//
//   out[g,i,f] = sum_j gate(d) * w(d)[f] * vj[g,j,f],  d = dist[g,i,j]
//   w(d)       = sps(rbf(d) @ W1 + b1) @ W2 + b2,  sps(x) = softplus(x) - log 2
//   rbf(d)[r]  = exp(coeff * (d - r * delta_mu)^2),  gate(d) = 0.5 (cos(pi d / c) + 1)
//
// What bounds it on this card. Per in-cutoff pair the filter MLP costs
// 2 F (R + F) flops forward (about 2 F (2R + 3F) backward) and about R + 2F
// transcendentals (R exps for the basis, an exp and a log per softplus),
// against a few bytes of distance: the op is bound by operations, and at
// F = 128, R = 50 the special-function units (16 results per clock per SM)
// weigh as much as the matrix products.
//
// What the design does about it:
//  - Nothing of size [pairs, F] touches device memory: the basis, the filter
//    and its gradients live in shared memory and registers; only dist, vj,
//    the weights and the outputs are read or written.
//  - A pair at or beyond the cutoff (padding, other molecules of a packed
//    slot, the diagonal, MASK_DIST = 1e9) contributes exactly zero to every
//    output, so only in-cutoff pairs are computed.
//  - One block walks whole slots g (grid-strided), so d_vj[g] (a sum over
//    rows i) and d_dist stay block-local and need no atomics. The weight
//    gradients are per-block register partials written to a [blocks, ...]
//    scratch and summed by a second kernel in a fixed order: the same bits
//    on every run.
//  - In "bf16" precision the operands the TPU kernel rounds (vj, W1, W2,
//    rbf, h) are rounded to bf16 before each product and sums are float32.
//  - Both kernels list a slot's in-cutoff pairs once, by ballots over the
//    whole [n, n] block (list_pairs), and walk the list 64 pairs a tile
//    across row boundaries, as the TPU kernel feeds its matrix unit MB n^2
//    pair rows. Their first designs walked the rows one at a time (about
//    13 in-cutoff pairs a row, so a 32-pair chunk was 60% padding, with a
//    warp listing each row between two barriers while the others waited),
//    ran every product on the FP32 pipes from float32 weights in shared
//    memory (one block of 8 warps an SM) and reduced each out row across 8
//    thread groups.
//  - The forward (cfconv_fwd_kernel) lists the pairs in (i, j) order, so
//    each out row is a run of consecutive pairs, summed in pair order by
//    the threads of the run; the backward (cfconv_bwd_kernel) in (j, i)
//    order, each d_vj row a run.
//  - In bf16 precision the products of a tile (the forward's rbf W1 and
//    h W2; the backward's also dp2 W2^T, rbf^T dp1 and h^T dp2, and dp1
//    W1^T with d_dist) run on the tensor cores (mma.sync m16n8k16, bf16
//    operands from shared memory through ldmatrix, float32 sums): exactly
//    the rounding the TPU kernel and the plain version apply. W1 and W2
//    are staged as bf16, and the backward's dW1 | dW2 stay in registers
//    across tiles (48 a thread at F = 128), so a block has F / 8 warps: 16
//    at F = 128, one block an SM (the forward takes the same blocks). One
//    exp(-|pre|) serves the softplus and the sigmoid, fast in bf16
//    precision. In float32 precision the same walks run the products on
//    the FP32 pipes. The grids are SMs x the occupancy.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int KR = 64;  // basis rows of the products (R zero-padded): the largest R
constexpr int PT = 64;  // pairs a tile
constexpr float LOG2F = 0.6931471805599453f;

struct Params {
  const float* dist;  // [G, n, n]
  const float* vj;    // [G, n, F]
  const float* w1;    // [R, F]
  const float* b1;    // [F]
  const float* w2;    // [F, F]
  const float* b2;    // [F]
  const float* gout;  // [G, n, F] (backward)
  float* out;         // [G, n, F] (forward)
  float* d_dist;      // [G, n, n]
  float* d_vj;        // [G, n, F]
  float* partial;     // [gridDim.x, R*F + F + F*F + F]
  int G, n, R;
  float cutoff, coeff, delta_mu, pi_c;
};

// ---------------------------------------------------------------------------
// The walk's pieces: thread layout, tiles, products, listing
// ---------------------------------------------------------------------------

// Per F, in both walks: NT threads, F / 8 warps. The products over a tile's
// pairs (pre, w, dh = dp2 W2^T) give warp (wm, wn) = (w % 4, w / 4) the 16 pairs 16 wm..
// and the 32 columns 32 wn..; d_rbf = dp1 W1^T the 8 NTR columns from
// 8 NTR wn; dW1
// the 16 basis rows 16 wm.. and the 32 columns 32 wn..; dW2 the MT2 16-row
// tiles from 16 MT2 (w % MG2) and the NT2 8-column tiles from 8 NT2 (w / MG2).
template <int F>
struct WalkCfg {
  static constexpr int NT = F * 4, NWARP = F / 8, WN = F / 32, NTR = 8 / WN;
  static constexpr int MT2 = F >= 128 ? 2 : 1, NT2 = F >= 64 ? 4 : 2;
  static constexpr int MG2 = F / 16 / MT2;
  static constexpr int TPP = NT / PT;  // threads a pair when the basis is staged
};

template <bool BF16>
using Elem = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// Row strides (elements) of the tiles: 16 bytes of padding a row in bf16
// (ldmatrix reads 8 rows of 16 bytes without a bank conflict), 4 floats in
// float32.
template <bool BF16>
constexpr int PADE = BF16 ? 8 : 4;

struct BwdLayout {
  int LW, LR, LH, LT, LV, rounds;
  size_t w1, w2, b1, b2, vj, go, dvj, rbf, hs, dp2, dp1, pi, pj, pd, pg, pdg, rst, dgp, ddp,
      dbs1, dbs2, lst, wcnt, bits, total;
};

__host__ __device__ constexpr size_t up16(size_t b) { return (b + 15) & ~(size_t)15; }

// Byte offsets of the backward's shared memory at slots of n atoms.
template <int F, bool BF16>
__host__ __device__ inline BwdLayout bwd_layout(int n) {
  using C = WalkCfg<F>;
  const size_t es = sizeof(Elem<BF16>);
  BwdLayout L;
  L.LW = F + 8;             // W1, W2 (bf16 only)
  L.LR = KR + PADE<BF16>;   // the basis tile
  L.LH = F + PADE<BF16>;    // h, dp2, dp1
  L.LT = F + 4;             // the d_vj terms (float32, over dp1)
  L.LV = F + 4;             // vj, gout, d_vj rows
  L.rounds = (n * n + C::NT - 1) / C::NT;
  size_t o = 0;
  auto take = [&o](size_t bytes) { const size_t at = o; o += up16(bytes); return at; };
  L.w1 = take(BF16 ? (size_t)KR * L.LW * 2 : 0);
  L.w2 = take(BF16 ? (size_t)F * L.LW * 2 : 0);
  L.b1 = take(F * 4);
  L.b2 = take(F * 4);
  L.vj = take((size_t)n * L.LV * 4);
  L.go = take((size_t)n * L.LV * 4);
  L.dvj = take((size_t)n * L.LV * 4);
  L.rbf = take((size_t)PT * L.LR * es);
  L.hs = take((size_t)PT * L.LH * es);
  L.dp2 = take((size_t)PT * L.LH * es);
  const size_t dp1 = (size_t)PT * L.LH * es, t = (size_t)PT * L.LT * 4;
  L.dp1 = take(dp1 > t ? dp1 : t);
  L.pi = take(PT * 4);
  L.pj = take(PT * 4);
  L.pd = take(PT * 4);
  L.pg = take(PT * 4);
  L.pdg = take(PT * 4);
  L.rst = take((PT + 2) * 4);
  L.dgp = take((size_t)C::WN * PT * 4);
  L.ddp = take((size_t)C::WN * PT * 4);
  L.dbs1 = take(4 * F * 4);
  L.dbs2 = take(4 * F * 4);
  L.lst = take((size_t)n * n * 4);
  L.wcnt = take((size_t)L.rounds * C::NWARP * 4);
  L.bits = take((size_t)L.rounds * C::NWARP * 4);
  L.total = o;
  return L;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b on the tensor cores: a 16 x 16 and b 16 x 8 in bf16, d float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += A[m0 + 16 mt .. +16, 0:K] B[0:K, n0 + 8 nt .. +8] in the
// fragment layout of mma.m16n8k16: acc[.][.][v] is row (lane / 4) + 8 (v / 2),
// column 2 (lane % 4) + v % 2 of its 16 x 8 tile. A is stored [m][k] with
// row stride lda, or [k][m] (AT); B is stored [k][n] with row stride ldb,
// or [n][k] (BT). In bf16 the operands are in shared memory and K a
// multiple of 16 (ldmatrix, mma.sync). In float32 they are anywhere, K is
// even, the products run on the FP32 pipes, each sum over k from 0, two k
// a step with 8-byte loads, and B's rows from kb on and columns from nb on
// read as 0 (the weights in device memory have R rows, not KR).
template <bool BF16, int MT, int NTn, bool AT, bool BT>
__device__ __forceinline__ void tiles(float (&acc)[MT][NTn][4], const Elem<BF16>* A, int lda,
                                      const Elem<BF16>* B, int ldb, int m0, int n0, int K,
                                      int kb, int nb) {
  const int lane = threadIdx.x & 31;
  if constexpr (BF16) {
    static_assert(NTn % 2 == 0, "B fragments come two n-tiles at a time");
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + 16 * mt;
        if constexpr (AT)
          ldsm_x4_t(a[mt], A + (size_t)(k0 + (lane & 7) + (lane >> 4) * 8) * lda + m +
                               ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(a[mt], A + (size_t)(m + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < NTn; nt += 2) {
        const int n = n0 + 8 * nt;
        uint32_t b[4];
        if constexpr (BT)
          ldsm_x4(b, B + (size_t)(n + (lane & 7) + (lane >> 4) * 8) * ldb + k0 +
                         ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(b, B + (size_t)(k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n +
                           (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
        }
      }
    }
  } else {
    const int r = lane >> 2, c = (lane & 3) * 2;
    const float2 zero = make_float2(0.f, 0.f);
    for (int k = 0; k < K; k += 2) {
      float2 av[MT][2], bv[NTn][2];  // av[.][h]: row r + 8 h at k, k + 1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * mt + r + 8 * h;
          av[mt][h] = AT ? make_float2(A[(size_t)k * lda + m], A[(size_t)(k + 1) * lda + m])
                         : *reinterpret_cast<const float2*>(A + (size_t)m * lda + k);
        }
#pragma unroll
      for (int nt = 0; nt < NTn; ++nt) {
        const int n = n0 + 8 * nt + c;
        if constexpr (BT) {  // bv[nt][u]: column n + u at k, k + 1
#pragma unroll
          for (int u = 0; u < 2; ++u)
            bv[nt][u] = n + u < nb ? *reinterpret_cast<const float2*>(B + (size_t)(n + u) * ldb + k)
                                   : zero;
        } else {             // bv[nt][j]: row k + j at columns n, n + 1
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bv[nt][j] = k + j < kb ? *reinterpret_cast<const float2*>(B + (size_t)(k + j) * ldb + n)
                                   : zero;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NTn; ++nt)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float a = j == 0 ? av[mt][v >> 1].x : av[mt][v >> 1].y;
              const float b = BT ? (j == 0 ? bv[nt][v & 1].x : bv[nt][v & 1].y)
                                 : ((v & 1) == 0 ? bv[nt][j].x : bv[nt][j].y);
              acc[mt][nt][v] = fmaf(a, b, acc[mt][nt][v]);
            }
    }
  }
}

template <int MT, int NTn>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NTn][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTn; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;
}

// exp(x), and log(1 + e) for e in [0, 1]: the hardware approximations in
// bf16 precision (relative errors near 2^-21, far below the bf16 rounding
// of the values they feed), the accurate functions in float32.
template <bool FAST>
__device__ __forceinline__ float exp_(float x) {
  return FAST ? __expf(x) : expf(x);
}
template <bool FAST>
__device__ __forceinline__ float log1p_(float e) {
  return FAST ? __logf(1.f + e) : log1pf(e);
}

// dst[0], dst[1] <- a, b (rounded to the element type)
__device__ __forceinline__ void st2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// The column sums over a warp's 16 pair rows of the 4 x 2 columns a thread
// holds (s[nt][u]: column 8 nt + 2 (lane % 4) + u), added by lanes 0-3 to
// dst at the warp's columns; the 8 row lanes are summed in a fixed order.
__device__ __forceinline__ void add_column_sums(float (&s)[4][2], float* dst) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = s[nt][u];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) dst[8 * nt + 2 * lane + u] += v;
    }
}

// The sum over the 4 lanes that hold one row (lanes 4 r .. 4 r + 3).
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The in-cutoff pairs of slot g's [n, n] block, listed by warp ballots in
// the order of x (x = a n + b for the pair dist[...][a][b] in (i, j) order,
// or its transpose in (j, i) order): lst[0, nl) holds their x; the return
// value is nl. keep(x) says whether x is listed; wcnt and bits hold rounds
// x NWARP counts and ballots. Ends with lst written and visible.
template <int NT, typename Keep>
__device__ __forceinline__ int list_pairs(int nn, int rounds, Keep keep, int* lst, int* wcnt,
                                          unsigned* bits) {
  constexpr int NWARP = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < rounds; ++k) {
    const int x = k * NT + tid;
    const unsigned m = __ballot_sync(0xffffffffu, x < nn && keep(x));
    if (lane == 0) {
      wcnt[k * NWARP + warp] = __popc(m);
      bits[k * NWARP + warp] = m;
    }
  }
  __syncthreads();
  int nl = 0;
  for (int k = 0; k < rounds; ++k) {
    int at = 0;
    for (int q = 0; q < rounds * NWARP; ++q) {
      if (q < k * NWARP + warp) at += wcnt[q];
      if (k == 0) nl += wcnt[q];
    }
    const unsigned m = bits[k * NWARP + warp];
    if ((m >> lane) & 1u) lst[at + __popc(m & ((1u << lane) - 1u))] = k * NT + tid;
  }
  __syncthreads();
  return nl;
}

// The basis values row[r0, r0 + RPT) of a pair at distance d (rounded to
// the element type; 0 where !ok or r >= R).
template <bool BF16, int RPT>
__device__ __forceinline__ void stage_rbf(const Params& p, float d, bool ok, int r0,
                                          Elem<BF16>* row) {
#pragma unroll
  for (int rb = r0; rb < r0 + RPT; rb += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = rb + u;
      const float dd = d - r * p.delta_mu;
      v[u] = ok && r < p.R ? exp_<BF16>(p.coeff * dd * dd) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; u += 2) st2(row + rb + u, v[u], v[u + 1]);
  }
}

// By warp 0: the runs of equal x / n among the tile's pairs lst[0, cnt), in
// pair order: rst[k] is the k-th run's first pair, rst[count] = cnt, and
// rst[PT + 1] the count.
__device__ __forceinline__ void list_runs(const int* lst, int cnt, int n, int* rst) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int h = 0; h < PT; h += 32) {
    const int q = h + lane;
    const bool start = q < cnt && (q == 0 || lst[q] / n != lst[q - 1] / n);
    const unsigned m = __ballot_sync(0xffffffffu, start);
    if (start) rst[base + __popc(m & ((1u << lane) - 1u))] = q;
    base += __popc(m);
  }
  if (lane == 0) {
    rst[base] = cnt;
    rst[PT + 1] = base;
  }
}

// Each run's terms ts [PT][LT] summed in pair order and added to the row
// x / n of dst [n][LV], by thread (run, feature).
template <int NT, int F>
__device__ __forceinline__ void add_runs(const int* rst, const int* lst, int n, const float* ts,
                                         int LT, float* dst, int LV) {
  const int nruns = rst[PT + 1];
  for (int x = threadIdx.x; x < nruns * F; x += NT) {
    const int k = x / F, f = x % F;
    float s = 0.f;
    for (int q = rst[k]; q < rst[k + 1]; ++q) s += ts[q * LT + f];
    dst[(lst[rst[k]] / n) * LV + f] += s;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdLayout {
  int LW, LR, LH, LT, LV, rounds;
  size_t w1, w2, b1, b2, vj, acc, rbf, hs, ts, pj, pg, rst, lst, wcnt, bits, total;
};

// Byte offsets of the forward's shared memory at slots of n atoms (the
// backward's strides and threads).
template <int F, bool BF16>
__host__ __device__ inline FwdLayout fwd_layout(int n) {
  using C = WalkCfg<F>;
  const size_t es = sizeof(Elem<BF16>);
  FwdLayout L;
  L.LW = F + 8;             // W1, W2 (bf16 only)
  L.LR = KR + PADE<BF16>;   // the basis tile
  L.LH = F + PADE<BF16>;    // h
  L.LT = F + 4;             // the gated terms (float32)
  L.LV = F + 4;             // vj and out rows
  L.rounds = (n * n + C::NT - 1) / C::NT;
  size_t o = 0;
  auto take = [&o](size_t bytes) { const size_t at = o; o += up16(bytes); return at; };
  L.w1 = take(BF16 ? (size_t)KR * L.LW * 2 : 0);
  L.w2 = take(BF16 ? (size_t)F * L.LW * 2 : 0);
  L.b1 = take(F * 4);
  L.b2 = take(F * 4);
  L.vj = take((size_t)n * L.LV * 4);
  L.acc = take((size_t)n * L.LV * 4);
  L.rbf = take((size_t)PT * L.LR * es);
  L.hs = take((size_t)PT * L.LH * es);
  L.ts = take((size_t)PT * L.LT * 4);
  L.pj = take(PT * 4);
  L.pg = take(PT * 4);
  L.rst = take((PT + 2) * 4);
  L.lst = take((size_t)n * n * 4);
  L.wcnt = take((size_t)L.rounds * C::NWARP * 4);
  L.bits = take((size_t)L.rounds * C::NWARP * 4);
  L.total = o;
  return L;
}

// cfconv, a block per slot g (grid-strided, the grid SMs x the occupancy).
// Only pairs with d < cutoff contribute, so the slot's in-cutoff pairs are
// listed once by warp ballots over the whole [n, n] block in (i, j) order:
// out[i] = sum_j gate w vj[j] is then a sum over a run of consecutive
// pairs. The list is walked PT pairs a tile, across row boundaries; per
// tile:
//  - the basis rbf [PT][KR] (rounded to bf16 in bf16 precision), each
//    pair's gate and j, and the tile's runs of equal i;
//  - pre = rbf W1 + b1, h = sps(pre) (rounded), one exp(-|pre|) a value;
//  - w = h W2 + b2 and the gated terms gate w vj[j] (float32);
//  - the threads of each run sum its terms in pair order into the out row
//    i in shared memory (a row split across two tiles takes two runs).
// The products run as in the backward: bf16 precision on the tensor cores
// (mma.sync, W1 and W2 staged as bf16), float32 on the FP32 pipes with the
// weights read through the L1 cache. Pair rows past the list's end have
// gate 0 and rbf 0, and no run reads them. Every sum has a fixed order and
// no atomics are used: the same inputs give the same bits. A slot without
// an in-cutoff pair gets rows of exact zeros.
template <int F, bool BF16>
__global__ void __launch_bounds__(F * 4, 512 / (F * 4)) cfconv_fwd_kernel(Params p) {
  using Cfg = WalkCfg<F>;
  using E = Elem<BF16>;
  constexpr int NT = Cfg::NT, TPP = Cfg::TPP;
  extern __shared__ __align__(16) unsigned char sm[];
  const int n = p.n, R = p.R, nn = n * n;
  const FwdLayout L = fwd_layout<F, BF16>(n);
  const int LW = L.LW, LR = L.LR, LH = L.LH, LT = L.LT, LV = L.LV;
  E* W1h = reinterpret_cast<E*>(sm + L.w1);            // [KR][LW] (bf16)
  E* W2h = reinterpret_cast<E*>(sm + L.w2);            // [F][LW] (bf16)
  float* b1s = reinterpret_cast<float*>(sm + L.b1);
  float* b2s = reinterpret_cast<float*>(sm + L.b2);
  float* vjs = reinterpret_cast<float*>(sm + L.vj);    // [n][LV]
  float* accs = reinterpret_cast<float*>(sm + L.acc);  // [n][LV] out rows
  E* rbf = reinterpret_cast<E*>(sm + L.rbf);           // [PT][LR]
  E* hs = reinterpret_cast<E*>(sm + L.hs);             // [PT][LH]
  float* ts = reinterpret_cast<float*>(sm + L.ts);     // [PT][LT] gated terms
  int* pj = reinterpret_cast<int*>(sm + L.pj);
  float* pg = reinterpret_cast<float*>(sm + L.pg);     // gate
  int* rst = reinterpret_cast<int*>(sm + L.rst);       // run starts, [PT + 1] and the count
  int* lst = reinterpret_cast<int*>(sm + L.lst);       // [n n] pairs i n + j
  int* wcnt = reinterpret_cast<int*>(sm + L.wcnt);
  unsigned* bits = reinterpret_cast<unsigned*>(sm + L.bits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int r4 = lane >> 2, c2 = (lane & 3) * 2;
  if constexpr (BF16) {
    for (int x = tid; x < KR * F; x += NT) {
      const int r = x / F, f = x % F;
      W1h[r * LW + f] = __float2bfloat16_rn(r < R ? p.w1[x] : 0.f);
    }
    for (int x = tid; x < F * F; x += NT) W2h[(x / F) * LW + x % F] = __float2bfloat16_rn(p.w2[x]);
  }
  for (int f = tid; f < F; f += NT) {
    b1s[f] = p.b1[f];
    b2s[f] = p.b2[f];
  }
  // the products' elements: row pr(v), column pc(nt, v)
  auto pr = [=](int v) { return 16 * wm + r4 + 8 * (v >> 1); };
  auto pc = [=](int nt, int v) { return 32 * wn + 8 * nt + c2 + (v & 1); };

  for (int g = blockIdx.x; g < p.G; g += gridDim.x) {
    const float* dist = p.dist + (size_t)g * nn;
    __syncthreads();  // the previous slot is done
    for (int x = tid; x < n * F; x += NT) {
      const int r = x / F, f = x % F;
      vjs[r * LV + f] = rnd<BF16>(p.vj[(size_t)g * n * F + x]);
      accs[r * LV + f] = 0.f;
    }
    const int nl = list_pairs<NT>(nn, L.rounds, [&](int x) { return dist[x] < p.cutoff; }, lst,
                                  wcnt, bits);

    for (int b0 = 0; b0 < nl; b0 += PT) {
      const int cnt = min(PT, nl - b0);
      if (b0 > 0) __syncthreads();  // the previous tile's runs are summed
      // the basis rows, TPP threads a pair, and the pairs' j and gate
      {
        const int pp = tid / TPP, sub = tid % TPP;
        const bool ok = pp < cnt;
        const int x = ok ? lst[b0 + pp] : 0;
        const float d = ok ? dist[x] : 0.f;
        if (sub == 0) {
          pj[pp] = x % n;
          pg[pp] = ok ? 0.5f * (cosf(d * p.pi_c) + 1.f) : 0.f;
        }
        stage_rbf<BF16, KR / TPP>(p, d, ok, sub * (KR / TPP), rbf + pp * LR);
      }
      if (warp == 0) list_runs(lst + b0, cnt, n, rst);  // the runs of equal i
      __syncthreads();
      // pre = rbf W1 + b1, h = sps(pre)
      float y[1][4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) y[0][nt][v] = b1s[pc(nt, v)];
      if constexpr (BF16)
        tiles<true, 1, 4, false, false>(y, rbf, LR, W1h, LW, 16 * wm, 32 * wn, KR, KR, F);
      else
        tiles<false, 1, 4, false, false>(y, rbf, LR, p.w1, F, 16 * wm, 32 * wn, KR, R, F);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; v += 2) {
          float h[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float x = y[0][nt][v + u];
            h[u] = fmaxf(x, 0.f) + log1p_<BF16>(exp_<BF16>(-fabsf(x))) - LOG2F;
          }
          st2(hs + pr(v) * LH + pc(nt, v), h[0], h[1]);
        }
      __syncthreads();
      // w = h W2 + b2; the gated terms gate w vj[j]
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) y[0][nt][v] = b2s[pc(nt, v)];
      if constexpr (BF16)
        tiles<true, 1, 4, false, false>(y, hs, LH, W2h, LW, 16 * wm, 32 * wn, F, F, F);
      else
        tiles<false, 1, 4, false, false>(y, hs, LH, p.w2, F, 16 * wm, 32 * wn, F, F, F);
#pragma unroll
      for (int v = 0; v < 4; v += 2) {
        const int row = pr(v);
        const float gt = pg[row];
        const float* vv = vjs + pj[row] * LV;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = pc(nt, v);
          const float2 vj2 = *reinterpret_cast<const float2*>(vv + col);
          st2(ts + row * LT + col, (gt * y[0][nt][v]) * vj2.x, (gt * y[0][nt][v + 1]) * vj2.y);
        }
      }
      __syncthreads();
      add_runs<NT, F>(rst, lst + b0, n, ts, LT, accs, LV);  // into the out rows
    }
    __syncthreads();
    for (int x = tid; x < n * F; x += NT)
      p.out[(size_t)g * n * F + x] = accs[(x / F) * LV + x % F];
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The VJP of cfconv, a block per slot g (grid-strided). Only pairs with
// d < cutoff contribute, so the slot's in-cutoff pairs are listed once by
// warp ballots over the whole [n, n] block in (j, i) order, the transpose
// of the forward's walk: d_vj[j] = sum_i gate w gout[i] is then a sum over
// a run of consecutive pairs. The list is walked PT pairs a tile, across
// row boundaries; per tile:
//  - the basis rbf [PT][KR] (rounded to bf16 in bf16 precision), each
//    pair's gate, i and j, and the tile's runs of equal j;
//  - pre = rbf W1 + b1; h = sps(pre) (rounded), and sigmoid(pre) kept in
//    registers, one exp(-|pre|) for both;
//  - w = h W2 + b2; per pair and feature dwg = gout[i] vj[j], dp2 = dwg
//    gate (rounded), the d_vj term gate w gout[i], and with DIST the gate's
//    cotangent sum_f w dwg; db2 += dp2;
//  - dh = dp2 W2^T, dp1 = dh sigmoid(pre) (rounded), db1 += dp1, while the
//    threads of each run sum its d_vj terms in pair order into d_vj[j];
//  - dW1 += rbf^T dp1 and dW2 += h^T dp2 with the pairs as the reduction
//    dimension, kept in registers across tiles and slots; with DIST d_rbf =
//    dp1 W1^T and d_dist = sum_r d_rbf drbf/dd + d_gate dgate/dd.
// In bf16 precision the products run on the tensor cores (mma.sync, bf16
// operands, float32 sums) with W1 and W2 staged as bf16; in float32 on the
// FP32 pipes, the weights read through the L1 cache. The pair rows past
// the list's end have gate 0 and rbf 0, so they add nothing. Every sum has
// a fixed order and no atomics are used: the same inputs give the same
// bits. The weight gradients go to the block's row of the partial-sum
// scratch.
template <int F, bool BF16, bool DIST>
__global__ void __launch_bounds__(F * 4, 512 / (F * 4)) cfconv_bwd_kernel(Params p) {
  using Cfg = WalkCfg<F>;
  using E = Elem<BF16>;
  constexpr int NT = Cfg::NT, WN = Cfg::WN, NTR = Cfg::NTR;
  constexpr int MT2 = Cfg::MT2, NT2 = Cfg::NT2, MG2 = Cfg::MG2, TPP = Cfg::TPP;
  extern __shared__ __align__(16) unsigned char sm[];
  const int n = p.n, R = p.R, nn = n * n;
  const BwdLayout L = bwd_layout<F, BF16>(n);
  const int LW = L.LW, LR = L.LR, LH = L.LH, LT = L.LT, LV = L.LV;
  E* W1h = reinterpret_cast<E*>(sm + L.w1);     // [KR][LW] (bf16)
  E* W2h = reinterpret_cast<E*>(sm + L.w2);     // [F][LW] (bf16)
  float* b1s = reinterpret_cast<float*>(sm + L.b1);
  float* b2s = reinterpret_cast<float*>(sm + L.b2);
  float* vjs = reinterpret_cast<float*>(sm + L.vj);    // [n][LV]
  float* gos = reinterpret_cast<float*>(sm + L.go);    // [n][LV]
  float* dvjs = reinterpret_cast<float*>(sm + L.dvj);  // [n][LV]
  E* rbf = reinterpret_cast<E*>(sm + L.rbf);           // [PT][LR]
  E* hs = reinterpret_cast<E*>(sm + L.hs);             // [PT][LH]
  E* dp2s = reinterpret_cast<E*>(sm + L.dp2);          // [PT][LH]
  E* dp1s = reinterpret_cast<E*>(sm + L.dp1);          // [PT][LH], over ts
  float* ts = reinterpret_cast<float*>(sm + L.dp1);    // [PT][LT] d_vj terms
  int* pi = reinterpret_cast<int*>(sm + L.pi);
  int* pj = reinterpret_cast<int*>(sm + L.pj);
  float* pd = reinterpret_cast<float*>(sm + L.pd);
  float* pg = reinterpret_cast<float*>(sm + L.pg);     // gate
  float* pdg = reinterpret_cast<float*>(sm + L.pdg);   // d gate / d dist
  int* rst = reinterpret_cast<int*>(sm + L.rst);       // run starts, [PT + 1] and the count
  float* dgp = reinterpret_cast<float*>(sm + L.dgp);   // [WN][PT] d_gate partials
  float* ddp = reinterpret_cast<float*>(sm + L.ddp);   // [WN][PT] d_dist-via-basis partials
  float* dbs1 = reinterpret_cast<float*>(sm + L.dbs1); // [4][F] db1 by row group
  float* dbs2 = reinterpret_cast<float*>(sm + L.dbs2); // [4][F] db2 by row group
  int* lst = reinterpret_cast<int*>(sm + L.lst);       // [n n] pairs j n + i
  int* wcnt = reinterpret_cast<int*>(sm + L.wcnt);
  unsigned* bits = reinterpret_cast<unsigned*>(sm + L.bits);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;      // the pair-row products, dW1
  const int wm2 = warp % MG2, wn2 = warp / MG2;  // dW2
  const int r4 = lane >> 2, c2 = (lane & 3) * 2;
  if constexpr (BF16) {
    for (int x = tid; x < KR * F; x += NT) {
      const int r = x / F, f = x % F;
      W1h[r * LW + f] = __float2bfloat16_rn(r < R ? p.w1[x] : 0.f);
    }
    for (int x = tid; x < F * F; x += NT) W2h[(x / F) * LW + x % F] = __float2bfloat16_rn(p.w2[x]);
  }
  for (int f = tid; f < F; f += NT) {
    b1s[f] = p.b1[f];
    b2s[f] = p.b2[f];
  }
  for (int x = tid; x < 4 * F; x += NT) dbs1[x] = dbs2[x] = 0.f;
  float dW1[1][4][4], dW2[MT2][NT2][4];
  zero_acc(dW1);
  zero_acc(dW2);
  // the pair-row products' elements: row pr(v), column pc(nt, v)
  auto pr = [=](int v) { return 16 * wm + r4 + 8 * (v >> 1); };
  auto pc = [=](int nt, int v) { return 32 * wn + 8 * nt + c2 + (v & 1); };

  for (int g = blockIdx.x; g < p.G; g += gridDim.x) {
    const float* dist = p.dist + (size_t)g * nn;
    float* d_dist = p.d_dist + (size_t)g * nn;
    __syncthreads();  // the previous slot is done
    for (int x = tid; x < n * F; x += NT) {
      const int r = x / F, f = x % F;
      vjs[r * LV + f] = rnd<BF16>(p.vj[(size_t)g * n * F + x]);
      gos[r * LV + f] = p.gout[(size_t)g * n * F + x];
      dvjs[r * LV + f] = 0.f;
    }
    // in-cutoff pairs in (j, i) order: position x = j n + i; d_dist is 0
    // at the others (and at all without DIST)
    const int nl = list_pairs<NT>(nn, L.rounds, [&](int x) {
      const int at = (x % n) * n + x / n;
      const bool real = dist[at] < p.cutoff;
      if (!(DIST && real)) d_dist[at] = 0.f;
      return real;
    }, lst, wcnt, bits);

    for (int b0 = 0; b0 < nl; b0 += PT) {
      const int cnt = min(PT, nl - b0);
      if (b0 > 0) __syncthreads();  // the previous tile is done
      // the basis rows, TPP threads a pair, and the pairs' i, j, gate
      {
        const int pp = tid / TPP, sub = tid % TPP;
        const bool ok = pp < cnt;
        const int x = ok ? lst[b0 + pp] : 0;
        const int j = x / n, i = x % n;
        const float d = ok ? dist[i * n + j] : 0.f;
        if (sub == 0) {
          pi[pp] = i;
          pj[pp] = j;
          pd[pp] = d;
          pg[pp] = ok ? 0.5f * (cosf(d * p.pi_c) + 1.f) : 0.f;
          pdg[pp] = ok && DIST ? -0.5f * p.pi_c * sinf(d * p.pi_c) : 0.f;
        }
        stage_rbf<BF16, KR / TPP>(p, d, ok, sub * (KR / TPP), rbf + pp * LR);
      }
      if (warp == 0) list_runs(lst + b0, cnt, n, rst);  // the runs of equal j
      __syncthreads();
      // pre = rbf W1 + b1, h = sps(pre), sigmoid(pre) in registers
      float acc[1][4][4], sig[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[0][nt][v] = b1s[pc(nt, v)];
      if constexpr (BF16)
        tiles<true, 1, 4, false, false>(acc, rbf, LR, W1h, LW, 16 * wm, 32 * wn, KR, KR, F);
      else
        tiles<false, 1, 4, false, false>(acc, rbf, LR, p.w1, F, 16 * wm, 32 * wn, KR, R, F);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; v += 2) {
          float h[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float x = acc[0][nt][v + u];
            const float e = exp_<BF16>(-fabsf(x));
            h[u] = fmaxf(x, 0.f) + log1p_<BF16>(e) - LOG2F;
            sig[nt][v + u] = BF16 ? __fdividef(x >= 0.f ? 1.f : e, 1.f + e)
                                  : (x >= 0.f ? 1.f : e) / (1.f + e);
          }
          st2(hs + pr(v) * LH + pc(nt, v), h[0], h[1]);
        }
      __syncthreads();
      // w = h W2 + b2; dp2, the d_vj terms, d_gate, db2
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[0][nt][v] = b2s[pc(nt, v)];
      if constexpr (BF16)
        tiles<true, 1, 4, false, false>(acc, hs, LH, W2h, LW, 16 * wm, 32 * wn, F, F, F);
      else
        tiles<false, 1, 4, false, false>(acc, hs, LH, p.w2, F, 16 * wm, 32 * wn, F, F, F);
      {
        float csum[4][2], dg[2] = {0.f, 0.f};
#pragma unroll
        for (int v = 0; v < 4; v += 2) {
          const int row = pr(v);
          const float gt = pg[row];
          const float* go = gos + pi[row] * LV;
          const float* vv = vjs + pj[row] * LV;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float dp2[2], tv[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int col = pc(nt, v + u);
              const float w = acc[0][nt][v + u], gof = go[col];
              const float dwg = gof * vv[col];
              if constexpr (DIST) dg[v >> 1] = fmaf(w, dwg, dg[v >> 1]);
              dp2[u] = dwg * gt;
              tv[u] = w * gt * gof;
              csum[nt][u] = v == 0 ? dp2[u] : csum[nt][u] + dp2[u];
            }
            st2(dp2s + row * LH + pc(nt, v), dp2[0], dp2[1]);
            st2(ts + row * LT + pc(nt, v), tv[0], tv[1]);
          }
        }
        add_column_sums(csum, dbs2 + wm * F + 32 * wn);
        if constexpr (DIST) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = row_sum(dg[h]);
            if ((lane & 3) == 0) dgp[wn * PT + pr(2 * h)] = s;
          }
        }
      }
      __syncthreads();
      add_runs<NT, F>(rst, lst + b0, n, ts, LT, dvjs, LV);  // into d_vj[j]
      // dh = dp2 W2^T
      zero_acc(acc);
      if constexpr (BF16)
        tiles<true, 1, 4, false, true>(acc, dp2s, LH, W2h, LW, 16 * wm, 32 * wn, F, F, F);
      else
        tiles<false, 1, 4, false, true>(acc, dp2s, LH, p.w2, F, 16 * wm, 32 * wn, F, F, F);
      __syncthreads();  // the d_vj terms are read: dp1 goes over them
      {
        float csum[4][2];
#pragma unroll
        for (int v = 0; v < 4; v += 2)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float dp1[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              dp1[u] = acc[0][nt][v + u] * sig[nt][v + u];
              csum[nt][u] = v == 0 ? dp1[u] : csum[nt][u] + dp1[u];
            }
            st2(dp1s + pr(v) * LH + pc(nt, v), dp1[0], dp1[1]);
          }
        add_column_sums(csum, dbs1 + wm * F + 32 * wn);
      }
      __syncthreads();
      // dW1 += rbf^T dp1, dW2 += h^T dp2 over the tile's pairs
      tiles<BF16, 1, 4, true, false>(dW1, rbf, LR, dp1s, LH, 16 * wm, 32 * wn, PT, PT, F);
      tiles<BF16, MT2, NT2, true, false>(dW2, hs, LH, dp2s, LH, 16 * MT2 * wm2, 8 * NT2 * wn2,
                                         PT, PT, F);
      if constexpr (DIST) {
        // d_rbf = dp1 W1^T; d_dist via the basis: sum_r d_rbf rbf 2 coeff (d - r delta)
        float dr[1][NTR][4];
        zero_acc(dr);
        if constexpr (BF16)
          tiles<true, 1, NTR, false, true>(dr, dp1s, LH, W1h, LW, 16 * wm, 8 * NTR * wn, F, F, R);
        else
          tiles<false, 1, NTR, false, true>(dr, dp1s, LH, p.w1, F, 16 * wm, 8 * NTR * wn, F, F, R);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * wm + r4 + 8 * h;
          const float d = pd[row];
          float s = 0.f;
#pragma unroll
          for (int nt = 0; nt < NTR; ++nt)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int r = 8 * NTR * wn + 8 * nt + c2 + u;
              if (r < R) {
                const float dd = d - r * p.delta_mu;
                const float e = exp_<BF16>(p.coeff * dd * dd);
                s = fmaf(dr[0][nt][2 * h + u] * e, (2.f * p.coeff) * dd, s);
              }
            }
          s = row_sum(s);
          if ((lane & 3) == 0) ddp[wn * PT + row] = s;
        }
        __syncthreads();
        for (int q = tid; q < cnt; q += NT) {
          float sg = 0.f, sd = 0.f;
#pragma unroll
          for (int k = 0; k < WN; ++k) {
            sg += dgp[k * PT + q];
            sd += ddp[k * PT + q];
          }
          d_dist[pi[q] * n + pj[q]] = sd + sg * pdg[q];
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < n * F; x += NT)
      p.d_vj[(size_t)g * n * F + x] = dvjs[(x / F) * LV + x % F];
  }

  // this block's weight-gradient partials: [dW1 R*F | db1 F | dW2 F*F | db2 F]
  float* part = p.partial + (size_t)blockIdx.x * ((size_t)R * F + F + F * F + F);
  float* pW2 = part + R * F + F;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = pr(v);
      if (r < R) part[r * F + pc(nt, v)] = dW1[0][nt][v];
    }
#pragma unroll
  for (int mt = 0; mt < MT2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int k = 16 * (MT2 * wm2 + mt) + r4 + 8 * (v >> 1);
        const int f = 8 * (NT2 * wn2 + nt) + c2 + (v & 1);
        pW2[k * F + f] = dW2[mt][nt][v];
      }
  __syncthreads();
  for (int f = tid; f < F; f += NT) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s1 += dbs1[q * F + f];
      s2 += dbs2[q * F + f];
    }
    part[R * F + f] = s1;
    pW2[F * F + f] = s2;
  }
}

// The forward on a grid of SMs x its occupancy (at most G blocks).
template <int F, bool BF16>
int fwd_launch(const Params& p, cudaStream_t s) {
  const size_t smem = fwd_layout<F, BF16>(p.n).total;
  int grid = 0;
  const int rc = occupancy_grid(cfconv_fwd_kernel<F, BF16>, F * 4, smem, p.G, &grid);
  if (rc != 0) return rc;
  return launch(cfconv_fwd_kernel<F, BF16>, grid, F * 4, smem, s, p);
}

template <int F>
int fwd_f(const Params& p, int bf16, cudaStream_t s) {
  if (bf16) return fwd_launch<F, true>(p, s);
  return fwd_launch<F, false>(p, s);
}

template <int F, bool BF16, bool DIST>
int bwd_launch(const Params& p, int grid, cudaStream_t s) {
  return launch(cfconv_bwd_kernel<F, BF16, DIST>, grid, F * 4, bwd_layout<F, BF16>(p.n).total, s,
                p);
}

template <int F>
int bwd_f(const Params& p, int bf16, int need_dist, int grid, cudaStream_t s) {
  if (bf16) return need_dist ? bwd_launch<F, true, true>(p, grid, s) : bwd_launch<F, true, false>(p, grid, s);
  return need_dist ? bwd_launch<F, false, true>(p, grid, s) : bwd_launch<F, false, false>(p, grid, s);
}

// The backward's grid: the occupancy of the instance with d_dist, whichever
// runs, so that both partition the weight gradients alike.
template <int F>
int bwd_grid(const Params& p, int bf16, int* blocks) {
  if (bf16)
    return occupancy_grid(cfconv_bwd_kernel<F, true, true>, F * 4, bwd_layout<F, true>(p.n).total,
                          p.G, blocks);
  return occupancy_grid(cfconv_bwd_kernel<F, false, true>, F * 4, bwd_layout<F, false>(p.n).total,
                        p.G, blocks);
}

Params make_params(int G, int n, int R, float cutoff, int num_gaussians) {
  Params p{};
  p.G = G;
  p.n = n;
  p.R = R;
  p.cutoff = cutoff;
  p.delta_mu = cutoff / (float)(num_gaussians - 1);
  p.coeff = -0.5f / (p.delta_mu * p.delta_mu);
  p.pi_c = 3.14159265358979323846f / cutoff;
  return p;
}

}  // namespace

extern "C" {

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM.
int cfconv_fwd(const float* dist, const float* vj, const float* w1,
               const float* b1, const float* w2, const float* b2, float* out,
               int G, int n, int F, int R, float cutoff, int num_gaussians,
               int bf16, void* stream) {
  if (R < 1 || R > KR) return ERR_SHAPE;
  Params p = make_params(G, n, R, cutoff, num_gaussians);
  p.dist = dist; p.vj = vj; p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 32: return fwd_f<32>(p, bf16, s);
    case 64: return fwd_f<64>(p, bf16, s);
    case 128: return fwd_f<128>(p, bf16, s);
    default: return ERR_SHAPE;
  }
}

// Number of blocks of the backward (rows of its partial-sum scratch) at G
// slots of n atoms: SMs x the kernel's occupancy, at most G; ERR_SHAPE /
// ERR_SMEM for a shape the kernel does not take, -1 for a CUDA error.
int cfconv_bwd_blocks(int G, int n, int F, int R, int bf16) {
  if (G < 1 || n < 1 || R < 1 || R > KR) return ERR_SHAPE;
  Params p{};
  p.G = G;
  p.n = n;
  p.R = R;
  int blocks = -1, rc;
  switch (F) {
    case 32: rc = bwd_grid<32>(p, bf16, &blocks); break;
    case 64: rc = bwd_grid<64>(p, bf16, &blocks); break;
    case 128: rc = bwd_grid<128>(p, bf16, &blocks); break;
    default: return ERR_SHAPE;
  }
  return rc == 0 ? blocks : rc < 0 ? rc : -1;
}

// partial: [grid, R*F + F + F*F + F] scratch with grid =
// cfconv_bwd_blocks(G, n, F, R, bf16); d_params: [R*F + F + F*F + F]
// receives dW1 | db1 | dW2 | db2. d_dist is written in full (zeros without
// need_dist).
int cfconv_bwd(const float* dist, const float* vj, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* gout, float* d_dist, float* d_vj, float* partial,
               float* d_params, int G, int n, int F, int R, float cutoff,
               int num_gaussians, int bf16, int need_dist, int grid,
               void* stream) {
  if (R < 1 || R > KR) return ERR_SHAPE;
  Params p = make_params(G, n, R, cutoff, num_gaussians);
  p.dist = dist; p.vj = vj; p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.gout = gout; p.d_dist = d_dist; p.d_vj = d_vj; p.partial = partial;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (F) {
    case 32: rc = bwd_f<32>(p, bf16, need_dist, grid, s); break;
    case 64: rc = bwd_f<64>(p, bf16, need_dist, grid, s); break;
    case 128: rc = bwd_f<128>(p, bf16, need_dist, grid, s); break;
    default: return ERR_SHAPE;
  }
  if (rc != 0) return rc;
  const int size = R * F + F + F * F + F;
  return sum_partials(partial, grid, size, d_params, s);
}

}  // extern "C"
