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
//    output, so each row first compacts its in-cutoff pairs (warp ballot)
//    and only those are computed.
//  - One block walks whole slots g (grid-strided), so d_vj[g] (a sum over
//    rows i) and d_dist stay block-local and need no atomics. The weight
//    gradients are per-block register partials written to a [blocks, ...]
//    scratch and summed by a second kernel in a fixed order: the same bits
//    on every run.
//  - Products run on the FP32 pipes with register tiles of 4 pair rows x 4
//    features per thread. In "bf16" precision the operands the TPU kernel
//    rounds (vj, W1, W2, rbf, h, d_pre2, d_pre1) are rounded to bf16 before
//    each product; bf16 x bf16 is exact in f32 and sums are f32, as on a
//    tensor core. Moving the products to wgmma is later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int JT = 32;   // pair rows (in-cutoff j of one row i) per chunk
constexpr int JQ = 8;    // thread groups along the chunk; each owns 4 rows
constexpr int RMAX = 64; // largest padded basis size the register tiles hold
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
  int G, n, R, Rp;
  float cutoff, coeff, delta_mu, pi_c;
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// In-cutoff pairs of one row, in j order: dvals[0..nv), jidx[0..nv).
__device__ void compact_row(const float* drow, int n, float cutoff,
                            float* dvals, int* jidx, int* nvs) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const float d = j < n ? drow[j] : 0.f;
      const bool ok = j < n && d < cutoff;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        dvals[pos] = d;
        jidx[pos] = j;
      }
      base += __popc(m);
    }
    if (lane == 0) *nvs = base;
  }
  __syncthreads();
}

// acc[b][c] (+)= sum_r A[jq*4+b][r] * W1s[r][fq + c*F/4]; with DUAL also
// acc2 from A2 (the geometry term of the backward).
template <int F, bool DUAL>
__device__ __forceinline__ void gemm_w1(const float* A, const float* A2,
                                        const float* W1s, int Rp, int jq,
                                        int fq, float acc[4][4],
                                        float acc2[4][4]) {
  constexpr int F4 = F / 4;
  for (int r = 0; r < Rp; r += 4) {
    float4 a[4], a2[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      a[b] = ld4(&A[(jq * 4 + b) * Rp + r]);
      if constexpr (DUAL) a2[b] = ld4(&A2[(jq * 4 + b) * Rp + r]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = W1s[(r + u) * F + fq + c * F4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[b][c] = fmaf(comp(a[b], u), wv[c], acc[b][c]);
          if constexpr (DUAL) acc2[b][c] = fmaf(comp(a2[b], u), wv[c], acc2[b][c]);
        }
      }
    }
  }
}

// acc[b][c] += sum_k H[jq*4+b][k] * W2s[k][fq + c*F/4]   (W2s row stride F+4)
template <int F>
__device__ __forceinline__ void gemm_w2(const float* H, const float* W2s,
                                        int jq, int fq, float acc[4][4]) {
  constexpr int F4 = F / 4;
#pragma unroll 2
  for (int k = 0; k < F; k += 4) {
    float4 a[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) a[b] = ld4(&H[(jq * 4 + b) * F + k]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = W2s[(k + u) * (F + 4) + fq + c * F4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[b][c] = fmaf(comp(a[b], u), wv[c], acc[b][c]);
      }
    }
  }
}

// acc[b][c] += sum_f D[jq*4+b][f] * W2s[fq + c*F/4][f]   (product with W2^T)
template <int F>
__device__ __forceinline__ void gemm_w2t(const float* D, const float* W2s,
                                         int jq, int fq, float acc[4][4]) {
  constexpr int F4 = F / 4;
#pragma unroll 2
  for (int f = 0; f < F; f += 4) {
    float4 a[4], wv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) a[b] = ld4(&D[(jq * 4 + b) * F + f]);
#pragma unroll
    for (int c = 0; c < 4; ++c) wv[c] = ld4(&W2s[(fq + c * F4) * (F + 4) + f]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[b][c] = fmaf(comp(a[b], u), comp(wv[c], u), acc[b][c]);
      }
    }
  }
}

template <bool BF16, int F>
__device__ void load_weights(const Params& p, float* W1s, float* W2s,
                             float* b1s, float* b2s) {
  const int NT = blockDim.x;
  for (int x = threadIdx.x; x < p.Rp * F; x += NT) {
    W1s[x] = (x / F) < p.R ? rnd<BF16>(p.w1[x]) : 0.f;
  }
  for (int x = threadIdx.x; x < F * F; x += NT) {
    W2s[(x / F) * (F + 4) + x % F] = rnd<BF16>(p.w2[x]);
  }
  for (int f = threadIdx.x; f < F; f += NT) {
    b1s[f] = p.b1[f];
    b2s[f] = p.b2[f];
  }
}

size_t fwd_smem_floats(int n, int F, int Rp) {
  return (size_t)Rp * F + (size_t)F * (F + 4) + 2 * F + (size_t)n * F +
         JT * Rp + JT * F + JQ * F + JT + 2 * n + 1;
}

size_t bwd_smem_floats(int n, int F, int Rp) {
  return (size_t)Rp * F + (size_t)F * (F + 4) + 2 * F + 2 * (size_t)n * F +
         F + 2 * JT * Rp + 3 * JT * F + 2 * JT * (F / 4) + 2 * JT + 2 * n + 1;
}

template <int F, bool BF16>
__global__ void __launch_bounds__(F / 4 * JQ, 1) cfconv_fwd_kernel(Params p) {
  constexpr int F4 = F / 4;
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, Rp = p.Rp;
  float* W1s = smem;                  // [Rp][F]
  float* W2s = W1s + Rp * F;          // [F][F+4]
  float* b1s = W2s + F * (F + 4);     // [F]
  float* b2s = b1s + F;               // [F]
  float* vjs = b2s + F;               // [n][F]
  float* rbfs = vjs + n * F;          // [JT][Rp]
  float* hs = rbfs + JT * Rp;         // [JT][F]
  float* reds = hs + JT * F;          // [JQ][F]
  float* gates = reds + JQ * F;       // [JT]
  float* dvals = gates + JT;          // [n]
  int* jidx = reinterpret_cast<int*>(dvals + n);  // [n]
  int* nvs = jidx + n;

  const int tid = threadIdx.x, NT = blockDim.x;
  const int fq = tid % F4, jq = tid / F4;
  load_weights<BF16, F>(p, W1s, W2s, b1s, b2s);

  for (int g = blockIdx.x; g < p.G; g += gridDim.x) {
    __syncthreads();
    for (int x = tid; x < n * F; x += NT) vjs[x] = rnd<BF16>(p.vj[(size_t)g * n * F + x]);
    for (int i = 0; i < n; ++i) {
      const size_t row = (size_t)g * n + i;
      compact_row(p.dist + row * n, n, p.cutoff, dvals, jidx, nvs);
      const int nv = *nvs;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < nv; c0 += JT) {
        const int cnt = min(JT, nv - c0);
        for (int x = tid; x < JT * Rp; x += NT) {
          const int jj = x / Rp, r = x % Rp;
          float v = 0.f;
          if (jj < cnt && r < p.R) {
            const float dd = dvals[c0 + jj] - r * p.delta_mu;
            v = rnd<BF16>(expf(p.coeff * dd * dd));
          }
          rbfs[x] = v;
        }
        for (int jj = tid; jj < JT; jj += NT) {
          gates[jj] = jj < cnt ? 0.5f * (cosf(dvals[c0 + jj] * p.pi_c) + 1.f) : 0.f;
        }
        __syncthreads();
        float pre[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) pre[b][c] = b1s[fq + c * F4];
        gemm_w1<F, false>(rbfs, nullptr, W1s, Rp, jq, fq, pre, pre);
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            hs[(jq * 4 + b) * F + fq + c * F4] = rnd<BF16>(softplus(pre[b][c]) - LOG2F);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) w[b][c] = b2s[fq + c * F4];
        gemm_w2<F>(hs, W2s, jq, fq, w);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jj = jq * 4 + b;
          if (jj < cnt) {
            const int j = jidx[c0 + jj];
            const float gt = gates[jj];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[c] = fmaf(gt * w[b][c], vjs[j * F + fq + c * F4], acc[c]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) reds[jq * F + fq + c * F4] = acc[c];
      __syncthreads();
      for (int f = tid; f < F; f += NT) {
        float s = 0.f;
        for (int q = 0; q < JQ; ++q) s += reds[q * F + f];
        p.out[row * F + f] = s;
      }
    }
  }
}

template <int F, bool BF16, bool DIST>
__global__ void __launch_bounds__(F / 4 * JQ, 1) cfconv_bwd_kernel(Params p) {
  constexpr int F4 = F / 4;
  constexpr int KD = F / JQ;      // dW2 rows per thread: k = jq + JQ*d
  constexpr int RD = RMAX / JQ;   // dW1 rows per thread: r = jq + JQ*e
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, Rp = p.Rp;
  float* W1s = smem;                  // [Rp][F]
  float* W2s = W1s + Rp * F;          // [F][F+4]
  float* b1s = W2s + F * (F + 4);
  float* b2s = b1s + F;
  float* vjs = b2s + F;               // [n][F]
  float* dvjs = vjs + n * F;          // [n][F]
  float* gos = dvjs + n * F;          // [F]
  float* rbfs = gos + F;              // [JT][Rp] rounded basis
  float* cs = rbfs + JT * Rp;         // [JT][Rp] d rbf / d dist (f32)
  float* hs = cs + JT * Rp;           // [JT][F]
  float* dp2s = hs + JT * F;          // [JT][F]
  float* dp1s = dp2s + JT * F;        // [JT][F]
  float* dgps = dp1s + JT * F;        // [JT][F4] partial d_gate
  float* ddps = dgps + JT * F4;       // [JT][F4] partial d_dist via basis
  float* gates = ddps + JT * F4;      // [JT]
  float* dgdds = gates + JT;          // [JT] d gate / d dist
  float* dvals = dgdds + JT;          // [n]
  int* jidx = reinterpret_cast<int*>(dvals + n);
  int* nvs = jidx + n;

  const int tid = threadIdx.x, NT = blockDim.x;
  const int fq = tid % F4, jq = tid / F4;
  load_weights<BF16, F>(p, W1s, W2s, b1s, b2s);

  float accW2[KD][4], accW1[RD][4], db1a[4], db2a[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    db1a[c] = 0.f;
    db2a[c] = 0.f;
#pragma unroll
    for (int d = 0; d < KD; ++d) accW2[d][c] = 0.f;
#pragma unroll
    for (int e = 0; e < RD; ++e) accW1[e][c] = 0.f;
  }

  for (int g = blockIdx.x; g < p.G; g += gridDim.x) {
    __syncthreads();
    for (int x = tid; x < n * F; x += NT) {
      vjs[x] = rnd<BF16>(p.vj[(size_t)g * n * F + x]);
      dvjs[x] = 0.f;
    }
    for (int i = 0; i < n; ++i) {
      const size_t row = (size_t)g * n + i;
      for (int j = tid; j < n; j += NT) p.d_dist[row * n + j] = 0.f;
      for (int f = tid; f < F; f += NT) gos[f] = p.gout[row * F + f];
      compact_row(p.dist + row * n, n, p.cutoff, dvals, jidx, nvs);
      const int nv = *nvs;
      for (int c0 = 0; c0 < nv; c0 += JT) {
        const int cnt = min(JT, nv - c0);
        for (int x = tid; x < JT * Rp; x += NT) {
          const int jj = x / Rp, r = x % Rp;
          float v = 0.f, cv = 0.f;
          if (jj < cnt && r < p.R) {
            const float dd = dvals[c0 + jj] - r * p.delta_mu;
            const float e = expf(p.coeff * dd * dd);
            v = rnd<BF16>(e);
            cv = e * (2.f * p.coeff) * dd;
          }
          rbfs[x] = v;
          if constexpr (DIST) cs[x] = cv;
        }
        for (int jj = tid; jj < JT; jj += NT) {
          const float d = jj < cnt ? dvals[c0 + jj] : 0.f;
          gates[jj] = jj < cnt ? 0.5f * (cosf(d * p.pi_c) + 1.f) : 0.f;
          if constexpr (DIST) dgdds[jj] = jj < cnt ? -0.5f * p.pi_c * sinf(d * p.pi_c) : 0.f;
        }
        __syncthreads();
        // recompute the filter
        float pre[4][4], q[4][4], w[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pre[b][c] = b1s[fq + c * F4];
            q[b][c] = 0.f;
            w[b][c] = b2s[fq + c * F4];
          }
        gemm_w1<F, DIST>(rbfs, cs, W1s, Rp, jq, fq, pre, q);
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            hs[(jq * 4 + b) * F + fq + c * F4] = rnd<BF16>(softplus(pre[b][c]) - LOG2F);
        __syncthreads();
        gemm_w2<F>(hs, W2s, jq, fq, w);
        // d_vj, d_gate, d_pre2
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jj = jq * 4 + b;
          const bool ok = jj < cnt;
          const int j = ok ? jidx[c0 + jj] : 0;
          const float gt = gates[jj];
          float dg = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int f = fq + c * F4;
            const float gof = gos[f];
            if (ok) dvjs[j * F + f] += w[b][c] * gt * gof;
            const float dwg = gof * vjs[j * F + f];
            dg = fmaf(w[b][c], dwg, dg);
            const float dp2 = dwg * gt;
            db2a[c] += dp2;
            dp2s[jj * F + f] = rnd<BF16>(dp2);
          }
          dgps[jj * F4 + fq] = dg;
        }
        __syncthreads();
        // d_h = d_pre2 @ W2^T, d_pre1 = d_h * sigmoid(pre1)
        float dh[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) dh[b][c] = 0.f;
        gemm_w2t<F>(dp2s, W2s, jq, fq, dh);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jj = jq * 4 + b;
          float dd = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float dp1 = dh[b][c] / (1.f + expf(-pre[b][c]));
            db1a[c] += dp1;
            const float r1 = rnd<BF16>(dp1);
            dp1s[jj * F + fq + c * F4] = r1;
            if constexpr (DIST) dd = fmaf(r1, q[b][c], dd);
          }
          if constexpr (DIST) ddps[jj * F4 + fq] = dd;
        }
        __syncthreads();
        // weight-gradient partials over this chunk's pairs
        for (int jj = 0; jj < cnt; ++jj) {
          float p2[4], p1[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p2[c] = dp2s[jj * F + fq + c * F4];
            p1[c] = dp1s[jj * F + fq + c * F4];
          }
#pragma unroll
          for (int d = 0; d < KD; ++d) {
            const float hv = hs[jj * F + jq + JQ * d];
#pragma unroll
            for (int c = 0; c < 4; ++c) accW2[d][c] = fmaf(hv, p2[c], accW2[d][c]);
          }
#pragma unroll
          for (int e = 0; e < RD; ++e) {
            const int r = jq + JQ * e;
            if (r < Rp) {
              const float rv = rbfs[jj * Rp + r];
#pragma unroll
              for (int c = 0; c < 4; ++c) accW1[e][c] = fmaf(rv, p1[c], accW1[e][c]);
            }
          }
        }
        if constexpr (DIST) {
          for (int jj = tid; jj < cnt; jj += NT) {
            float sg = 0.f, sd = 0.f;
            for (int k = 0; k < F4; ++k) {
              sg += dgps[jj * F4 + k];
              sd += ddps[jj * F4 + k];
            }
            p.d_dist[row * n + jidx[c0 + jj]] = sd + sg * dgdds[jj];
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
    for (int x = tid; x < n * F; x += NT) p.d_vj[(size_t)g * n * F + x] = dvjs[x];
  }

  // this block's weight-gradient partials: [dW1 R*F | db1 F | dW2 F*F | db2 F]
  float* part = p.partial + (size_t)blockIdx.x * ((size_t)p.R * F + F + F * F + F);
#pragma unroll
  for (int e = 0; e < RD; ++e) {
    const int r = jq + JQ * e;
    if (r < p.R) {
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r * F + fq + c * F4] = accW1[e][c];
    }
  }
  float* pW2 = part + p.R * F + F;
#pragma unroll
  for (int d = 0; d < KD; ++d) {
#pragma unroll
    for (int c = 0; c < 4; ++c) pW2[(jq + JQ * d) * F + fq + c * F4] = accW2[d][c];
  }
  float* red = hs;  // [JQ][F] scratch for the bias sums
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) red[jq * F + fq + c * F4] = which == 0 ? db1a[c] : db2a[c];
    __syncthreads();
    float* dst = which == 0 ? part + p.R * F : pW2 + F * F;
    for (int f = tid; f < F; f += NT) {
      float s = 0.f;
      for (int k = 0; k < JQ; ++k) s += red[k * F + f];
      dst[f] = s;
    }
  }
}

template <int F>
int fwd_f(const Params& p, int bf16, int grid, cudaStream_t s) {
  const size_t smem = fwd_smem_floats(p.n, F, p.Rp) * sizeof(float);
  if (bf16) return launch(cfconv_fwd_kernel<F, true>, grid, F / 4 * JQ, smem, s, p);
  return launch(cfconv_fwd_kernel<F, false>, grid, F / 4 * JQ, smem, s, p);
}

template <int F>
int bwd_f(const Params& p, int bf16, int need_dist, int grid, cudaStream_t s) {
  const size_t smem = bwd_smem_floats(p.n, F, p.Rp) * sizeof(float);
  const int t = F / 4 * JQ;
  if (bf16 && need_dist) return launch(cfconv_bwd_kernel<F, true, true>, grid, t, smem, s, p);
  if (bf16) return launch(cfconv_bwd_kernel<F, true, false>, grid, t, smem, s, p);
  if (need_dist) return launch(cfconv_bwd_kernel<F, false, true>, grid, t, smem, s, p);
  return launch(cfconv_bwd_kernel<F, false, false>, grid, t, smem, s, p);
}

Params make_params(int G, int n, int R, float cutoff, int num_gaussians) {
  Params p{};
  p.G = G;
  p.n = n;
  p.R = R;
  p.Rp = (R + 3) / 4 * 4;
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
  if (R < 1 || R > RMAX) return ERR_SHAPE;
  Params p = make_params(G, n, R, cutoff, num_gaussians);
  p.dist = dist; p.vj = vj; p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 32: return fwd_f<32>(p, bf16, G, s);
    case 64: return fwd_f<64>(p, bf16, G, s);
    case 128: return fwd_f<128>(p, bf16, G, s);
    default: return ERR_SHAPE;
  }
}

// partial: [grid, R*F + F + F*F + F] scratch; d_params: [R*F + F + F*F + F]
// receives dW1 | db1 | dW2 | db2.
int cfconv_bwd(const float* dist, const float* vj, const float* w1,
               const float* b1, const float* w2, const float* b2,
               const float* gout, float* d_dist, float* d_vj, float* partial,
               float* d_params, int G, int n, int F, int R, float cutoff,
               int num_gaussians, int bf16, int need_dist, int grid,
               void* stream) {
  if (R < 1 || R > RMAX) return ERR_SHAPE;
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
