// Sorted-CSR segment sum for NVIDIA Hopper (sm_90a). Plain C interface,
// loaded through ctypes by dig_tpu_torch/ops/segment_csr.py.
//
// Replaces the Pallas TPU kernel of dig_tpu/ops/pallas_segment.py: _ss_fwd
// (pl.pallas_call at :156, _fwd_kernel).
//
//   out[r, :] = sum of data[e, :] over e in [rowptr[r], rowptr[r+1]) with seg[e] == r
//
// data [E, F] float32 or bf16, seg [E] int32 (-1 marks padding), rowptr
// [N+1] int32 -> out [N, F] float32. Every row is written; an empty row is
// written as zeros. Membership is by seg[e] == r, as the TPU kernel's one-hot
// decides it, so an edge with id -1 never counts.
//
// What bounds it on this card: a pure streaming reduction, one add per
// element read. The least traffic is each counted edge row, its id and the
// row pointers read once and the output written once,
//   E F sizeof(data) + 4 E + 4 (N + 1) + 4 N F bytes,
// so at 3.35 TB/s it is bound by bytes, never by operations.
//
// What the design does about it:
//  - One warp per output row walks the row's edge range in edge order. The
//    lanes cover the features, 4 consecutive values each (a 16-byte float4
//    in f32, an 8-byte load of 4 bf16 in bf16), so a warp reads whole
//    contiguous rows; the sum is kept in float32 registers.
//  - Four edges' loads are issued before any of them is added, to keep
//    loads in flight on short rows (the last four masked at the row's end,
//    so a row of n edges takes ceil(n / 4) rounds of loads).
//  - The order of every sum is fixed (edge order) and nothing uses atomics:
//    two runs on the same inputs give the same bits.
//  - Not carried over from the TPU: the 128-aligned DMA window, the one-hot
//    product on the MXU and the double buffering. Those fed a sequential
//    grid; here the rows run in parallel across the SMs.
//
// Deliberate deviation: the TPU kernel reads a fixed window of
// max_edges_per_block edges for each block of block_rows rows and drops the
// edges that do not fit (csr_block_overflow counts them). This kernel walks
// rowptr and drops nothing; the wrapper checks that csr_block_overflow is 0,
// so the two compute the same sum.
//
// The chunked sum replaces _ssc_fwd (pl.pallas_call at :325, _chunk_kernel
// at :195), the kernel of segment_sum_sorted_csr_chunked:
//
//   out[r, :] = sum of data[e, :] over the edges e of row block b = r / BN's
//               windows [meta[0][c], meta[0][c] + EB) with seg[e] == r
//
// meta [3, C] is plan_chunks' table (window starts, 128-aligned; row block;
// 1 on a block's first chunk): a block's chunks are consecutive and tile its
// rows' edges, so nothing is dropped. The output is float32 for bf16 data too.
// Its bound is the segment sum's: E F sizeof(data) + 4 E + 4 N F bytes over
// 3.35 TB/s (0.157 ms for f32 at E = 960,000, F = 128, N = 60,000).
//  - On the TPU, consecutive chunks of one row block accumulate into one
//    output tile that stays in VMEM across the sequential grid. Here blocks
//    run in parallel and in no order, and nothing carries from one to the
//    next, so the sum takes two passes, both as wide as the card:
//  - segment_csr_span_kernel: a block per chunk, a thread per window
//    position (eight loads in flight a thread), finds for the ids of its
//    chunk's row block where each row's run of edges starts and ends among
//    its warp's 32 edges (neighbours' ids by shuffle), and the run's ends
//    alone go to the span [2, N] by integer atomicMax: the complement of
//    the row's first edge and its last edge + 1. Integer maxima do not
//    depend on their order, so the span is the same on every call. Ids of
//    -1, ids outside the chunk's row block or at or past N, and window
//    positions past E (windows may run past the last edge by up to 2 EB:
//    JAX pads data by 2 EB for its DMA) are skipped. One memset on the
//    stream clears the span first (0x80808080, below any value written).
//  - Then segment_csr_kernel, the segment sum's own row loop, over
//    [~span[0][r], span[1][r]) in place of [rowptr[r], rowptr[r+1]): one
//    warp per row, the seg == r filter kept, each row's edges summed in
//    edge order, so the same bits as the segment sum; a row no window
//    holds has an empty range and is written as zeros; rows at or past N
//    are never written. No float atomics.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;         // rows per block of 256 threads
constexpr int UNROLL = 4;        // edges whose loads are in flight at once

// VEC consecutive values at p, as float32.
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = ld(p + i);
  }
}

// out[r, :] = the sum of data[e, :] over the e in [lo, hi) with seg[e] == r,
// in edge order, in float32; one warp, its lanes over the features (VEC
// consecutive values each), the loads of U edges in flight before any of
// them is added, the last U masked at hi (the order of the adds does not
// depend on U).
template <typename T, int VEC, int U>
__device__ __forceinline__ void row_sum(const T* __restrict__ data, const int* __restrict__ seg,
                                        float* __restrict__ out, int r, int lo, int hi, int F,
                                        int lane) {
  for (int c0 = lane * VEC; c0 < F; c0 += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int e = lo; e < hi; e += U) {
      float v[U][VEC];
      bool take[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        take[u] = e + u < hi && __ldg(seg + e + u) == r;
        if (take[u]) load<VEC>(data + (size_t)(e + u) * F + c0, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (take[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
        }
      }
    }
    float* o = out + (size_t)r * F + c0;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = acc[i];
    }
  }
}

// out[r, :] = the sum over e in [max(lo[r], 0), min(hi[r], E)) with
// seg[e] == r (lo[r] read as ~lo[r] when NOT_LO): the segment sum with
// lo = rowptr, hi = rowptr + 1, and the chunked sum's row sums over its
// span.
template <typename T, int VEC, bool NOT_LO>
__global__ void __launch_bounds__(WARPS * 32)
segment_csr_kernel(const T* __restrict__ data, const int* __restrict__ seg,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   float* __restrict__ out, int E, int F, int N) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= N) return;
  const int l = NOT_LO ? ~lo[r] : lo[r];
  row_sum<T, VEC, UNROLL>(data, seg, out, r, max(l, 0), min(hi[r], E), F, lane);
}

constexpr int SPAN_BATCH = 8;  // window pieces of 128 whose ids are loaded at once

// The span pass of the chunked sum: block c reads chunk c's window, 128 ids
// a step, SPAN_BATCH steps' loads in flight (a warp's 32 ids never span two
// chunks). A run is a maximal set of neighbouring lanes holding one id of
// the chunk's row block; its first lane raises nlo[r] to the complement of
// its edge and its last lane raises hi[r] to its edge + 1 (integer
// atomicMax), so ~nlo[r] ends as the first edge of r and hi[r] as its last
// edge + 1 over all windows of r's block; both stay 0x80808080 (negative)
// for a row no window holds, which then has ~nlo[r] > hi[r].
__global__ void __launch_bounds__(128)
segment_csr_span_kernel(const int* __restrict__ seg, const int* __restrict__ meta,
                        int* __restrict__ nlo, int* __restrict__ hi, int E, int N, int C, int BN,
                        int EB) {
  const int c = blockIdx.x;
  const int w0 = meta[c], base = meta[C + c] * BN;
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < EB; j0 += 128 * SPAN_BATCH) {
    int id[SPAN_BATCH];
#pragma unroll
    for (int k = 0; k < SPAN_BATCH; ++k) {
      const int j = j0 + 128 * k + threadIdx.x;
      const long long e = (long long)w0 + j;  // any window start in meta
      const int v = j < EB && e >= 0 && e < E ? __ldg(seg + e) : -1;
      id[k] = v >= base && v < base + BN && v < N ? v : -1;
    }
#pragma unroll
    for (int k = 0; k < SPAN_BATCH; ++k) {
      const int prev = __shfl_up_sync(0xffffffffu, id[k], 1);
      const int next = __shfl_down_sync(0xffffffffu, id[k], 1);
      if (id[k] < 0) continue;
      const int e = w0 + j0 + 128 * k + threadIdx.x;  // in [0, E): an id was read there
      if (lane == 0 || prev != id[k]) atomicMax(nlo + id[k], ~e);
      if (lane == 31 || next != id[k]) atomicMax(hi + id[k], e + 1);
    }
  }
}

// 4-wide loads need F % 4 == 0 and 4-value alignment of the rows (the
// output comes from torch.empty, which aligns to far more than 16 bytes)
template <typename T>
bool vec4_ok(const T* data, const float* out, int F) {
  return F % 4 == 0 && reinterpret_cast<uintptr_t>(data) % (4 * sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <typename T>
int launch_csr(const T* data, const int* seg, const int* rowptr, float* out,
               int E, int F, int N, cudaStream_t strm) {
  const int grid = (N + WARPS - 1) / WARPS;
  if (vec4_ok(data, out, F)) {
    segment_csr_kernel<T, 4, false><<<grid, WARPS * 32, 0, strm>>>(data, seg, rowptr, rowptr + 1,
                                                                   out, E, F, N);
  } else {
    segment_csr_kernel<T, 1, false><<<grid, WARPS * 32, 0, strm>>>(data, seg, rowptr, rowptr + 1,
                                                                   out, E, F, N);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_chunked(const T* data, const int* seg, const int* meta, int* span, float* out,
                   int E, int F, int N, int C, int BN, int EB, cudaStream_t strm) {
  int* nlo = span;
  int* hi = span + N;
  cudaError_t e = cudaMemsetAsync(span, 0x80, 2 * (size_t)N * sizeof(int), strm);
  if (e != cudaSuccess) return e;
  if (C > 0) {
    segment_csr_span_kernel<<<C, 128, 0, strm>>>(seg, meta, nlo, hi, E, N, C, BN, EB);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int grid = (N + WARPS - 1) / WARPS;
  if (vec4_ok(data, out, F)) {
    segment_csr_kernel<T, 4, true><<<grid, WARPS * 32, 0, strm>>>(data, seg, nlo, hi, out, E, F,
                                                                  N);
  } else {
    segment_csr_kernel<T, 1, true><<<grid, WARPS * 32, 0, strm>>>(data, seg, nlo, hi, out, E, F,
                                                                  N);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 0 on success, a cudaError_t, or ERR_SHAPE.
int segment_csr_fwd(const void* data, const int* seg, const int* rowptr, float* out, int E,
                    int F, int N, int bf16, void* stream) {
  if (E < 0 || F < 0 || N < 0) return ERR_SHAPE;
  if (N == 0 || F == 0) return 0;  // no output element to write
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_csr(static_cast<const __nv_bfloat16*>(data), seg, rowptr, out, E, F, N, s);
  }
  return launch_csr(static_cast<const float*>(data), seg, rowptr, out, E, F, N, s);
}

// The chunked sum: meta int32 [3, C] (window starts, row blocks, first-chunk
// flags, as plan_chunks lays them out; EB a multiple of 128); span int32
// [N, 2] scratch. Clears span, then launches the span pass and the row sums
// on the stream. 0 on success, a cudaError_t, or ERR_SHAPE.
int segment_csr_chunked_fwd(const void* data, const int* seg, const int* meta, int* span,
                            float* out, int E, int F, int N, int C, int BN, int EB, int bf16,
                            void* stream) {
  // EB bounded so that the span pass's window positions fit an int
  if (E < 0 || F < 0 || N < 0 || C < 0 || BN <= 0 || EB <= 0 || EB % 128 != 0 ||
      EB > 0x7fffffff - 128 * SPAN_BATCH)
    return ERR_SHAPE;
  if (N == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_chunked(static_cast<const __nv_bfloat16*>(data), seg, meta, span, out, E, F,
                          N, C, BN, EB, s);
  }
  return launch_chunked(static_cast<const float*>(data), seg, meta, span, out, E, F, N, C, BN,
                        EB, s);
}

}  // extern "C"
