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
// The chunked sum, segment_csr_chunked_kernel, replaces _ssc_fwd
// (pl.pallas_call at :325, _chunk_kernel at :195), the kernel of
// segment_sum_sorted_csr_chunked:
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
//    run in parallel and in no order, so one CUDA block takes a whole row
//    block: the block of its first chunk walks the block's chunks in order,
//    the blocks of the other chunks exit at once.
//  - It reads the ids of its windows once to find, per row, the first and
//    last edge that carries the row's id (no atomics: each warp owns its
//    rows), then sums each row in edge order as the segment sum does, and
//    writes each of its rows once, zeros for an empty one, nothing past N.
//  - Windows may run past the last edge by up to 2 EB (JAX pads data by 2 EB
//    for its DMA); here a bounds check takes the padding's place, and ids
//    outside the row block or -1 add nothing. No atomics: the same bits on
//    every call.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;         // rows per block of 256 threads
constexpr int UNROLL = 4;        // edges whose loads are in flight at once
constexpr int CHUNK_UNROLL = 8;  // the same in the chunked sum, whose warps
                                 // sum many rows one after the other

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

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
segment_csr_kernel(const T* __restrict__ data, const int* __restrict__ seg,
                   const int* __restrict__ rowptr, float* __restrict__ out,
                   int E, int F, int N) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= N) return;
  const int lo = max(rowptr[r], 0);
  const int hi = min(rowptr[r + 1], E);
  row_sum<T, VEC, UNROLL>(data, seg, out, r, lo, hi, F, lane);
}

// The chunked sum: block c works only if chunk c is the first of its row
// block (meta[2][c] == 1). It walks that block's chunks (consecutive in
// meta, windows tiling [meta[0][c], meta[0][last] + EB), clipped to E) twice.
// First each of its W warps, for the rows it owns (local row % W == warp),
// notes the first and the last window edge that carries the row's id,
// reading 128 ids per step; warps own disjoint rows and scan in edge order,
// so no two threads write one entry. Then each warp sums each of its rows
// over [first, last] in edge order (row_sum, CHUNK_UNROLL edges in flight)
// and writes it once, zeros for a row with no edge; rows at or past N are
// not written.
template <typename T, int VEC, int W>
__global__ void __launch_bounds__(W * 32)
segment_csr_chunked_kernel(const T* __restrict__ data, const int* __restrict__ seg,
                           const int* __restrict__ meta, float* __restrict__ out, int E,
                           int F, int N, int C, int BN, int EB) {
  extern __shared__ int span[];  // first [BN], last [BN]
  const int c0 = blockIdx.x;
  if (meta[2 * C + c0] != 1) return;
  const int b = meta[C + c0];
  int c1 = c0 + 1;
  while (c1 < C && meta[2 * C + c1] == 0 && meta[C + c1] == b) ++c1;
  const int lo = max(meta[c0], 0);
  const int hi = min(meta[c1 - 1] + EB, E);
  const int base = b * BN;
  int* first = span;
  int* last = span + BN;
  for (int i = threadIdx.x; i < BN; i += W * 32) {
    first[i] = -1;
    last[i] = -1;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e0 = lo; e0 < hi; e0 += 128) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + 32 * j + lane;
      v[j] = e < hi ? __ldg(seg + e) - base : -1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned mine = __ballot_sync(0xffffffffu, v[j] >= 0 && v[j] < BN && v[j] % W == warp);
      while (mine != 0u) {
        const int l = __ffs(mine) - 1;
        mine &= mine - 1u;
        const int vl = __shfl_sync(0xffffffffu, v[j], l);
        if (lane == 0) {
          if (first[vl] < 0) first[vl] = e0 + 32 * j + l;
          last[vl] = e0 + 32 * j + l;
        }
      }
    }
  }
  __syncwarp();
  for (int v = warp; v < BN && base + v < N; v += W) {
    const int f = first[v];
    row_sum<T, VEC, CHUNK_UNROLL>(data, seg, out, base + v, f < 0 ? 0 : f,
                                  f < 0 ? 0 : last[v] + 1, F, lane);
  }
}

template <typename T>
int launch_csr(const T* data, const int* seg, const int* rowptr, float* out,
               int E, int F, int N, cudaStream_t strm) {
  const int grid = (N + WARPS - 1) / WARPS;
  // 4-wide loads need F % 4 == 0 and 4-value alignment of the rows (the
  // output comes from torch.empty, which aligns to far more than 16 bytes)
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(data) % (4 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    segment_csr_kernel<T, 4><<<grid, WARPS * 32, 0, strm>>>(data, seg, rowptr, out, E, F, N);
  } else {
    segment_csr_kernel<T, 1><<<grid, WARPS * 32, 0, strm>>>(data, seg, rowptr, out, E, F, N);
  }
  return cudaGetLastError();
}

template <typename T, int VEC, int W>
int launch_chunked_w(const T* data, const int* seg, const int* meta, float* out, int E, int F,
                     int N, int C, int BN, int EB, size_t smem, cudaStream_t strm) {
  auto kernel = segment_csr_chunked_kernel<T, VEC, W>;
  int rc = check_smem(smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<C, W * 32, smem, strm>>>(data, seg, meta, out, E, F, N, C, BN, EB);
  return cudaGetLastError();
}

// A row block is one CUDA block, so the warps of a block set how many rows
// are summed at once: 32 warps when the row blocks are no more than the
// SMs, else 16 (two blocks of 512 threads fit an SM, and a third of
// 1024 would not).
template <typename T, int VEC>
int launch_chunked_v(const T* data, const int* seg, const int* meta, float* out, int E, int F,
                     int N, int C, int BN, int EB, size_t smem, cudaStream_t strm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if ((N + BN - 1) / BN <= sms) {
    return launch_chunked_w<T, VEC, 32>(data, seg, meta, out, E, F, N, C, BN, EB, smem, strm);
  }
  return launch_chunked_w<T, VEC, 16>(data, seg, meta, out, E, F, N, C, BN, EB, smem, strm);
}

template <typename T>
int launch_chunked(const T* data, const int* seg, const int* meta, float* out, int E, int F,
                   int N, int C, int BN, int EB, cudaStream_t strm) {
  const size_t smem = 2 * (size_t)BN * sizeof(int);
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(data) % (4 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) return launch_chunked_v<T, 4>(data, seg, meta, out, E, F, N, C, BN, EB, smem, strm);
  return launch_chunked_v<T, 1>(data, seg, meta, out, E, F, N, C, BN, EB, smem, strm);
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
// flags, as plan_chunks lays them out). 0 on success, a cudaError_t, or
// ERR_SHAPE / ERR_SMEM.
int segment_csr_chunked_fwd(const void* data, const int* seg, const int* meta, float* out,
                            int E, int F, int N, int C, int BN, int EB, int bf16,
                            void* stream) {
  if (E < 0 || F < 0 || N < 0 || C < 0 || BN <= 0 || EB <= 0) return ERR_SHAPE;
  if (N == 0 || F == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_chunked(static_cast<const __nv_bfloat16*>(data), seg, meta, out, E, F, N, C,
                          BN, EB, s);
  }
  return launch_chunked(static_cast<const float*>(data), seg, meta, out, E, F, N, C, BN, EB, s);
}

}  // extern "C"
