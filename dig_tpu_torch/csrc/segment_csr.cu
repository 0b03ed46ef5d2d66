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
//    loads in flight on short rows.
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
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;   // rows per block of 256 threads
constexpr int UNROLL = 4;  // edges whose loads are in flight at once

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
  for (int c0 = lane * VEC; c0 < F; c0 += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int e = lo;
    for (; e + UNROLL <= hi; e += UNROLL) {
      float v[UNROLL][VEC];
      bool take[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        take[u] = __ldg(seg + e + u) == r;
        if (take[u]) load<VEC>(data + (size_t)(e + u) * F + c0, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (take[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
        }
      }
    }
    for (; e < hi; ++e) {
      if (__ldg(seg + e) == r) {
        float v[VEC];
        load<VEC>(data + (size_t)e * F + c0, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += v[i];
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

}  // extern "C"
