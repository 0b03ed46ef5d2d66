// Helpers shared by the package's CUDA sources: element loads and stores
// in float32 or bf16, rounding to bf16, the fixed-order sum of per-block
// partials, the checked launch and the occupancy-sized grid. Each source
// is its own shared library, so everything here lives in an unnamed
// namespace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int ERR_SHAPE = -2;  // a width outside the compiled set
constexpr int ERR_SMEM = -3;   // shared memory exceeded

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v rounded to bf16 (when BF16) and back to float32.
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// out[i] = sum over blocks of part[b][i], in a fixed tree order: threads
// (x, y) sum the rows b = y, y + 8, ... of column i, then y = 0 adds the 8.
// No atomics, so the same partials give the same bits on every run.
__global__ void sum_partials_kernel(const float* part, int blocks, int size, float* out) {
  __shared__ float red[8][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < size) {
    for (int b = threadIdx.y; b < blocks; b += 8) s += part[(size_t)b * size + i];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < size) {
    float t = 0.f;
    for (int y = 0; y < 8; ++y) t += red[y][threadIdx.x];
    out[i] = t;
  }
}

int sum_partials(const float* part, int blocks, int size, float* out, cudaStream_t strm) {
  sum_partials_kernel<<<(size + 31) / 32, dim3(32, 8), 0, strm>>>(part, blocks, size, out);
  return cudaGetLastError();
}

int check_smem(size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  return bytes > (size_t)optin ? ERR_SMEM : 0;
}

// Launch kernel<<<grid, threads, smem, strm>>>(p) after raising its dynamic
// shared-memory limit; 0, a cudaError_t or ERR_SMEM.
template <typename Kern, typename P>
int launch(Kern kernel, int grid, int threads, size_t smem, cudaStream_t strm, const P& p) {
  int rc = check_smem(smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, strm>>>(p);
  return cudaGetLastError();
}

// The grid of a kernel whose blocks deal themselves the work (b, b + G,
// ...): as many blocks as the card holds at once (SMs x the kernel's
// occupancy at smem bytes of dynamic shared memory), at most `chunks`, the
// units of work; it depends only on the shapes and the card. Raises the
// kernel's shared-memory limit to smem. 0, a cudaError_t or ERR_SMEM.
template <typename Kern>
int occupancy_grid(Kern kern, int threads, size_t smem, int chunks, int* blocks) {
  int rc = check_smem(smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return e;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = chunks < cap ? chunks : cap;
  return 0;
}

}  // namespace
