// The compacted walk of the [N, K]-table kernels: the forwards
// triplet_pt_fwd_kernel and triplet_product_fwd_kernel, triplet_pt_bwd2_kernel,
// triplet_product_bwd_kernel and triplet_product_bwd2_kernel
// (triplet_pt_bwd_kernel writes the same out):
// a block deals itself the chunks of TC consecutive triplets b, b + G,
// b + 2G, ... (G = gridDim.x) and takes them a window of BW chunks at a
// time; the window's real triplets (m != 0) are listed in triplet order by
// warp ballots, and the masked ones' outputs written as zeros, so the
// kernels walk only real triplets and every sum over a block's triplets
// keeps the order of the masked walk over the same chunks.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

// Position x of the window starting at chunk w0 (x < W = BW TC) is triplet
// (w0 + G (x / TC)) TC + x % TC.
struct Window {
  int w0, G, TC, W, chunks;
  size_t Tn;

  __device__ __forceinline__ size_t chunk(int x) const {
    return (size_t)w0 + (size_t)G * (x / TC);
  }
  __device__ __forceinline__ size_t triplet(int x) const { return chunk(x) * TC + x % TC; }
  __device__ __forceinline__ bool valid(int x) const {
    return x < W && chunk(x) < (size_t)chunks && triplet(x) < Tn;
  }
};

// An element widened to float32 without a conversion instruction (a bf16
// value is the high half of its float32), so that the loads of a gather
// stay free of branches and all in flight together.
__device__ __forceinline__ float ldw(const float* p) { return *p; }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// Whether position x is a real triplet, from the window's ballots.
__device__ __forceinline__ bool listed(const unsigned* bits, int x) {
  return (bits[x >> 5] >> (x & 31)) & 1u;
}

// Lists the window's real triplets in triplet order into lst [W] and
// returns their count; bits [rounds * NW] receives one ballot a warp and
// round (bit x % 32 of word x / 32 is position x's) and wcnt the ballots'
// counts. masked(t) runs once for each masked triplet t of the window, by
// the thread that read its mask. Starts with a barrier (the previous
// window is done with the list) and passes one more before the list is
// written; the list is read after the caller's next barrier.
template <int NT, typename T, typename F>
__device__ int list_window(const Window& w, const T* m, int* lst, int* wcnt, unsigned* bits,
                           F masked) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int rounds = (w.W + NT - 1) / NT;
  __syncthreads();
  for (int j = 0; j < rounds; ++j) {
    const int x = j * NT + tid;
    const bool valid = w.valid(x);
    const size_t t = w.triplet(x);
    const bool real = valid && ld(m + t) != 0.f;
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) {
      wcnt[j * NW + warp] = __popc(mask);
      bits[j * NW + warp] = mask;
    }
    if (valid && !real) masked(t);
  }
  __syncthreads();
  int nl = 0;
  for (int j = 0; j < rounds; ++j) {
    int at = 0;
    for (int q = 0; q < rounds * NW; ++q) {
      if (q < j * NW + warp) at += wcnt[q];
      if (j == 0) nl += wcnt[q];
    }
    const unsigned mask = bits[j * NW + warp];
    if ((mask >> lane) & 1u)
      lst[at + __popc(mask & ((1u << lane) - 1u))] = (int)w.triplet(j * NT + tid);
  }
  return nl;
}

// Whether any of positions [x0, x0 + n) is a real triplet.
__device__ __forceinline__ bool any_listed(const unsigned* bits, int x0, int n) {
  for (int x = x0; x < x0 + n;) {
    const int b = x & 31, take = min(32 - b, x0 + n - x);
    const unsigned m = take == 32 ? ~0u : (1u << take) - 1u;
    if ((bits[x >> 5] >> b) & m) return true;
    x += take;
  }
  return false;
}

// Elements [a, b) of dst set to 0 by the block's threads, in 16-byte stores
// between the first and the last 16-byte boundary.
template <int NT, typename T>
__device__ void zero_span(T* dst, size_t a, size_t b) {
  constexpr int PER = 16 / sizeof(T);
  size_t h = a;
  while (h < b && reinterpret_cast<uintptr_t>(dst + h) % 16 != 0) ++h;
  const size_t units = (b - h) / PER, tail = h + units * PER;
  for (size_t x = threadIdx.x; x < units; x += NT)
    reinterpret_cast<uint4*>(dst + h)[x] = make_uint4(0u, 0u, 0u, 0u);
  for (size_t x = a + threadIdx.x; x < h; x += NT) st(dst + x, 0.f);
  for (size_t x = tail + threadIdx.x; x < b; x += NT) st(dst + x, 0.f);
}

// dst [Tn, width]: the rows of the window's masked triplets set to 0. Rows
// of a multiple of 16 bytes are zeroed alone, in 16-byte stores; other
// rows (a bf16 basis row of 18 or 54 values) are not 16-byte aligned, so
// each of the window's chunks is zeroed whole, its real rows too, and the
// caller writes those after its next barrier.
template <int NT, typename T>
__device__ void zero_masked_rows(const Window& w, const unsigned* bits, T* dst, int width) {
  if ((width * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const int per = (int)(width * sizeof(T) / 16);
    for (int x = threadIdx.x; x < w.W * per; x += NT) {
      const int pos = x / per;
      if (!w.valid(pos) || listed(bits, pos)) continue;
      reinterpret_cast<uint4*>(dst + w.triplet(pos) * width)[x % per] =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  for (int x = 0; x < w.W; x += w.TC) {
    const size_t ch = w.chunk(x);
    if (ch >= (size_t)w.chunks) break;
    const size_t t0 = ch * w.TC, t1 = t0 + w.TC < w.Tn ? t0 + w.TC : w.Tn;
    zero_span<NT>(dst, t0 * width, t1 * width);
  }
}

// acc[e][q] = fmaf chains over the basis rows r0 .. r1 - 1 of a forward
// batch's triplets i0 + e (bas by row, ld floats a row) against the
// weights w_s [NB][C+1] of channel lane + 32 q, from the values acc holds:
// each weight loaded once for the FE triplets, their basis values as
// broadcast scalar loads (on this card eight of them took less time than
// two broadcast float4 loads).
template <int FE, int Q>
__device__ __forceinline__ void row_tile(const float* bas, int ld, const float* w_s, int r0,
                                         int r1, int i0, int lane, int C, float (&acc)[FE][Q]) {
  for (int r = r0; r < r1; ++r) {
    float wv[Q], bv[FE];
#pragma unroll
    for (int q = 0; q < Q; ++q) wv[q] = lane + 32 * q < C ? w_s[r * (C + 1) + lane + 32 * q] : 0.f;
#pragma unroll
    for (int e = 0; e < FE; ++e) bv[e] = bas[r * ld + i0 + e];
#pragma unroll
    for (int e = 0; e < FE; ++e)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[e][q] = fmaf(bv[e], wv[q], acc[e][q]);
  }
}

// dst [E, width]: the rows of the window's edges (CE whole edges of K
// positions a chunk) without a real triplet set to 0, a warp an edge.
template <int NT, typename T>
__device__ void zero_empty_edges(const Window& w, const unsigned* bits, int CE, int K, int E,
                                 T* dst, int width) {
  const int lane = threadIdx.x & 31, BW = w.W / w.TC;
  for (int le = threadIdx.x >> 5; le < BW * CE; le += NT / 32) {
    const int j = le / CE, ce = le - j * CE;
    const size_t ch = (size_t)w.w0 + (size_t)w.G * j, e = ch * CE + ce;
    if (ch >= (size_t)w.chunks || e >= (size_t)E || any_listed(bits, j * w.TC + ce * K, K))
      continue;
    for (int c = lane; c < width; c += 32) st(dst + e * width + c, 0.f);
  }
}

// The runs of equal edges among a batch's cnt listed triplets (eds[i] the
// edge of triplet i; the list is in triplet order, so an edge's triplets
// are contiguous): rs[q] the first position of run q, rs[nr] = cnt, *nrs =
// nr. Run by one warp.
__device__ __forceinline__ void list_runs(const int* eds, int cnt, int* rs, int* nrs) {
  const int lane = threadIdx.x & 31;
  int nr = 0;
  for (int i0 = 0; i0 < cnt; i0 += 32) {
    const int i = i0 + lane;
    const bool first = i < cnt && (i == 0 || eds[i] != eds[i - 1]);
    const unsigned b = __ballot_sync(0xffffffffu, first);
    if (first) rs[nr + __popc(b & ((1u << lane) - 1u))] = i;
    nr += __popc(b);
  }
  if (lane == 0) {
    rs[nr] = cnt;
    *nrs = nr;
  }
}

// The per-edge sums of a batch, a warp a run, lanes over the C channels (Q
// a lane): acc = fmaf(pv[i][c], ms[i], acc) over the run's triplets in
// list order, from 0, out[e][c] = acc. The edge pe whose sum the previous
// batch left in cin continues there when the first run is pe's; else cin
// is pe's whole sum and written out (pe < 0: none). Unless `last` (the
// window's last batch, which ends its edges), the last run's sum goes to
// cout for the next batch.
template <int NT, int Q, typename T>
__device__ void add_edge_runs(const float* pv, const float* ms, const int* eds, const int* rs,
                              int nr, int pe, const float* cin, float* cout, bool last, T* out,
                              int C) {
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < nr; q += NT / 32) {
    const int i1 = rs[q + 1], e = eds[rs[q]];
    const bool cont = q == 0 && e == pe, flush = q == 0 && e != pe && pe >= 0;
    float acc[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int c = lane + 32 * u;
      acc[u] = cont && c < C ? cin[c] : 0.f;
      if (flush && c < C) st(out + (size_t)pe * C + c, cin[c]);
    }
    for (int i = rs[q]; i < i1; ++i) {
      const float m = ms[i];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        const int c = lane + 32 * u;
        if (c < C) acc[u] = fmaf(pv[i * C + c], m, acc[u]);
      }
    }
    const bool carry = q == nr - 1 && !last;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int c = lane + 32 * u;
      if (c >= C) continue;
      if (carry) cout[c] = acc[u];
      else st(out + (size_t)e * C + c, acc[u]);
    }
  }
}

}  // namespace
