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
// decides it, so an edge with id -1 never counts. As the op's contract
// states, the counted ids ascend and rowptr is non-decreasing (a row
// pointer): then no two rows' counted edges interleave.
//
// What bounds it on this card: a pure streaming reduction, one add per
// element read. The least traffic is each counted edge row, its id and the
// row pointers read once and the output written once,
//   E F sizeof(data) + 4 E + 4 (N + 1) + 4 N F bytes,
// so at 3.35 TB/s it is bound by bytes, never by operations.
//
// What the main paths give it: sums whose rows are short and even (the
// flat edge->node sums, at most 29 edges a row), and sums where one row
// holds most of the edges (a row gather's adjoint: the flat edge list pads
// with node 0, so row 0 of the senders' adjoint holds 9,258 of 16,384
// edges), at F = 128, 3 and 1 (the per-graph readouts).
//
// What the design does about it:
//  - The work is balanced by edges: the edge range is cut into fixed slices
//    of L = slice_edges(F) edges (128, and 128 x floor(8 / F) below F = 8:
//    1,024 at F = 1), which depend on E and F alone, never on the data or
//    the card.
//  - A row of at most L edges (its row-pointer range) is summed whole by
//    one warp of segment_csr_row_kernel, from +0 in edge order: the bits of
//    the first design (a warp a row) for every such row.
//  - A longer row is summed piece by piece: segment_csr_piece_kernel finds,
//    for each slice, its first and last counted edges; the long row cut at
//    the slice's start (its head piece) and the one cut at its end (its
//    tail piece) are summed over their edges in the slice by a block of 4
//    warps, each its L / 4 edges in edge order, the 4 warp sums added in
//    warp order. The row pass then adds a long row's pieces in slice order.
//    Each row's sum has one fixed order, so two runs give the same bits; a
//    long row's bits differ from the first design's.
//  - The piece pass takes a block a slice while the card holds them all;
//    beyond (path 7b's 7,500 slices), a thread first checks a slice by its
//    two end edges and the block scans only the slices where a long row may
//    reach in or out.
//  - Loads are unchained: the ids and the data rows of a batch of edges are
//    loaded at once (the address clamped into the range, the value selected
//    afterwards), 16 edges in flight a lane when the lanes cover an edge's F
//    values (16 bytes each: a float4 in f32, 4 bf16 in bf16), 4 rounds of
//    32 / C edges when an edge has C < 32 such chunks (F = 1, 3, 24):
//    lanes then cover edges x chunks, and the lanes of the first edge take
//    the others' values by shuffles, all at once, and add them in edge
//    order, so the bits stay those of one lane walking the edges. The
//    narrow and the wide walk are kernel instances of their own, so that
//    neither's registers bound the other's. A warp barrier between a batch
//    of pieces' loads and their adds keeps the compiler from issuing each
//    load just before its add (without it a long row's sum of pieces took
//    about half as long again); in the row walk the same barrier cost the
//    short rows more than it gave the long ones (scripts/phase_variants.py
//    segcsr_fence).
//  - The row pass needs the pieces only for long rows, so it is launched as
//    a programmatic dependent of the piece pass (sm_90): the card may start
//    it once every piece block has started, and only a long row's warp
//    waits for the piece pass (griddepcontrol.wait) before reading pieces.
//    That hides most of the second launch of a call
//    (scripts/phase_variants.py segcsr_no_pdl launches it plainly).
//  - No atomics on floats, no host work: the wrapper gives the scratch for
//    the pieces ([S, 2, F] floats and [S, 2] row ids, S = ceil(E / L)), and
//    the piece pass is launched only when E > L (a long row needs more).
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
//  - Then the segment sum's own two passes over [~span[0][r], span[1][r])
//    in place of [rowptr[r], rowptr[r+1]), the seg == r filter kept: the
//    same rows long and short and the same pieces, so the same bits as the
//    segment sum; a row no window holds has an empty range and is written
//    as zeros; rows at or past N are never written. No float atomics.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int SLICE = 128;      // edges a slice at F >= 8; a longer row is summed in pieces
constexpr int PIECE_WARPS = 4;  // warps a piece-pass block
constexpr int ROW_WARPS = 4;    // rows a row-pass block
constexpr int U_WIDE = 16;      // edges in flight a lane, lanes over an edge's chunks
constexpr int U_NARROW = 4;     // rounds of 32 / C edges in flight, lanes over edges
constexpr unsigned FULL = 0xffffffffu;

// Edges a slice at width F: SLICE, and more below F = 8, where a warp's
// round of loads covers more edges (the lanes over edges x values).
__host__ __device__ constexpr int slice_edges(int F) { return SLICE * (F < 8 ? 8 / F : 1); }

// The piece pass lets the row pass start; the row pass waits for it to end
// (and its writes to show) before reading a piece.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// VEC consecutive values at p, as float32 (bf16 widened by a shift: exact,
// and free of the conversion intrinsic's branches).
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
    v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v[i] = __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p + i)) << 16);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// A lane's place in a warp that sums edge rows of C chunks of VEC values.
// C >= 32: the lanes cover chunks (tile t: chunk 32 t + lane), P = 1 edge at
// a time. C < 32: one tile, lane = j C + c covers chunk c of the j-th of
// P = 32 / C edges (lanes with j >= P idle); the lanes with j == 0 hold the
// sum.
struct Lanes {
  int C, P, j, c;
  __device__ Lanes(int chunks, int lane)
      : C(chunks), P(chunks >= 32 ? 1 : 32 / chunks), j(chunks >= 32 ? 0 : lane / chunks),
        c(chunks >= 32 ? lane : lane % chunks) {}
  __device__ int tiles() const { return (C + 31) / 32; }
  __device__ int chunk(int t) const { return P == 1 ? 32 * t + c : c; }
  // whether this lane holds the sum of chunk(t)
  __device__ bool holds(int t) const { return j == 0 && chunk(t) < C; }
};

// acc = the sum of chunk ln.chunk(t) of data[e, :] over the e in [a, b) with
// seg[e] == r, from +0 in edge order, float32 (one warp; an empty range gives
// zeros). Every lane loads its edges' ids and rows at once, at addresses
// clamped into [a, b), and selects afterwards: an edge that does not count
// adds +0, which leaves the sum's bits as skipping it would (a sum begun at
// +0 in round-to-nearest is never -0).
template <typename T, int VEC, bool NARROW>
__device__ __forceinline__ void tile_sum(const T* __restrict__ data, const int* __restrict__ seg,
                                         int r, int a, int b, int F, const Lanes& ln, int t,
                                         float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  const int ch = ln.chunk(t) < ln.C ? ln.chunk(t) : 0;
  if constexpr (!NARROW) {
    for (int e0 = a; e0 < b; e0 += U_WIDE) {
      float v[U_WIDE][VEC];
      int id[U_WIDE];
#pragma unroll
      for (int u = 0; u < U_WIDE; ++u) {
        const int e = min(e0 + u, b - 1);
        id[u] = __ldg(seg + e);
        load<VEC>(data + (size_t)e * F + ch * VEC, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U_WIDE; ++u) {
        const bool take = (e0 + u < b) & (id[u] == r);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += take ? v[u][i] : 0.f;
      }
    }
  } else {
    const int step = U_NARROW * ln.P;
    for (int e0 = a; e0 < b; e0 += step) {
      float v[U_NARROW][VEC];
#pragma unroll
      for (int u = 0; u < U_NARROW; ++u) {
        const int e = e0 + u * ln.P + ln.j;
        const int ec = min(e, b - 1);
        const int id = __ldg(seg + ec);
        load<VEC>(data + (size_t)ec * F + ch * VEC, v[u]);
        const bool take = (e < b) & (id == r);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[u][i] = take ? v[u][i] : 0.f;  // +0 adds nothing
      }
      const int n = min(step, b - e0);
#pragma unroll
      for (int u = 0; u < U_NARROW; ++u) {
        const int m = min(ln.P, n - u * ln.P);   // uniform over the warp
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // the round's values of chunk c, shuffled at once, added in edge order
          float w[32];
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            w[jj] = __shfl_sync(FULL, v[u][i], (jj * ln.C + ln.c) & 31);
          }
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            if (jj < m) acc[i] += w[jj];
          }
        }
      }
    }
  }
}

// lo[r], or ~lo[r] for the chunked sum's span
template <bool NOT_LO>
__device__ __forceinline__ int row_lo(const int* lo, int r) {
  return NOT_LO ? ~__ldg(lo + r) : __ldg(lo + r);
}

// Whether edge e counts, and for which row (*r): 0 <= seg[e] < N and
// lo[r] <= e < hi[r].
template <bool NOT_LO>
__device__ __forceinline__ bool counted(const int* seg, const int* lo, const int* hi, int N,
                                        int e, int* r) {
  *r = __ldg(seg + e);
  const int rc = min(max(*r, 0), N - 1);   // loaded unconditionally, selected after
  const int l = row_lo<NOT_LO>(lo, rc), h = __ldg(hi + rc);
  return (*r >= 0) & (*r < N) & (l <= e) & (e < h);
}

// The pieces of slice s = [e0, e1), L = slice_edges(F) edges (one block).
// The slice's first counted edge's row r_f is the only row of more than L
// edges that can reach into it from an earlier slice; when it does, its
// edges here are the head piece, piece[s][0], and piece_row[s][0] = r_f.
// Likewise the last counted edge's row, when long and reaching past the
// slice (and not r_f's head), gives the tail piece, piece[s][1]. A piece is
// its warps' sums (L / 4 edges each, in edge order) added in warp order;
// piece_row is -1 where there is none.
template <typename T, int VEC, bool NOT_LO, bool NARROW>
__device__ void slice_pieces(const T* __restrict__ data, const int* __restrict__ seg,
                             const int* __restrict__ lo, const int* __restrict__ hi,
                             float* __restrict__ piece, int* __restrict__ piece_row, int E, int F,
                             int N, int s) {
  __shared__ int first_w[PIECE_WARPS], last_w[PIECE_WARPS];
  __shared__ float part[2][PIECE_WARPS][32 * VEC];
  const int L = slice_edges(F);
  const int e0 = s * L, e1 = min(e0 + L, E);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ef = INT_MAX, el = -1;   // this thread's first and last counted edges
  for (int e = e0 + threadIdx.x; e < e1; e += PIECE_WARPS * 32) {
    int r;
    if (counted<NOT_LO>(seg, lo, hi, N, e, &r)) {
      ef = min(ef, e);
      el = e;
    }
  }
  ef = __reduce_min_sync(FULL, ef);
  el = __reduce_max_sync(FULL, el);
  if (lane == 0) {
    first_w[warp] = ef;
    last_w[warp] = el;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < PIECE_WARPS; ++w) {
    ef = min(ef, first_w[w]);
    el = max(el, last_w[w]);
  }
  bool head = false, tail = false;
  int rf = -1, rl = -1, hb = 0, ta = 0;
  if (el >= 0) {
    rf = __ldg(seg + ef);
    rl = __ldg(seg + el);
    const int af = max(row_lo<NOT_LO>(lo, rf), 0), bf = min(__ldg(hi + rf), E);
    const int al = max(row_lo<NOT_LO>(lo, rl), 0), bl = min(__ldg(hi + rl), E);
    head = bf - af > L && af < e0;
    tail = bl - al > L && bl > e1 && !(head && rl == rf);
    hb = min(bf, e1);
    ta = max(al, e0);
  }
  if (threadIdx.x == 0) {
    piece_row[2 * s] = head ? rf : -1;
    piece_row[2 * s + 1] = tail ? rl : -1;
  }
  if (head || tail) {
    const int wa = e0 + warp * (L / PIECE_WARPS), wb = min(wa + L / PIECE_WARPS, e1);
    const Lanes ln(F / VEC, lane);
    for (int t = 0; t < ln.tiles(); ++t) {
      const int off = ln.P == 1 ? 32 * t : 0;   // the tile's first chunk
      const int nf = min(32 * VEC, F - off * VEC);
      float acc[VEC];
      if (head) {
        tile_sum<T, VEC, NARROW>(data, seg, rf, max(e0, wa), min(hb, wb), F, ln, t, acc);
        if (ln.holds(t)) store<VEC>(&part[0][warp][(ln.chunk(t) - off) * VEC], acc);
      }
      if (tail) {
        tile_sum<T, VEC, NARROW>(data, seg, rl, max(ta, wa), min(e1, wb), F, ln, t, acc);
        if (ln.holds(t)) store<VEC>(&part[1][warp][(ln.chunk(t) - off) * VEC], acc);
      }
      __syncthreads();
      for (int x = threadIdx.x; x < 2 * nf; x += PIECE_WARPS * 32) {
        const int k = x / nf, f = x % nf;
        if (k ? tail : head) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < PIECE_WARPS; ++w) sum += part[k][w][f];
          piece[(size_t)(2 * s + k) * F + off * VEC + f] = sum;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();   // first_w / last_w are read again for the next slice
}

// The piece pass over the S slices, G = gridDim.x blocks (the card's
// resident blocks at most). With a block a slice (S <= G), the block scans
// it at once (slice_pieces). Otherwise block b takes the slices b, b + G,
// ..., 128 of them at a time: a thread first checks one slice by its two
// end edges; when both count, their rows are the slice's first and last,
// and a slice with no long row reaching in or out gets its piece_row (-1,
// -1) at once. The block then scans the others one at a time, in the order
// they were listed, which sets no bits: each piece is its slice's alone.
template <typename T, int VEC, bool NOT_LO, bool NARROW>
__global__ void __launch_bounds__(PIECE_WARPS * 32)
segment_csr_piece_kernel(const T* __restrict__ data, const int* __restrict__ seg,
                         const int* __restrict__ lo, const int* __restrict__ hi,
                         float* __restrict__ piece, int* __restrict__ piece_row, int E, int F,
                         int N, int S) {
  launch_dependents();
  constexpr int NT = PIECE_WARPS * 32;
  __shared__ int todo[NT];
  __shared__ int ntodo;
  const int G = gridDim.x, L = slice_edges(F);
  if (S <= G) {
    slice_pieces<T, VEC, NOT_LO, NARROW>(data, seg, lo, hi, piece, piece_row, E, F, N,
                                         blockIdx.x);
    return;
  }
  for (int k0 = blockIdx.x; k0 < S; k0 += G * NT) {
    if (threadIdx.x == 0) ntodo = 0;
    __syncthreads();
    const int s = k0 + threadIdx.x * G;
    if (s < S) {
      const int e0 = s * L, e1 = min(e0 + L, E);
      int rf, rl;
      bool work = true;
      if (counted<NOT_LO>(seg, lo, hi, N, e0, &rf) &&
          counted<NOT_LO>(seg, lo, hi, N, e1 - 1, &rl)) {
        const int af = max(row_lo<NOT_LO>(lo, rf), 0), bf = min(__ldg(hi + rf), E);
        const int al = max(row_lo<NOT_LO>(lo, rl), 0), bl = min(__ldg(hi + rl), E);
        work = (bf - af > L && af < e0) || (bl - al > L && bl > e1);
      }
      if (work) {
        todo[atomicAdd(&ntodo, 1)] = s;
      } else {
        piece_row[2 * s] = -1;
        piece_row[2 * s + 1] = -1;
      }
    }
    __syncthreads();
    const int n = ntodo;
    for (int i = 0; i < n; ++i) {
      slice_pieces<T, VEC, NOT_LO, NARROW>(data, seg, lo, hi, piece, piece_row, E, F, N, todo[i]);
    }
    __syncthreads();   // todo and ntodo are written again for the next batch
  }
}

// The row pass: a warp a row r < N over its range [max(lo[r], 0), min(hi[r],
// E)) (lo[r] read as ~lo[r] when NOT_LO): a row of at most L edges is
// summed whole, in edge order; a longer row adds its pieces in slice order:
// the tail piece of the slice holding its first edge, then the head pieces of
// the slices after it up to the one holding its last edge (a piece whose
// piece_row is not r holds none of its counted edges and adds nothing). An
// empty range is written as zeros.
template <typename T, int VEC, bool NOT_LO, bool NARROW>
__global__ void __launch_bounds__(ROW_WARPS * 32)
segment_csr_row_kernel(const T* __restrict__ data, const int* __restrict__ seg,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const float* __restrict__ piece, const int* __restrict__ piece_row,
                       float* __restrict__ out, int E, int F, int N) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= N) return;
  const int a = max(row_lo<NOT_LO>(lo, r), 0), b = min(__ldg(hi + r), E);
  float* o = out + (size_t)r * F;
  const int L = slice_edges(F);
  if (b > a && b - a > L) {
    wait_for_primary();
    const int s0 = a / L, s1 = (b - 1) / L;
    constexpr int UP = 16;  // pieces in flight a lane
    for (int c = lane; c < F / VEC; c += 32) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for (int s = s0; s <= s1; s += UP) {
        float v[UP][VEC];
        bool take[UP];
#pragma unroll
        for (int u = 0; u < UP; ++u) {
          const int sl = min(s + u, s1);
          const int at = 2 * sl + (sl == s0);   // the tail piece of s0, else the head
          const int pr = __ldg(piece_row + at);
          load<VEC>(piece + (size_t)at * F + c * VEC, v[u]);
          take[u] = (s + u <= s1) & (pr == r);
        }
        __syncwarp();   // all the batch's loads before the first add
#pragma unroll
        for (int u = 0; u < UP; ++u) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += take[u] ? v[u][i] : 0.f;
        }
      }
      store<VEC>(o + c * VEC, acc);
    }
    return;
  }
  const Lanes ln(F / VEC, lane);
  for (int t = 0; t < ln.tiles(); ++t) {
    float acc[VEC];
    tile_sum<T, VEC, NARROW>(data, seg, r, a, b, F, ln, t, acc);
    if (ln.holds(t)) store<VEC>(o + ln.chunk(t) * VEC, acc);
  }
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
      const int prev = __shfl_up_sync(FULL, id[k], 1);
      const int next = __shfl_down_sync(FULL, id[k], 1);
      if (id[k] < 0) continue;
      const int e = w0 + j0 + 128 * k + threadIdx.x;  // in [0, E): an id was read there
      if (lane == 0 || prev != id[k]) atomicMax(nlo + id[k], ~e);
      if (lane == 31 || next != id[k]) atomicMax(hi + id[k], e + 1);
    }
  }
}

// 4-wide loads need F % 4 == 0 and 4-value alignment of the rows (the
// output and the pieces come from torch.empty, which aligns to far more
// than 16 bytes)
template <typename T>
bool vec4_ok(const T* data, const float* out, int F) {
  return F % 4 == 0 && reinterpret_cast<uintptr_t>(data) % (4 * sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The two passes over the ranges [lo, hi) (lo complemented when NOT_LO): the
// piece pass when E > L, then the row pass, its programmatic dependent.
// NARROW: an edge's F values are fewer than 32 chunks of VEC (the narrow
// walk's registers stay out of the wide one's kernels).
template <typename T, int VEC, bool NOT_LO, bool NARROW>
int launch_passes(const T* data, const int* seg, const int* lo, const int* hi, float* piece,
                  int* piece_row, float* out, int E, int F, int N, cudaStream_t strm) {
  const int L = slice_edges(F);
  const bool pieces = E > L;
  if (pieces) {
    const int S = (E + L - 1) / L;
    const auto piece_kernel = segment_csr_piece_kernel<T, VEC, NOT_LO, NARROW>;
    int grid = 0;
    const int rc = occupancy_grid(piece_kernel, PIECE_WARPS * 32, 0, S, &grid);
    if (rc != 0) return rc;
    piece_kernel<<<grid, PIECE_WARPS * 32, 0, strm>>>(data, seg, lo, hi, piece, piece_row, E, F,
                                                      N, S);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + ROW_WARPS - 1) / ROW_WARPS);
  cfg.blockDim = dim3(ROW_WARPS * 32);
  cfg.stream = strm;
  cfg.attrs = attr;
  cfg.numAttrs = pieces ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, segment_csr_row_kernel<T, VEC, NOT_LO, NARROW>,
                                           data, seg, lo, hi, (const float*)piece,
                                           (const int*)piece_row, out, E, F, N);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, bool NOT_LO>
int launch_sum(const T* data, const int* seg, const int* lo, const int* hi, float* piece,
               int* piece_row, float* out, int E, int F, int N, cudaStream_t strm) {
  if (vec4_ok(data, out, F)) {
    return F / 4 < 32 ? launch_passes<T, 4, NOT_LO, true>(data, seg, lo, hi, piece, piece_row,
                                                           out, E, F, N, strm)
                      : launch_passes<T, 4, NOT_LO, false>(data, seg, lo, hi, piece, piece_row,
                                                            out, E, F, N, strm);
  }
  return F < 32 ? launch_passes<T, 1, NOT_LO, true>(data, seg, lo, hi, piece, piece_row, out, E,
                                                    F, N, strm)
                : launch_passes<T, 1, NOT_LO, false>(data, seg, lo, hi, piece, piece_row, out, E,
                                                     F, N, strm);
}

template <typename T>
int launch_chunked(const T* data, const int* seg, const int* meta, int* span, float* piece,
                   int* piece_row, float* out, int E, int F, int N, int C, int BN, int EB,
                   cudaStream_t strm) {
  int* nlo = span;
  int* hi = span + N;
  cudaError_t e = cudaMemsetAsync(span, 0x80, 2 * (size_t)N * sizeof(int), strm);
  if (e != cudaSuccess) return e;
  if (C > 0) {
    segment_csr_span_kernel<<<C, 128, 0, strm>>>(seg, meta, nlo, hi, E, N, C, BN, EB);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_sum<T, true>(data, seg, nlo, hi, piece, piece_row, out, E, F, N, strm);
}

}  // namespace

extern "C" {

// Edges a slice at width F, L: the wrapper's scratch for E > L is piece
// float32 [ceil(E / L), 2, F] and piece_row int32 [ceil(E / L), 2].
int segment_csr_slice_edges(int F) { return F > 0 ? slice_edges(F) : 0; }

// 0 on success, a cudaError_t, or ERR_SHAPE.
int segment_csr_fwd(const void* data, const int* seg, const int* rowptr, float* piece,
                    int* piece_row, float* out, int E, int F, int N, int bf16, void* stream) {
  if (E < 0 || F < 0 || N < 0) return ERR_SHAPE;
  if (N == 0 || F == 0) return 0;  // no output element to write
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_sum<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(data), seg, rowptr,
                                            rowptr + 1, piece, piece_row, out, E, F, N, s);
  }
  return launch_sum<float, false>(static_cast<const float*>(data), seg, rowptr, rowptr + 1, piece,
                                  piece_row, out, E, F, N, s);
}

// The chunked sum: meta int32 [3, C] (window starts, row blocks, first-chunk
// flags, as plan_chunks lays them out; EB a multiple of 128); span int32
// [2, N] scratch and the pieces' scratch as for segment_csr_fwd. Clears span,
// then launches the span pass and the two passes of the sum on the stream. 0
// on success, a cudaError_t, or ERR_SHAPE.
int segment_csr_chunked_fwd(const void* data, const int* seg, const int* meta, int* span,
                            float* piece, int* piece_row, float* out, int E, int F, int N, int C,
                            int BN, int EB, int bf16, void* stream) {
  // EB bounded so that the span pass's window positions fit an int
  if (E < 0 || F < 0 || N < 0 || C < 0 || BN <= 0 || EB <= 0 || EB % 128 != 0 ||
      EB > 0x7fffffff - 128 * SPAN_BATCH)
    return ERR_SHAPE;
  if (N == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_chunked(static_cast<const __nv_bfloat16*>(data), seg, meta, span, piece,
                          piece_row, out, E, F, N, C, BN, EB, s);
  }
  return launch_chunked(static_cast<const float*>(data), seg, meta, span, piece, piece_row, out,
                        E, F, N, C, BN, EB, s);
}

}  // extern "C"
