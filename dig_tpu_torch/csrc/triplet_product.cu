// Fused triplet interaction on the [N, K] neighbour-table layout (SphereNet
// and, without torsion, DimeNet++): forward, backward and second-order
// backward, for NVIDIA Hopper (sm_90a). Plain C interface, loaded through
// ctypes by dig_tpu_torch/ops/triplet_product.py.
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_triplet.py:
// _run_fwd (pl.pallas_call at :263, _fwd_kernel), _run_bwd (:312,
// _bwd_kernel) and _run_bwd2 (:386, _bwd2_kernel).
//
//   out[e] = sum_k m[e,k] * xg[t] * s[t] * tv[t],  t = e*K + k
//   s = sbf[t] @ ws,  tv = tbf[t] @ wt  (tv = 1 without torsion)
//
// xg [T, C], sbf [T, S1], tbf [T, S2], mask [E, K] share one type (float32
// or bf16); ws [S1, C] and wt [S2, C] arrive as float32 values of the
// caller's weights. Every product and sum is float32; each output is
// rounded to its type once.
//
// Backward (per triplet, go = ct[e] m): dxg = go s tv, gs = go xg tv and
// gt = go xg s are the cotangents of s and tv; dsbf = gs @ ws^T and
// dtbf = gt @ wt^T (only with basis gradients); dws = sum_t sbf^T gs and
// dwt = sum_t tbf^T gt. Second order, from the cotangents u1..u5 of
// (dxg, dsbf, dtbf, dws, dwt), with P = u2 @ ws + sbf @ u4 and
// Q = u3 @ wt + tbf @ u5 (the algebra of _bwd2_kernel's docstring):
//   xb  = go (tv P + s Q)
//   sb  = A @ ws^T + (go xg tv) @ u4^T,    A = go (tv u1 + xg Q)
//   tb  = B @ wt^T + (go xg s) @ u5^T,     B = go (s u1 + xg P)
//   wsb = sum_t sbf^T A + u2^T (go xg tv), wtb likewise with B, u3, go xg s
//   ctb[e] = sum_k m (u1 s tv + xg (tv P + s Q))
// Without torsion tv = 1 and Q = 0. A triplet with m = 0 contributes
// nothing to any output and its rows of dxg, dsbf, dtbf, xb, sb and tb are
// 0: the kernels skip it (the inputs may hold garbage there, as
// expand_kj_raw's rows do) and write zeros.
//
// What bounds it on this card. Per real triplet (m != 0) the forward does
// 2 C (S1 + S2) flops for the two basis products and 3 C for the triple
// product; it must read that triplet's xg, sbf and tbf rows and write
// out [E, C]. At SphereNet's force-bench widths on the unblocked layout
// (E = 44,544, K = 16, C = 64, S1 = 18, S2 = 54, bf16; 304,774 of the
// 712,704 triplet rows real in chip_smoke.py's batch) that is 2.87 GFLOP
// against 90.0 MB: the bytes bound it (0.027 ms at 3.35 TB/s against
// 0.003 ms of bf16 tensor-core work). The backward reads the same rows and
// writes dxg [T, C] and, with basis gradients, dsbf and dtbf in full: 8.5
// GFLOP and 281 MB, 0.084 ms, the bytes again. The second order reads
// twice the rows (u1, u2, u3 beside xg, sbf, tbf) and writes xb, sb, tb in
// full: 14.4 GFLOP and 370 MB, 0.110 ms. chip_smoke.py counts both bounds
// from its inputs.
//
// What the design does about it (simple and right first; wgmma for the
// basis products and TMA are later work):
//  - Every input row is read once per pass and every output written once;
//    masked triplets are left out of each kernel's list and their output
//    rows written as zeros. T is not padded: the kernels bound every index.
//  - ws | wt (and u4 | u5) are staged in shared memory, rows of C+1 floats,
//    so reads with c across lanes (the products) and with the basis row
//    across lanes (dsbf, sb) are free of bank conflicts.
//  - Forward: the first kernel gave a warp an edge and walked k in order,
//    each real triplet's mask load, row load and 72-step fmaf chain in
//    turn (6.2% of its byte bound; 55% of its time in the products, 24%
//    in the mask's dependent load). It now walks as triplet_pt_fwd_kernel
//    does (window_list.cuh): 32-triplet chunks listed a window of about
//    1024 triplets at a time, out rows of edges without a real triplet
//    written as 0, batches of 64 listed triplets: the sbf | tbf rows
//    (a warp a row, lanes along it; loads free of branches, bf16 widened
//    by a shift) staged by row, [NB][65], and the xg rows, then a warp's 8
//    triplets x its lanes' Q channels as the pt forward's register tile
//    (row_tile: each weight loaded once for the 8, the basis values as
//    broadcast loads; staged by triplet and read as float4 a triplet, the
//    products took twice as long); each edge's terms summed in list order
//    by a warp a run, the run an edge carries across batches kept in
//    shared memory. Grid: SMs x the occupancy, three blocks of 256 threads
//    an SM at C <= 64.
//  - Backward (triplet_product_bwd_kernel): about 57% of the triplets are
//    masked, and the first kernel's serial loops (a warp per triplet, one
//    shared load per operand, a weight-cotangent loop over every triplet
//    of a 32-triplet chunk, a barrier a chunk) left it at 3% of its byte
//    bound, slower than its plain version. It now walks as
//    triplet_pt_bwd_kernel does (window_list.cuh): a block deals itself the
//    same 32-triplet chunks (b, b + G, ...) a window of about 1024 triplets
//    at a time, lists the window's real triplets in triplet order by warp
//    ballots, writes the masked ones' dxg rows as 0 in 16-byte stores (a
//    bf16 dsbf | dtbf row is not 16-byte aligned: with BASIS the window's
//    chunks are zeroed whole, then the real rows written), and walks the
//    list 64 triplets a barrier. The batch's sbf | tbf rows are staged as [64][NB padded to
//    4] by coalesced scalar loads (a bf16 row is 36 or 108 bytes, not
//    16-byte aligned); products 4 triplets a warp, rows read as float4,
//    each weight loaded once for the 4; dws | dwt a thread's channel x up
//    to 24 rows (36 at C > 64) in registers, read as float4; dsbf | dtbf
//    4 x 3 register tiles. The grid is SMs x the occupancy of the
//    instance with basis gradients, so both instances deal the chunks
//    alike. ptxas (sm_90a): 100-128 registers, no spills; two blocks of
//    256 threads an SM at SphereNet's widths (one at C = 128).
//  - Second order (triplet_product_bwd2_kernel): the first kernel (a warp
//    per triplet over 16-triplet chunks, about half its warps idle on
//    masked triplets, three serial row products a triplet, a weight loop
//    that re-walked every triplet of the chunk) ran at 2% of its byte
//    bound. It now walks as triplet_pt_bwd2_kernel does: the same
//    16-triplet chunks (b, b + G, ...) listed a window of about 1024
//    triplets at a time, masked rows' zeros first (xb in 16-byte stores,
//    the window's sb | tb chunks whole), batches of 32 real triplets; the
//    batch's sbf | tbf and u2 | u3 rows staged by coalesced scalar loads
//    into [32][NB padded to 4]; s, tv, P, Q 4 triplets a warp (2 at C >
//    64), rows read as float4, each weight loaded once for them (the u4 |
//    u5 terms in a second pass, only when present, read through the L1
//    cache); wsb | wtb in (channel x row block) register blocks, the two
//    fmaf a triplet in the first kernel's order; ctb summed per edge in
//    list order in the registers of the first row block's threads,
//    carried across batches; sb | tb as 4 x 3 register tiles. The grid is
//    SMs x the occupancy (264 at two blocks an SM).
//  - Every sum keeps the order of the masked walk: over rows and channels
//    from 0, over a block's real triplets in triplet order, over an edge's
//    in k order. The per-block weight sums go to a [blocks, ...] scratch
//    and sum_partials_kernel adds them in a fixed order. The block count depends only on the shapes and
//    the card, and no atomics are used: repeated calls give the same bits.
#include <stdint.h>

#include "common.cuh"
#include "window_list.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block

template <typename T>
struct Params {
  const T* xg;      // [T, C]
  const T* sbf;     // [T, S1]
  const T* tbf;     // [T, S2] (torsion only)
  const float* ws;  // [S1, C]
  const float* wt;  // [S2, C] (torsion only)
  const T* mask;    // [E, K]
  const float* ct;  // [E, C] (backward, second order)
  const T* u1;      // [T, C] or null: cotangent of dxg
  const T* u2;      // [T, S1] or null: cotangent of dsbf
  const T* u3;      // [T, S2] or null: cotangent of dtbf
  const float* u4;  // [S1, C] or null: cotangent of dws
  const float* u5;  // [S2, C] or null: cotangent of dwt
  T* out;           // [E, C] (forward)
  T* dxg;           // [T, C] (backward: dxg; second order: xb)
  T* dsbf;          // [T, S1] (backward with basis gradients: dsbf; second order: sb)
  T* dtbf;          // [T, S2] (likewise dtbf; tb)
  float* ctb;       // [E, C] (second order)
  float* partial;   // [blocks, NB * C]
  int E, K, C, S1, S2, NB, CE;
};

// rows [0, S1) of w_s <- src1 [S1, C], rows [S1, NB) <- src2 [S2, C], row
// stride C+1 floats.
template <typename T>
__device__ void stage_rows(const Params<T>& p, const float* src1, const float* src2,
                           float* w_s) {
  const int C = p.C;
  for (int x = threadIdx.x; x < p.NB * C; x += NT) {
    const int r = x / C, c = x % C;
    w_s[r * (C + 1) + c] = r < p.S1 ? src1[x] : src2[x - p.S1 * C];
  }
}

// Forward tiles: a batch of FB real triplets, FE of them a warp in the
// products; the batch's sbf | tbf by row, FBP floats a row (odd: a warp's
// stores along a triplet's row fall on distinct banks).
constexpr int FB = 64, FE = FB / NW, FBP = FB + 1;
constexpr int WINDOW = 1024;  // triplets a block lists at a time

// Floats of the forward's shared memory for BW chunks of TC triplets a
// window (fwd_layout's order).
struct FwdLayout {
  int W, rounds;
  size_t w_s, bas, xs, carry, m_s, eds, rs, lst, wcnt, bits, total;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(const Params<T>& p, int TC) {
  FwdLayout L;
  const int BW = TC >= WINDOW ? 1 : WINDOW / TC;
  L.W = BW * TC;
  L.rounds = (L.W + NT - 1) / NT;
  L.w_s = 0;
  L.bas = L.w_s + (size_t)p.NB * (p.C + 1);
  L.xs = L.bas + (size_t)p.NB * FBP;
  L.carry = L.xs + (size_t)FB * p.C;
  L.m_s = L.carry + 2 * (size_t)p.C;
  L.eds = L.m_s + FB;
  L.rs = L.eds + FB;
  L.lst = L.rs + FB + 2;
  L.wcnt = L.lst + L.W;
  L.bits = L.wcnt + (size_t)L.rounds * NW;
  L.total = L.bits + (size_t)L.rounds * NW;
  return L;
}

// The forward, on the compacted walk of window_list.cuh, as
// triplet_pt_fwd_kernel walks: block b deals itself the chunks of TC = CE
// K triplets b, b + G, ... a window of BW chunks at a time, lists the
// window's real triplets in triplet order (each edge's a contiguous run),
// writes the out rows of its edges without one as 0, and walks the list FB
// triplets at a time. Per batch: the listed triplets' sbf | tbf rows (a
// warp a row, lanes along it: coalesced, as a bf16 row of 18 or 54 values
// is not 16-byte aligned; stored by row, [NB][FBP]), xg rows, masks and
// edges are gathered, loads in flight together and free of branches; warp
// 0 lists the runs of equal edges while each warp forms sv and tv of its
// FE triplets as a register tile over its lanes' Q channels (row_tile) and
// leaves xg sv tv in place of the xg row; a warp per run sums its edge's
// terms in list order, the run an edge carries into the next batch kept in
// shared memory. Every sum is the
// masked walk's: sv, tv fmaf chains over the rows from 0, prod = xg sv,
// prod *= tv, acc = fmaf(prod, m, acc) over the edge's real triplets in k
// order; so out keeps its bits whatever the chunking.
template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT, Q == 2 ? 3 : 2) triplet_product_fwd_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, S1 = p.S1, S2 = p.S2, K = p.K, CE = p.CE, TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const FwdLayout L = fwd_layout(p, TC);
  float* w_s = smem + L.w_s;      // [NB][C+1] ws | wt
  float* bas = smem + L.bas;      // [NB][FBP] sbf | tbf by row
  float* xs = smem + L.xs;        // [FB][C] xg rows, then xg sv tv
  float* carry = smem + L.carry;  // [2][C] the sums batches carry on
  float* m_s = smem + L.m_s;      // [FB]
  int* eds = reinterpret_cast<int*>(smem + L.eds);  // [FB] edge of each listed triplet
  int* rs = reinterpret_cast<int*>(smem + L.rs);    // [FB + 2] run starts, cnt; their count
  int* lst = reinterpret_cast<int*>(smem + L.lst);
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);
  stage_rows(p, p.ws, p.wt, w_s);
  const size_t Tn = (size_t)p.E * K;
  const int chunks = (p.E + CE - 1) / CE;
  const int G = gridDim.x, BW = L.W / TC;

  for (int w0 = blockIdx.x; w0 < chunks; w0 += G * BW) {
    const Window win{w0, G, TC, L.W, chunks, Tn};
    const int nl = list_window<NT>(win, p.mask, lst, wcnt, bits, [](size_t) {});
    zero_empty_edges<NT>(win, bits, CE, K, p.E, p.out, C);
    for (int b0 = 0; b0 < nl; b0 += FB) {
      const int cnt = min(FB, nl - b0);
      const int* ids = lst + b0;
      __syncthreads();  // the list is written; the previous batch is done
      {  // a warp FE rows i = warp + NW e (past cnt the last again): sbf |
         // tbf and xg, addresses clamped, no branches
        size_t t[FE];
#pragma unroll
        for (int e = 0; e < FE; ++e) t[e] = (size_t)ids[min(warp + NW * e, cnt - 1)];
        float xv[FE][Q];
#pragma unroll
        for (int e = 0; e < FE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) xv[e][q] = ldw(p.xg + t[e] * C + min(lane + 32 * q, C - 1));
        for (int r = lane; r < NB; r += 32) {
          float v[FE];
#pragma unroll
          for (int e = 0; e < FE; ++e)
            v[e] = ldw(r < S1 ? p.sbf + t[e] * S1 + r : p.tbf + t[e] * S2 + (r - S1));
#pragma unroll
          for (int e = 0; e < FE; ++e) bas[r * FBP + warp + NW * e] = v[e];
        }
#pragma unroll
        for (int e = 0; e < FE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (lane + 32 * q < C) xs[(warp + NW * e) * C + lane + 32 * q] = xv[e][q];
      }
      for (int i = tid; i < FB; i += NT) {
        const int t = ids[min(i, cnt - 1)];
        m_s[i] = ldw(p.mask + t);
        eds[i] = i < cnt ? t / K : -1;
      }
      __syncthreads();
      if (warp == 0) list_runs(eds, cnt, rs, rs + FB + 1);
      const int i0 = warp * FE;
      if (i0 < cnt) {
        float sv[FE][Q], tv[FE][Q];
#pragma unroll
        for (int e = 0; e < FE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) sv[e][q] = tv[e][q] = 0.f;
        row_tile(bas, FBP, w_s, 0, S1, i0, lane, C, sv);
        if constexpr (HAS_T) row_tile(bas, FBP, w_s, S1, NB, i0, lane, C, tv);
#pragma unroll
        for (int e = 0; e < FE; ++e) {
          if (i0 + e >= cnt) break;
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < C) {
              float prod = xs[(i0 + e) * C + c] * sv[e][q];
              if constexpr (HAS_T) prod *= tv[e][q];
              xs[(i0 + e) * C + c] = prod;
            }
          }
        }
      }
      __syncthreads();
      const int par = (b0 / FB) & 1;
      add_edge_runs<NT, Q>(xs, m_s, eds, rs, rs[FB + 1], b0 > 0 ? lst[b0 - 1] / K : -1,
                           carry + par * C, carry + (1 - par) * C, b0 + FB >= nl, p.out, C);
    }
  }
}

// Backward tiles: a batch of BB real triplets; products TE triplets a warp;
// dsbf | dtbf TE2 triplets x TR rows a thread (TR odd: no bank conflicts on
// the weights' C + 1 stride).
constexpr int BB = 64, TE = 4, TE2 = 4, TR = 3;

// Floats of the backward's shared memory for BW chunks of TC triplets a
// window (bwd_layout's order).
struct BwdLayout {
  int NBp, CP, W, rounds;
  size_t w_s, dW_s, bas, gs, gt, m_s, lst, wcnt, bits, total;
};

template <typename T, bool HAS_T>
__host__ __device__ inline BwdLayout bwd_layout(const Params<T>& p, int TC) {
  BwdLayout L;
  L.NBp = (p.NB + 3) & ~3;  // float4 rows of sbf | tbf
  L.CP = p.C + 1;
  const int BW = TC >= WINDOW ? 1 : WINDOW / TC;
  L.W = BW * TC;
  L.rounds = (L.W + NT - 1) / NT;
  L.w_s = 0;
  L.dW_s = L.w_s + (size_t)p.NB * (p.C + 1);
  L.bas = (L.dW_s + (size_t)p.NB * p.C + 3) & ~(size_t)3;  // 16-byte aligned
  L.gs = L.bas + (size_t)BB * L.NBp;
  L.gt = L.gs + (size_t)BB * L.CP;
  L.m_s = L.gt + (HAS_T ? (size_t)BB * L.CP : 0);
  L.lst = L.m_s + BB;
  L.wcnt = L.lst + L.W;
  L.bits = L.wcnt + (size_t)L.rounds * NW;
  L.total = L.bits + (size_t)L.rounds * NW;
  return L;
}

// The backward, walked as triplet_pt_bwd_kernel walks its own: block b owns
// the chunks of TC = CE K triplets b, b + G, b + 2G, ... (G = gridDim.x)
// and takes them a window of BW chunks at a time (window_list.cuh): the
// window's real triplets are listed in triplet order by warp ballots, the
// masked ones get their dxg rows (and, with BASIS, dsbf and dtbf rows)
// written as 0 (zero_masked_rows), and the list is walked BB triplets at a
// time. Per batch:
// the sbf | tbf rows staged as [BB][NBp] (coalesced scalar loads: a bf16
// row of 18 or 54 values is not 16-byte aligned); sv, tv, dxg and the
// cotangents gs, gt of sv, tv (a warp per TE triplets, lanes over the
// channels, rows read as float4, each weight loaded once for the warp's
// triplets); the block's dws | dwt (each entry owned by one thread, a row
// block of up to WTM rows kept in registers over the batch and read as
// float4); with BASIS, dsbf | dtbf = gs @ ws^T | gt @ wt^T as TE2 x TR
// register tiles (over the staged rows, dead by then), written row by row.
// Every sum keeps the order of the masked walk over the same chunks: sv, tv
// over the rows from 0, dsbf | dtbf over the channels from 0, dws | dwt
// over the block's real triplets in triplet order.
template <typename T, int Q, bool HAS_T, bool BASIS>
__global__ void __launch_bounds__(NT, 2) triplet_product_bwd_kernel(Params<T> p) {
  constexpr int WTM = Q == 2 ? 24 : 36;  // dws | dwt rows of a thread's register block
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, S1 = p.S1, S2 = p.S2, K = p.K, TC = p.CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const BwdLayout L = bwd_layout<T, HAS_T>(p, TC);
  const int NBp = L.NBp, CP = L.CP, W = L.W;
  float* w_s = smem + L.w_s;    // [NB][C+1] ws | wt
  float* dW_s = smem + L.dW_s;  // [NB][C] dws | dwt of this block
  float* bas = smem + L.bas;    // [BB][NBp] sbf | tbf, then (BASIS) dsbf | dtbf
  float* gs = smem + L.gs;      // [BB][C+1] cotangent of s
  float* gt = smem + L.gt;      // [BB][C+1] cotangent of tv (torsion)
  float* m_s = smem + L.m_s;    // [BB]
  int* lst = reinterpret_cast<int*>(smem + L.lst);            // [W] real triplets
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);          // [rounds * NW]
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);  // [rounds * NW]
  stage_rows(p, p.ws, p.wt, w_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  const size_t Tn = (size_t)p.E * K;
  const int chunks = (p.E + p.CE - 1) / p.CE;
  const int G = gridDim.x, BW = W / TC;
  // dws | dwt: thread items (channel c, a block of rpg rows), rpg a multiple
  // of 4 of about NB C / NT rows, at most WTM
  int rpg = (NB * C + NT - 1) / NT;
  rpg = min(WTM, (rpg + 3) & ~3);
  const int ngroups = (NB + rpg - 1) / rpg;

  for (int w0 = blockIdx.x; w0 < chunks; w0 += G * BW) {
    const Window win{w0, G, TC, W, chunks, Tn};
    const int nl = list_window<NT>(win, p.mask, lst, wcnt, bits, [](size_t) {});
    zero_masked_rows<NT>(win, bits, p.dxg, C);
    if constexpr (BASIS) {
      zero_masked_rows<NT>(win, bits, p.dsbf, S1);
      if constexpr (HAS_T) zero_masked_rows<NT>(win, bits, p.dtbf, S2);
    }

    for (int b0 = 0; b0 < nl; b0 += BB) {
      const int cnt = min(BB, nl - b0);
      const int* ids = lst + b0;
      __syncthreads();  // the list is written; the previous batch is done
      // sbf | tbf rows; zero past cnt and NB
      for (int x = tid; x < BB * NBp; x += NT) {
        const int i = x / NBp, r = x % NBp;
        float v = 0.f;
        if (i < cnt && r < NB) {
          const size_t t = (size_t)ids[i];
          v = r < S1 ? ld(p.sbf + t * S1 + r) : ld(p.tbf + t * S2 + (r - S1));
        }
        bas[x] = v;
      }
      for (int i = tid; i < BB; i += NT) m_s[i] = i < cnt ? ld(p.mask + ids[i]) : 0.f;
      __syncthreads();
      // sv, tv of TE triplets a warp; dxg, gs, gt
      for (int e0 = warp * TE; e0 < cnt; e0 += NW * TE) {
        float sv[TE][Q], tv[TE][Q];
#pragma unroll
        for (int e = 0; e < TE; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) sv[e][q] = tv[e][q] = 0.f;
        for (int r = 0; r < NB; r += 4) {
          float4 b4[TE];
#pragma unroll
          for (int e = 0; e < TE; ++e)
            b4[e] = *reinterpret_cast<const float4*>(bas + (e0 + e) * NBp + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = r + j;
            if (rr >= NB) break;
            float wv[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q)
              wv[q] = lane + 32 * q < C ? w_s[rr * (C + 1) + lane + 32 * q] : 0.f;
#pragma unroll
            for (int e = 0; e < TE; ++e) {
              const float bv = j == 0 ? b4[e].x : j == 1 ? b4[e].y : j == 2 ? b4[e].z : b4[e].w;
#pragma unroll
              for (int q = 0; q < Q; ++q) {
                if (rr < S1) sv[e][q] = fmaf(bv, wv[q], sv[e][q]);
                else tv[e][q] = fmaf(bv, wv[q], tv[e][q]);
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < TE; ++e) {
          const int i = e0 + e;
          if (i >= cnt) break;
          const size_t t = (size_t)ids[i];
          const size_t ed = t / K;
          const float m = m_s[i];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < C) {
              const float go = p.ct[ed * C + c] * m;
              const float x = ld(p.xg + t * C + c);
              float d = go * sv[e][q], g1 = go * x;
              if constexpr (HAS_T) {
                d *= tv[e][q];
                gt[i * CP + c] = g1 * sv[e][q];
                g1 *= tv[e][q];
              }
              st(p.dxg + t * C + c, d);
              gs[i * CP + c] = g1;
            }
          }
        }
      }
      __syncthreads();
      // dws | dwt: item (c, row block), the block's rows in registers, the
      // batch's triplets in order
      for (int it = tid; it < C * ngroups; it += NT) {
        const int c = it % C, r0 = (it / C) * rpg;
        const int r1 = min(NB, r0 + rpg);
        float acc[WTM];
#pragma unroll
        for (int j = 0; j < WTM; ++j) acc[j] = r0 + j < r1 ? dW_s[(r0 + j) * C + c] : 0.f;
        for (int i = 0; i < cnt; ++i) {
          const float g_s = gs[i * CP + c];
          const float g_t = HAS_T ? gt[i * CP + c] : 0.f;
          const float* brow = bas + i * NBp + r0;
#pragma unroll
          for (int j4 = 0; j4 < WTM / 4; ++j4) {
            if (r0 + 4 * j4 >= r1) break;
            const float4 b4 = *reinterpret_cast<const float4*>(brow + 4 * j4);
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = r0 + 4 * j4 + j;
              if (rr < r1) acc[4 * j4 + j] = fmaf(bv[j], rr < S1 ? g_s : g_t, acc[4 * j4 + j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < WTM; ++j)
          if (r0 + j < r1) dW_s[(r0 + j) * C + c] = acc[j];
      }
      if constexpr (BASIS) {
        __syncthreads();  // sbf | tbf are dead: dsbf | dtbf go there
        // dsbf = gs @ ws^T, dtbf = gt @ wt^T: TE2 triplets x TR rows a
        // thread, rows of a tile all of ws or all of wt, each sum over c
        // from 0
        const int rts = (S1 + TR - 1) / TR;
        const int rtl = rts + (HAS_T ? (S2 + TR - 1) / TR : 0);
        const int etl = (cnt + TE2 - 1) / TE2;
        for (int x = tid; x < etl * rtl; x += NT) {
          const int et = x / rtl, rt = x % rtl;
          const bool sr = rt < rts;
          const int r0 = sr ? rt * TR : S1 + (rt - rts) * TR;
          const int r1 = sr ? S1 : NB;
          const float* g = sr ? gs : gt;
          const float* wr[TR];
          int es[TE2];
#pragma unroll
          for (int i = 0; i < TR; ++i) wr[i] = w_s + min(r0 + i, r1 - 1) * (C + 1);
#pragma unroll
          for (int e = 0; e < TE2; ++e) es[e] = min(et * TE2 + e, cnt - 1) * CP;
          float acc[TE2][TR];
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) acc[e][i] = 0.f;
          for (int c = 0; c < C; ++c) {
            float gv[TE2], wv[TR];
#pragma unroll
            for (int e = 0; e < TE2; ++e) gv[e] = g[es[e] + c];
#pragma unroll
            for (int i = 0; i < TR; ++i) wv[i] = wr[i][c];
#pragma unroll
            for (int e = 0; e < TE2; ++e)
#pragma unroll
              for (int i = 0; i < TR; ++i) acc[e][i] = fmaf(gv[e], wv[i], acc[e][i]);
          }
#pragma unroll
          for (int e = 0; e < TE2; ++e) {
            const int i = et * TE2 + e;
            if (i >= cnt) continue;
#pragma unroll
            for (int k2 = 0; k2 < TR; ++k2)
              if (r0 + k2 < r1) bas[i * NBp + r0 + k2] = acc[e][k2];
          }
        }
        __syncthreads();
        // the batch's dsbf | dtbf rows, lanes along each row
        for (int x = tid; x < cnt * NB; x += NT) {
          const int i = x / NB, r = x % NB;
          const size_t t = (size_t)ids[i];
          const float v = bas[i * NBp + r];
          if (r < S1) st(p.dsbf + t * S1 + r, v);
          else st(p.dtbf + t * S2 + (r - S1), v);
        }
      }
    }
  }
  __syncthreads();
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

// The second order's batches: BB2 real triplets.
constexpr int BB2 = 32;

// Floats of the second order's shared memory for BW chunks of TC triplets
// a window (bwd2_layout's order).
struct Bwd2Layout {
  int NBp, CP, W, rounds;
  size_t w_s, dW_s, bas, ubas, A, Gt, I, B, Gs, m_s, lst, wcnt, bits, total;
};

template <typename T, bool HAS_T>
__host__ __device__ inline Bwd2Layout bwd2_layout(const Params<T>& p, int TC) {
  Bwd2Layout L;
  L.NBp = (p.NB + 3) & ~3;
  L.CP = p.C + 1;
  const int BW = TC >= WINDOW ? 1 : WINDOW / TC;
  L.W = BW * TC;
  L.rounds = (L.W + NT - 1) / NT;
  const size_t tc = (size_t)BB2 * L.CP;
  L.w_s = 0;
  L.dW_s = L.w_s + (size_t)p.NB * (p.C + 1);
  L.bas = (L.dW_s + (size_t)p.NB * p.C + 3) & ~(size_t)3;  // 16-byte aligned
  L.ubas = L.bas + (size_t)BB2 * L.NBp;
  L.A = L.ubas + (size_t)BB2 * L.NBp;
  L.Gt = L.A + tc;
  L.I = L.Gt + tc;
  L.B = L.I + tc;
  L.Gs = L.B + (HAS_T ? tc : 0);
  L.m_s = L.Gs + (HAS_T ? tc : 0);
  L.lst = L.m_s + BB2;
  L.wcnt = L.lst + L.W;
  L.bits = L.wcnt + (size_t)L.rounds * NW;
  L.total = L.bits + (size_t)L.rounds * NW;
  return L;
}

// Row rr of u4 | u5, or null where that cotangent is absent.
template <typename T>
__device__ __forceinline__ const float* u_row(const Params<T>& p, int rr) {
  if (rr < p.S1) return p.u4 != nullptr ? p.u4 + (size_t)rr * p.C : nullptr;
  return p.u5 != nullptr ? p.u5 + (size_t)(rr - p.S1) * p.C : nullptr;
}

// Second order. Per real triplet and channel: A and B as in the header
// (B torsion only), G_t = go xg tv (the cotangent term of u4's product),
// G_s = go xg s (u5's), I = m (u1 s tv + xg (tv P + s Q)).
// Walked as triplet_pt_bwd2_kernel walks its own (window_list.cuh): the
// window's real triplets listed by ballots (triplet order is edge order),
// the masked ones' xb rows (16-byte stores) and the window's sb | tb chunks
// (whole: a row of 18 or 54 values is not 16-byte aligned) written as 0,
// and the ctb rows of edges without a real triplet; the list walked BB2
// triplets at a time. Per batch: the sbf | tbf and u2 | u3 rows staged as
// [BB2][NBp] by coalesced scalar loads; s, tv, P, Q of TEQ triplets a warp
// (each weight loaded once for the warp's triplets; sbf @ u4 | tbf @ u5 in
// a second pass, only when present, read through the L1 cache), xb and
// A, Gt, I, B, Gs; wsb | wtb over (channel, row block) register blocks,
// the two fmaf a triplet in the order sbf^T A, then u2^T Gt (tbf^T B, then
// u3^T Gs), while the threads of the first row block also sum each edge's
// I in list order, carried across batches in registers and written when
// the edge changes; sb | tb (A @ ws^T + Gt @ u4^T | B @ wt^T + Gs @ u5^T)
// as TE2 x TR register tiles over the staged rows, then written row by
// row after the zeros. Every sum keeps the order of the first kernel's
// masked walk over the same chunks, so every output keeps its bits
// wherever the grid keeps its block count.
template <typename T, int Q, bool HAS_T>
__global__ void __launch_bounds__(NT, 2) triplet_product_bwd2_kernel(Params<T> p) {
  constexpr int TEQ = Q == 2 ? 4 : 2;    // triplets a warp in the products
  constexpr int WTM = Q == 2 ? 24 : 36;  // wsb | wtb rows of a thread's register block
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, NB = p.NB, S1 = p.S1, S2 = p.S2, K = p.K, CE = p.CE, TC = CE * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const bool has_u45 = p.u4 != nullptr || p.u5 != nullptr;
  const Bwd2Layout L = bwd2_layout<T, HAS_T>(p, TC);
  const int NBp = L.NBp, CP = L.CP, W = L.W;
  float* w_s = smem + L.w_s;    // [NB][C+1] ws | wt
  float* dW_s = smem + L.dW_s;  // [NB][C] wsb | wtb of this block
  float* bas = smem + L.bas;    // [BB2][NBp] sbf | tbf, then sb | tb
  float* ubas = smem + L.ubas;  // [BB2][NBp] u2 | u3 (zeros where absent)
  float* A_s = smem + L.A;      // [BB2][C+1]
  float* Gt_s = smem + L.Gt;    // [BB2][C+1]
  float* I_s = smem + L.I;      // [BB2][C+1] ctb terms
  float* B_s = smem + L.B;      // [BB2][C+1] (torsion)
  float* Gs_s = smem + L.Gs;    // [BB2][C+1] (torsion)
  float* m_s = smem + L.m_s;    // [BB2]
  int* lst = reinterpret_cast<int*>(smem + L.lst);
  int* wcnt = reinterpret_cast<int*>(smem + L.wcnt);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);
  stage_rows(p, p.ws, p.wt, w_s);
  for (int x = tid; x < NB * C; x += NT) dW_s[x] = 0.f;
  const size_t Tn = (size_t)p.E * K;
  const int chunks = (p.E + CE - 1) / CE;
  const int G = gridDim.x, BW = W / TC;
  int rpg = (NB * C + NT - 1) / NT;
  rpg = min(WTM, (rpg + 3) & ~3);
  const int ngroups = (NB + rpg - 1) / rpg;

  for (int w0 = blockIdx.x; w0 < chunks; w0 += G * BW) {
    const Window win{w0, G, TC, W, chunks, Tn};
    const int nl = list_window<NT>(win, p.mask, lst, wcnt, bits, [](size_t) {});
    zero_masked_rows<NT>(win, bits, p.dxg, C);
    zero_masked_rows<NT>(win, bits, p.dsbf, S1);
    if constexpr (HAS_T) zero_masked_rows<NT>(win, bits, p.dtbf, S2);
    // ctb rows of the window's edges without a real triplet
    for (int x = tid; x < BW * CE * C; x += NT) {
      const int le = x / C, j = le / CE, ce = le % CE;
      const size_t ch = (size_t)w0 + (size_t)G * j, e = ch * CE + ce;
      if (ch >= (size_t)chunks || e >= (size_t)p.E) continue;
      if (!any_listed(bits, j * TC + ce * K, K)) p.ctb[e * C + x % C] = 0.f;
    }
    // (tid < C) the edge whose ctb entry of channel tid is being summed
    int cur = -1;
    float cacc = 0.f;

    for (int b0 = 0; b0 < nl; b0 += BB2) {
      const int cnt = min(BB2, nl - b0);
      const int* ids = lst + b0;
      __syncthreads();  // the list is written; the previous batch is done
      // sbf | tbf and u2 | u3 rows; zero past cnt and NB
      for (int x = tid; x < BB2 * NBp; x += NT) {
        const int i = x / NBp, r = x % NBp;
        float v = 0.f, u = 0.f;
        if (i < cnt && r < NB) {
          const size_t t = (size_t)ids[i];
          if (r < S1) {
            v = ld(p.sbf + t * S1 + r);
            if (p.u2 != nullptr) u = ld(p.u2 + t * S1 + r);
          } else {
            v = ld(p.tbf + t * S2 + (r - S1));
            if (p.u3 != nullptr) u = ld(p.u3 + t * S2 + (r - S1));
          }
        }
        bas[x] = v;
        ubas[x] = u;
      }
      for (int i = tid; i < BB2; i += NT) m_s[i] = i < cnt ? ld(p.mask + ids[i]) : 0.f;
      __syncthreads();
      // s, tv (sbf | tbf against ws | wt), P, Q (u2 | u3 against them) of
      // TEQ triplets a warp; xb, A, Gt, I, B, Gs
      for (int e0 = warp * TEQ; e0 < cnt; e0 += NW * TEQ) {
        float sv[TEQ][Q], tv[TEQ][Q], P[TEQ][Q], Qv[TEQ][Q];
#pragma unroll
        for (int e = 0; e < TEQ; ++e)
#pragma unroll
          for (int q = 0; q < Q; ++q) sv[e][q] = tv[e][q] = P[e][q] = Qv[e][q] = 0.f;
        for (int r = 0; r < NB; r += 4) {
          float4 b4[TEQ], u4v[TEQ];
#pragma unroll
          for (int e = 0; e < TEQ; ++e) {
            b4[e] = *reinterpret_cast<const float4*>(bas + (e0 + e) * NBp + r);
            u4v[e] = *reinterpret_cast<const float4*>(ubas + (e0 + e) * NBp + r);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = r + j;
            if (rr >= NB) break;
            float wv[Q];
#pragma unroll
            for (int q = 0; q < Q; ++q)
              wv[q] = lane + 32 * q < C ? w_s[rr * (C + 1) + lane + 32 * q] : 0.f;
#pragma unroll
            for (int e = 0; e < TEQ; ++e) {
              const float bv = j == 0 ? b4[e].x : j == 1 ? b4[e].y : j == 2 ? b4[e].z : b4[e].w;
              const float uv =
                  j == 0 ? u4v[e].x : j == 1 ? u4v[e].y : j == 2 ? u4v[e].z : u4v[e].w;
#pragma unroll
              for (int q = 0; q < Q; ++q) {
                if (rr < S1) {
                  sv[e][q] = fmaf(bv, wv[q], sv[e][q]);
                  P[e][q] = fmaf(uv, wv[q], P[e][q]);
                } else {
                  tv[e][q] = fmaf(bv, wv[q], tv[e][q]);
                  Qv[e][q] = fmaf(uv, wv[q], Qv[e][q]);
                }
              }
            }
          }
        }
        if (has_u45) {  // P += sbf @ u4, Q += tbf @ u5, each summed alone first
          float a4[TEQ][Q], a5[TEQ][Q];
#pragma unroll
          for (int e = 0; e < TEQ; ++e)
#pragma unroll
            for (int q = 0; q < Q; ++q) a4[e][q] = a5[e][q] = 0.f;
          for (int r = 0; r < NB; r += 4) {
            float4 b4[TEQ];
#pragma unroll
            for (int e = 0; e < TEQ; ++e)
              b4[e] = *reinterpret_cast<const float4*>(bas + (e0 + e) * NBp + r);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = r + j;
              if (rr >= NB) break;
              const float* u = u_row(p, rr);
              float uv[Q];
#pragma unroll
              for (int q = 0; q < Q; ++q)
                uv[q] = u != nullptr && lane + 32 * q < C ? __ldg(u + lane + 32 * q) : 0.f;
#pragma unroll
              for (int e = 0; e < TEQ; ++e) {
                const float bv = j == 0 ? b4[e].x : j == 1 ? b4[e].y : j == 2 ? b4[e].z : b4[e].w;
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                  if (rr < S1) a4[e][q] = fmaf(bv, uv[q], a4[e][q]);
                  else a5[e][q] = fmaf(bv, uv[q], a5[e][q]);
                }
              }
            }
          }
#pragma unroll
          for (int e = 0; e < TEQ; ++e)
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              P[e][q] += a4[e][q];
              if constexpr (HAS_T) Qv[e][q] += a5[e][q];
            }
        }
#pragma unroll
        for (int e = 0; e < TEQ; ++e) {
          const int i = e0 + e;
          if (i >= cnt) break;
          const size_t t = (size_t)ids[i];
          const size_t ed = t / K;
          const float m = m_s[i];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < C) {
              const float go = p.ct[ed * C + c] * m;
              const float x = ld(p.xg + t * C + c);
              const float u1 = p.u1 != nullptr ? ld(p.u1 + t * C + c) : 0.f;
              float core, A, Gt, integ;
              if constexpr (HAS_T) {
                core = tv[e][q] * P[e][q] + sv[e][q] * Qv[e][q];
                A = go * (tv[e][q] * u1 + x * Qv[e][q]);
                B_s[i * CP + c] = go * (sv[e][q] * u1 + x * P[e][q]);
                Gs_s[i * CP + c] = (go * x) * sv[e][q];
                Gt = (go * x) * tv[e][q];
                integ = (u1 * sv[e][q]) * tv[e][q] + x * core;
              } else {
                core = P[e][q];
                A = go * u1;
                Gt = go * x;
                integ = u1 * sv[e][q] + x * core;
              }
              st(p.dxg + t * C + c, go * core);
              A_s[i * CP + c] = A;
              Gt_s[i * CP + c] = Gt;
              I_s[i * CP + c] = integ * m;
            }
          }
        }
      }
      __syncthreads();
      // wsb | wtb: item (c, row block), the rows in registers, the batch's
      // triplets in order; the items of the first row block (it = tid < C)
      // also sum ctb[e][c] over each edge's real triplets in order
      for (int it = tid; it < C * ngroups; it += NT) {
        const int c = it % C, r0 = (it / C) * rpg;
        const int r1 = min(NB, r0 + rpg);
        float acc[WTM];
#pragma unroll
        for (int j = 0; j < WTM; ++j) acc[j] = r0 + j < r1 ? dW_s[(r0 + j) * C + c] : 0.f;
        for (int i = 0; i < cnt; ++i) {
          const float a = A_s[i * CP + c], gt = Gt_s[i * CP + c];
          const float b = HAS_T ? B_s[i * CP + c] : 0.f, gs = HAS_T ? Gs_s[i * CP + c] : 0.f;
          const float* brow = bas + i * NBp + r0;
          const float* urow = ubas + i * NBp + r0;
#pragma unroll
          for (int j4 = 0; j4 < WTM / 4; ++j4) {
            if (r0 + 4 * j4 >= r1) break;
            const float4 b4 = *reinterpret_cast<const float4*>(brow + 4 * j4);
            const float4 u4v = *reinterpret_cast<const float4*>(urow + 4 * j4);
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
            const float uv[4] = {u4v.x, u4v.y, u4v.z, u4v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int rr = r0 + 4 * j4 + j;
              if (rr < r1) {
                const bool sr = !HAS_T || rr < S1;
                acc[4 * j4 + j] = fmaf(bv[j], sr ? a : b, acc[4 * j4 + j]);
                acc[4 * j4 + j] = fmaf(uv[j], sr ? gt : gs, acc[4 * j4 + j]);
              }
            }
          }
          if (r0 == 0) {
            const int e = ids[i] / K;
            if (e != cur) {
              if (cur >= 0) p.ctb[(size_t)cur * C + c] = cacc;
              cur = e;
              cacc = 0.f;
            }
            cacc += I_s[i * CP + c];
          }
        }
#pragma unroll
        for (int j = 0; j < WTM; ++j)
          if (r0 + j < r1) dW_s[(r0 + j) * C + c] = acc[j];
      }
      __syncthreads();  // sbf | tbf are dead: sb | tb go there
      // sb = A @ ws^T + Gt @ u4^T, tb = B @ wt^T + Gs @ u5^T: TE2 triplets x
      // TR rows a thread, rows of a tile all of ws or all of wt, each sum
      // over c from 0. The row tiles run fastest across a warp, but with
      // u4 | u5 the triplet tiles do, so that a warp's reads of their rows
      // (from global) fall on few rows.
      const int rts = (S1 + TR - 1) / TR;
      const int rtl = rts + (HAS_T ? (S2 + TR - 1) / TR : 0);
      const int etl = (cnt + TE2 - 1) / TE2;
      for (int x = tid; x < etl * rtl; x += NT) {
        const int rt = has_u45 ? x / etl : x % rtl, et = has_u45 ? x % etl : x / rtl;
        const bool sr = rt < rts;
        const int r0 = sr ? rt * TR : S1 + (rt - rts) * TR;
        const int r1 = sr ? S1 : NB;
        const float* P1 = sr ? A_s : B_s;
        const float* P2 = sr ? Gt_s : Gs_s;
        const float* wr[TR];
        int es[TE2];
#pragma unroll
        for (int i = 0; i < TR; ++i) wr[i] = w_s + min(r0 + i, r1 - 1) * (C + 1);
#pragma unroll
        for (int e = 0; e < TE2; ++e) es[e] = min(et * TE2 + e, cnt - 1) * CP;
        float acc[TE2][TR];
#pragma unroll
        for (int e = 0; e < TE2; ++e)
#pragma unroll
          for (int i = 0; i < TR; ++i) acc[e][i] = 0.f;
        for (int c = 0; c < C; ++c) {
          float gv[TE2], wv[TR];
#pragma unroll
          for (int e = 0; e < TE2; ++e) gv[e] = P1[es[e] + c];
#pragma unroll
          for (int i = 0; i < TR; ++i) wv[i] = wr[i][c];
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) acc[e][i] = fmaf(gv[e], wv[i], acc[e][i]);
        }
        const float* ur0 = u_row(p, r0);
        if (ur0 != nullptr) {  // this tile's rows have their u4 | u5 term
          const float* ur[TR];
#pragma unroll
          for (int i = 0; i < TR; ++i) ur[i] = u_row(p, min(r0 + i, r1 - 1));
          float gu[TE2][TR];
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) gu[e][i] = 0.f;
          for (int c = 0; c < C; ++c) {
            float gv[TE2], uv[TR];
#pragma unroll
            for (int e = 0; e < TE2; ++e) gv[e] = P2[es[e] + c];
#pragma unroll
            for (int i = 0; i < TR; ++i) uv[i] = __ldg(ur[i] + c);
#pragma unroll
            for (int e = 0; e < TE2; ++e)
#pragma unroll
              for (int i = 0; i < TR; ++i) gu[e][i] = fmaf(gv[e], uv[i], gu[e][i]);
          }
#pragma unroll
          for (int e = 0; e < TE2; ++e)
#pragma unroll
            for (int i = 0; i < TR; ++i) acc[e][i] += gu[e][i];
        }
#pragma unroll
        for (int e = 0; e < TE2; ++e) {
          const int i = et * TE2 + e;
          if (i >= cnt) continue;
#pragma unroll
          for (int k2 = 0; k2 < TR; ++k2)
            if (r0 + k2 < r1) bas[i * NBp + r0 + k2] = acc[e][k2];
        }
      }
      __syncthreads();
      // the batch's sb | tb rows, lanes along each row
      for (int x = tid; x < cnt * NB; x += NT) {
        const int i = x / NB, r = x % NB;
        const size_t t = (size_t)ids[i];
        const float v = bas[i * NBp + r];
        if (r < S1) st(p.dsbf + t * S1 + r, v);
        else st(p.dtbf + t * S2 + (r - S1), v);
      }
    }
    if (tid < C && cur >= 0) p.ctb[(size_t)cur * C + tid] = cacc;
  }
  __syncthreads();
  float* part = p.partial + (size_t)blockIdx.x * NB * C;
  for (int x = tid; x < NB * C; x += NT) part[x] = dW_s[x];
}

template <typename T>
Params<T> make_params(const void* xg, const void* sbf, const void* tbf, const float* ws,
                      const float* wt, const void* mask, int E, int K, int C, int S1, int S2) {
  Params<T> p{};
  p.xg = static_cast<const T*>(xg);
  p.sbf = static_cast<const T*>(sbf);
  p.tbf = static_cast<const T*>(tbf);
  p.ws = ws;
  p.wt = wt;
  p.mask = static_cast<const T*>(mask);
  p.E = E; p.K = K; p.C = C; p.S1 = S1; p.S2 = S2;
  p.NB = S1 + S2;
  return p;
}

// edges per chunk: TC = CE * K triplets, about `triplets` of them
int chunk_edges(int K, int triplets) { return K >= triplets ? 1 : triplets / K; }

constexpr int FWD_TRIPLETS = 32, BWD_TRIPLETS = 32, BWD2_TRIPLETS = 16;

// The forward: its grid is SMs x its occupancy (occupancy_grid), at most
// one block a chunk.
template <typename T, int Q, bool HAS_T>
int fwd_q(Params<T> p, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, FWD_TRIPLETS);
  const size_t smem = fwd_layout(p, p.CE * p.K).total * sizeof(float);
  auto kern = triplet_product_fwd_kernel<T, Q, HAS_T>;
  int blocks = 0;
  const int rc = occupancy_grid(kern, NT, smem, (p.E + p.CE - 1) / p.CE, &blocks);
  if (rc != 0) return rc;
  kern<<<blocks, NT, smem, strm>>>(p);
  return cudaGetLastError();
}

// The backward of one instance: its grid in *blocks, and the launch unless
// only the grid is asked for (run false). The grid is occupancy_grid's for
// the instance with basis gradients, whichever runs, so both deal the
// chunks alike and dws | dwt have the same bits with and without them.
template <typename T, int Q, bool HAS_T, bool BASIS>
int bwd_q(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, BWD_TRIPLETS);
  const size_t smem = bwd_layout<T, HAS_T>(p, p.CE * p.K).total * sizeof(float);
  const int rc = occupancy_grid(triplet_product_bwd_kernel<T, Q, HAS_T, true>, NT, smem,
                                (p.E + p.CE - 1) / p.CE, blocks);
  if (rc != 0 || !run) return rc;
  return launch(triplet_product_bwd_kernel<T, Q, HAS_T, BASIS>, *blocks, NT, smem, strm, p);
}

// The second order likewise, with its own occupancy.
template <typename T, int Q, bool HAS_T>
int bwd2_q(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  p.CE = chunk_edges(p.K, BWD2_TRIPLETS);
  const size_t smem = bwd2_layout<T, HAS_T>(p, p.CE * p.K).total * sizeof(float);
  auto kern = triplet_product_bwd2_kernel<T, Q, HAS_T>;
  const int rc = occupancy_grid(kern, NT, smem, (p.E + p.CE - 1) / p.CE, blocks);
  if (rc != 0 || !run) return rc;
  return launch(kern, *blocks, NT, smem, strm, p);
}

// Q = channels a lane: 2 for C <= 64, 4 for C <= 128
template <typename T>
int fwd_c(Params<T> p, cudaStream_t strm) {
  const bool t = p.S2 > 0;
  if (p.C <= 64) return t ? fwd_q<T, 2, true>(p, strm) : fwd_q<T, 2, false>(p, strm);
  if (p.C <= 128) return t ? fwd_q<T, 4, true>(p, strm) : fwd_q<T, 4, false>(p, strm);
  return ERR_SHAPE;
}

template <typename T, int Q>
int bwd_b(Params<T> p, int basis, int* blocks, bool run, cudaStream_t strm) {
  if (p.S2 > 0) {
    return basis ? bwd_q<T, Q, true, true>(p, blocks, run, strm)
                 : bwd_q<T, Q, true, false>(p, blocks, run, strm);
  }
  return basis ? bwd_q<T, Q, false, true>(p, blocks, run, strm)
               : bwd_q<T, Q, false, false>(p, blocks, run, strm);
}

template <typename T>
int bwd_c(Params<T> p, int basis, int* blocks, bool run, cudaStream_t strm) {
  if (p.C <= 64) return bwd_b<T, 2>(p, basis, blocks, run, strm);
  if (p.C <= 128) return bwd_b<T, 4>(p, basis, blocks, run, strm);
  return ERR_SHAPE;
}

template <typename T>
int bwd2_c(Params<T> p, int* blocks, bool run, cudaStream_t strm) {
  const bool t = p.S2 > 0;
  if (p.C <= 64)
    return t ? bwd2_q<T, 2, true>(p, blocks, run, strm) : bwd2_q<T, 2, false>(p, blocks, run, strm);
  if (p.C <= 128)
    return t ? bwd2_q<T, 4, true>(p, blocks, run, strm) : bwd2_q<T, 4, false>(p, blocks, run, strm);
  return ERR_SHAPE;
}

bool bad_shape(int E, int K, int C, int S1, int S2) {
  return E <= 0 || K <= 0 || C <= 0 || C > 128 || S1 <= 0 || S2 < 0 ||
         (long long)E * K >= (1LL << 31);
}

}  // namespace

extern "C" {

// Number of blocks (rows of the partial-sum scratch) of the backward
// (second_order = 0; with basis gradients or not, on this card) or of the
// second-order pass, at E edges of K triplets; ERR_SHAPE / ERR_SMEM for a
// shape the kernels do not take, -1 for a CUDA error.
int triplet_product_blocks(int E, int K, int C, int S1, int S2, int bf16, int second_order) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  int blocks = -1, rc;
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, E,
                                        K, C, S1, S2);
    rc = second_order ? bwd2_c(p, &blocks, false, nullptr) : bwd_c(p, 1, &blocks, false, nullptr);
  } else {
    auto p = make_params<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, E, K, C, S1,
                                S2);
    rc = second_order ? bwd2_c(p, &blocks, false, nullptr) : bwd_c(p, 1, &blocks, false, nullptr);
  }
  return rc == 0 ? blocks : rc < 0 ? rc : -1;
}

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM. xg, sbf, tbf, mask
// and out share one type: bf16 when bf16 != 0, float32 otherwise. tbf and
// wt are null (S2 = 0) without torsion.
int triplet_product_fwd(const void* xg, const void* sbf, const void* tbf, const float* ws,
                        const float* wt, const void* mask, void* out, int E, int K, int C, int S1,
                        int S2, int bf16, void* stream) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.out = static_cast<__nv_bfloat16*>(out);
    return fwd_c(p, strm);
  }
  auto p = make_params<float>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
  p.out = static_cast<float*>(out);
  return fwd_c(p, strm);
}

// ct float32 [E, C]; dxg [T, C], dsbf [T, S1], dtbf [T, S2] in the type of
// xg (dsbf and dtbf written only when basis != 0); partial: [blocks,
// (S1 + S2) * C] scratch with blocks = triplet_product_blocks(E, K, C, S1,
// S2, bf16, 0);
// dw [(S1 + S2) * C] receives dws | dwt.
int triplet_product_bwd(const void* xg, const void* sbf, const void* tbf, const float* ws,
                        const float* wt, const void* mask, const float* ct, void* dxg, void* dsbf,
                        void* dtbf, float* partial, float* dw, int E, int K, int C, int S1, int S2,
                        int bf16, int basis, void* stream) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int blocks = 0, rc;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.dxg = static_cast<B*>(dxg); p.dsbf = static_cast<B*>(dsbf);
    p.dtbf = static_cast<B*>(dtbf); p.partial = partial;
    rc = bwd_c(p, basis, &blocks, true, strm);
  } else {
    auto p = make_params<float>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.dxg = static_cast<float*>(dxg); p.dsbf = static_cast<float*>(dsbf);
    p.dtbf = static_cast<float*>(dtbf); p.partial = partial;
    rc = bwd_c(p, basis, &blocks, true, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, (S1 + S2) * C, dw, strm);
}

// Second order. ct float32 [E, C]; u1 [T, C], u2 [T, S1], u3 [T, S2] in
// the type of xg and u4 [S1, C], u5 [S2, C] float32, each null when absent.
// xb [T, C], sb [T, S1], tb [T, S2] in the type of xg; ctb float32 [E, C];
// every element written. partial: [blocks, (S1 + S2) * C] with blocks =
// triplet_product_blocks(E, K, C, S1, S2, bf16, 1); dw receives wsb | wtb.
int triplet_product_bwd2(const void* xg, const void* sbf, const void* tbf, const float* ws,
                         const float* wt, const void* mask, const float* ct, const void* u1,
                         const void* u2, const void* u3, const float* u4, const float* u5,
                         void* xb, void* sb, void* tb, float* ctb, float* partial, float* dw,
                         int E, int K, int C, int S1, int S2, int bf16, void* stream) {
  if (bad_shape(E, K, C, S1, S2)) return ERR_SHAPE;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int blocks = 0, rc;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.u2 = static_cast<const B*>(u2);
    p.u3 = static_cast<const B*>(u3); p.u4 = u4; p.u5 = u5;
    p.dxg = static_cast<B*>(xb); p.dsbf = static_cast<B*>(sb); p.dtbf = static_cast<B*>(tb);
    p.ctb = ctb; p.partial = partial;
    rc = bwd2_c(p, &blocks, true, strm);
  } else {
    auto p = make_params<float>(xg, sbf, tbf, ws, wt, mask, E, K, C, S1, S2);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.u2 = static_cast<const float*>(u2);
    p.u3 = static_cast<const float*>(u3); p.u4 = u4; p.u5 = u5;
    p.dxg = static_cast<float*>(xb); p.dsbf = static_cast<float*>(sb);
    p.dtbf = static_cast<float*>(tb); p.ctb = ctb; p.partial = partial;
    rc = bwd2_c(p, &blocks, true, strm);
  }
  if (rc != 0) return rc;
  return sum_partials(partial, blocks, (S1 + S2) * C, dw, strm);
}

}  // extern "C"
