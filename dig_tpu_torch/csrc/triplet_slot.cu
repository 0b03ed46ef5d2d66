// Slot-resident fused triplet interaction (SphereNet / DimeNet++), forward,
// backward and second-order backward, for NVIDIA Hopper (sm_90a). Plain C
// interface, loaded through ctypes by dig_tpu_torch/ops/triplet_slot.py. The
// kernels are those of triplet_slot_core.cuh with the packed table as their
// row source (PtRows); csrc/triplet_slot_geom.cu runs the same kernels on
// rows evaluated from the geometry.
//
// Replaces the Pallas TPU kernels of dig_tpu/ops/pallas_triplet_slot.py:
// _run_fwd (pl.pallas_call at :429), _run_bwd (:458) and _run_bwd2 (:501).
//
//   out[e] = sum_s m2T[s,e] * x[(slot(e)*A + lj[e])*K + s] * sv * tv
//   sv = sbf[e,s] @ ws,  sbf[l*k+m] = bt[l*k+m] * y0[l]
//   tv = tbf[e,s] @ wt,  tbf[i]     = yt[i/k] * bt[i % nk]     (has_t only)
//   slot(e) = e / (A*K); bt, y0, yt = rows [0,nk), [nk,nk+n), [nk+n,R) of
//   pt[s, :, e]; nk = n*k, ntk = n*n*k, R = nk + n (+ n*n with has_t).
//
// What bounds it on this card. Per real triplet (m2T != 0) the forward
// costs 2 C (nk + ntk) flops for the two basis products plus a few C for
// the triple product. The bytes it must move are pt's column and the
// gathered x row of each real triplet, m2T and lj in full, and out. At the
// flagship shape (E = 44,544, K = 16, C = 64, n = 3, k = 6, bf16; 276,892
// real triplets gathering 23,217 distinct x rows in chip_smoke.py's batch)
// that is 2.62 GFLOP and 26.9 MB per layer, so the bytes bound it (0.0080
// ms at 3.35 TB/s against 0.0027 ms of bf16 tensor-core work;
// chip_smoke.py recounts both from its inputs). The backward recomputes sv
// and tv and adds the weight-gradient products: 5.25 GFLOP and 29.9 MB
// (the cotangent rows of the edges that own a real triplet in, dx out),
// 0.0089 ms, still bound by the bytes; pt's gradient, when asked for, adds
// 2.6 GFLOP and writes all of dpt (42.8 MB): 72.6 MB, 0.0217 ms. Every
// byte count takes each tensor in the type the function takes or returns
// (bf16 here), as the Pallas calls declare them; the kernels' float32
// outputs, which the wrapper casts back, are this port's staging, not work
// the function needs.
//
// The second-order backward takes the cotangents (u1, u2, u4, u5) of
// (dx, dpt, dws, dwt) as a tangent (dx, dpt, dws, dwt) of the forward and
// returns the gradients (xb, ptb, wsb, wtb, ctb) of <u, backward> with
// respect to (x, pt, ws, wt, ct). Per real triplet, with g = x[row],
// a = sbf, b = tbf, dg = u1[row], da/db the product-rule tangents of
// sbf/tbf from u2, dsv = da@ws + a@u4, dtv = db@wt + b@u5, go = ct[e]*m:
//   ctb[e]   = sum_s m (dg sv tv + g dsv tv + g sv dtv)     (the JVP)
//   xb[row] += go (dsv tv + sv dtv)
//   wsb     += a (x) go (dg tv + g dtv) + da (x) go g tv,   wtb likewise
//   ptb      = the product rule of sbf/tbf applied to the basis cotangents
//              (P @ w^T + Q @ u4^T through pt, Q @ w^T through u2).
// Per real triplet that is about 12 C (nk + ntk) flops (the four basis
// products sv, tv, dsv, dtv, the weight-gradient products and the basis
// cotangents); its bytes are pt's and u2's columns and the x, u1 rows of
// each real triplet, the ct rows of the edges that own one, and xb, ctb
// ([E, C]) and all of ptb ([K, R, E]) out, in the operands' types. One
// layer of the force bench's batch (buckets of 16, 24 and 29 atoms,
// E = 35,488 in all, 297,624 real triplets, bf16) needs 17.0 GFLOP
// (0.017 ms at the bf16 tensor-core peak) and 89.6 MB (0.027 ms at
// 3.35 TB/s): the bytes bound it (chip_smoke.py counts both from its
// inputs).
//
// What the design does about it:
//  - The expand gather x[sender, s] happens in the kernel: nothing of size
//    [T, C] (T = E*K triplets) exists in device memory, only E-sized x and
//    out and the [K, R, E] basis table, each read once per pass.
//  - Triplets with m2T = 0 (padding, k == i, slots beyond the degree)
//    contribute exactly zero to every output and are skipped (warp-uniform
//    branch: a warp shares one edge).
//  - Forward: a block owns 32 consecutive edges. It lists their real
//    triplets s-major, a ballot per s (57-60% of the triplets are masked
//    at the force bench's buckets), and walks the list 32 triplets at a
//    time: the rows, sbf and tbf (by rows, [NB][32]) and the products only
//    where they count, the products as register tiles (each weight loaded
//    once for a thread's 8 triplets at C = 64, their basis values 16 bytes
//    at a time). The thread owning an (edge, channel) adds its edge's terms
//    in list order, which is s order: the sums, and so the bits, of the
//    first design, which walked every s of the 32 edges with three
//    barriers an s and formed the rows and the basis of masked triplets
//    too, its products a serial chain with a shared load per operand.
//  - Backward: a block owns one (slot, s). It first lists the edges of its
//    real triplets by warp ballots (about 40% at the force bench's
//    buckets; dpt is written as 0 at the others) and walks only those, 32
//    at a time (slot_bwd_kernel in triplet_slot_core.cuh). The dx rows
//    (j, s) of the slot receive only from the slot's edges, so the block
//    sums them in shared memory in edge order (each thread owns a set of
//    rows and walks only the chunk's edges of its rows, from a ballot per
//    row group): no atomics. dws/dwt are per-block shared-memory sums
//    (each entry owned by one thread, 18 rows in registers at a time),
//    written to a [blocks, ...] scratch and summed by a second kernel in a
//    fixed tree order: two backwards give the same bits. sv, tv and the
//    basis cotangents are register tiles (each weight loaded once for a
//    thread's edges). dpt is row-local and only computed when asked for,
//    which ops/triplet_slot.py does only when the pass running reads it.
//    ptxas (sm_90a): 105-114 registers a thread at C = 64 and 128, 126-128
//    at C = 32: two blocks of 256 threads an SM.
//  - Second order: two kernels. ctb sums over s, so it is a "tangent
//    forward" in the forward's layout (32 edges a block, s in a loop, f32
//    registers). xb, ptb, wsb and wtb take the backward's layout (a block
//    per (slot, s), xb rows summed in shared memory, ptb row-local,
//    wsb/wtb per-block partials summed in a fixed order): no atomics, so
//    two runs give the same bits. Every element of xb and ptb is written,
//    zeros included. A None cotangent is a null pointer and its terms are
//    skipped.
//  - The second order's block first lists the edges of its real triplets
//    (about 40% at the force bench's buckets) and walks only those, 32 at
//    a time, so no chunk phase runs for a masked triplet; the products,
//    the weight cotangents and the (a | b) cotangents keep register tiles
//    (see slot_bwd2_kernel). Every sum keeps its order over the real
//    edges, so the outputs are the bits of the masked walk.
//  - Products run on the FP32 pipes. In bf16 the operands the TPU kernel
//    rounds (sbf, tbf, the gathered x) are bf16 values; bf16 x bf16 is exact
//    in f32 and sums are f32 (the TPU kernel sums over s in bf16; here out
//    is rounded once). Tangents (u1, u2 and the da, db formed from them)
//    are not rounded. wgmma for the basis products is later work.
#include "triplet_slot_core.cuh"

extern "C" {

// 0 on success, a cudaError_t, or ERR_SHAPE / ERR_SMEM. x, pt, m2T and out
// are bf16 when bf16 != 0, float32 otherwise.
int triplet_slot_fwd(const void* x, const void* pt, const void* m2T, const float* ws,
                     const float* wt, const int* lj, void* out, int E, int A, int K, int n,
                     int k, int has_t, int C, int bf16, void* stream) {
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.pt = static_cast<const __nv_bfloat16*>(pt);
    p.out = static_cast<__nv_bfloat16*>(out);
    return fwd_c<PtRows>(p, C, strm);
  }
  auto p = make_params<float>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
  p.pt = static_cast<const float*>(pt);
  p.out = static_cast<float*>(out);
  return fwd_c<PtRows>(p, C, strm);
}

// ct, dx, dpt float32; dpt may be null when need_dpt == 0. partial:
// [blocks, (nk+ntk)*C] scratch, blocks = (E / (A*K)) * K; dw: [(nk+ntk)*C]
// receives dws | dwt.
int triplet_slot_bwd(const void* x, const void* pt, const void* m2T, const float* ws,
                     const float* wt, const int* lj, const float* ct, float* dx, float* dpt,
                     float* partial, float* dw, int E, int A, int K, int n, int k, int has_t,
                     int C, int bf16, int need_dpt, int blocks, void* stream) {
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int rc;
  if (bf16) {
    auto p = make_params<__nv_bfloat16>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.pt = static_cast<const __nv_bfloat16*>(pt);
    p.ct = ct; p.dx = dx; p.dpt = dpt; p.partial = partial;
    rc = bwd_c<PtRows>(p, C, need_dpt, blocks, strm);
  } else {
    auto p = make_params<float>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.pt = static_cast<const float*>(pt);
    p.ct = ct; p.dx = dx; p.dpt = dpt; p.partial = partial;
    rc = bwd_c<PtRows>(p, C, need_dpt, blocks, strm);
  }
  if (rc != 0) return rc;
  const int size = (n * k + (has_t ? n * n * k : 0)) * C;
  return sum_partials(partial, blocks, size, dw, strm);
}

// Second order. ct float32; u1 / u2 in the type of x and pt, u4 / u5
// float32, each null when absent. xb, ptb, ctb float32 (every element
// written); partial and dw as for the backward (dw receives wsb | wtb).
int triplet_slot_bwd2(const void* x, const void* pt, const void* m2T, const float* ws,
                      const float* wt, const int* lj, const float* ct, const void* u1,
                      const void* u2, const float* u4, const float* u5, float* xb, float* ptb,
                      float* partial, float* dw, float* ctb, int E, int A, int K, int n, int k,
                      int has_t, int C, int bf16, int blocks, void* stream) {
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  int rc;
  if (bf16) {
    using B = __nv_bfloat16;
    auto p = make_params<B>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.pt = static_cast<const B*>(pt);
    p.ct = ct; p.u1 = static_cast<const B*>(u1); p.u2 = static_cast<const B*>(u2);
    p.u4 = u4; p.u5 = u5; p.dx = xb; p.dpt = ptb; p.ctb = ctb; p.partial = partial;
    rc = bwd2_c<PtRows>(p, C, blocks, strm);
  } else {
    auto p = make_params<float>(x, m2T, ws, wt, lj, E, A, K, n, k, has_t);
    p.pt = static_cast<const float*>(pt);
    p.ct = ct; p.u1 = static_cast<const float*>(u1); p.u2 = static_cast<const float*>(u2);
    p.u4 = u4; p.u5 = u5; p.dx = xb; p.dpt = ptb; p.ctb = ctb; p.partial = partial;
    rc = bwd2_c<PtRows>(p, C, blocks, strm);
  }
  if (rc != 0) return rc;
  const int size = (n * k + (has_t ? n * n * k : 0)) * C;
  return sum_partials(partial, blocks, size, dw, strm);
}

}  // extern "C"
