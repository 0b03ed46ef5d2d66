#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dig_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. card: name, count, power limit (nvidia-smi)
  2. build: nvcc builds csrc/cfconv.cu, csrc/triplet_slot.cu,
     csrc/segment_csr.cu, csrc/triplet_product.cu, csrc/triplet_pt.cu and
     csrc/triplet_slot_geom.cu (with and without torsion, each with its
     generated basis-row header) for sm_90a, all at once; the -Xptxas -v
     reports
  3. kernel vs plain: cfconv forward and all six gradients against the plain
     PyTorch version on the card, at the SchNetDense bucket shapes, in f32
     and bf16, need_dist_grad on and off; repeated backwards bitwise equal
  4. main path 1: SchNetDense (4 x 128, bf16, fused cfconv) takes Adam steps
     on size-bucketed dense batches through make_dense_step_fns; the launch
     counters must show every cfconv call went through the kernels; the
     first step's loss and gradients are held against the plain branch;
     one eval pass through ThreeDEvaluator
  5. times: step ms and edges/s; per-bucket kernel ms beside the bound and
     the plain version's ms
  6. kernel vs plain: fused_triplet_slot forward and its four gradients
     against the plain version at the flagship SphereNet shapes (pt from a
     real batch), has_t on and off, f32 and bf16, dpt asked for and not;
     repeated backwards bitwise equal
  7. main path 2: SphereNet (bench.py bench_spherenet: 4 x 128, n=3, k=6,
     K=16, slots of 29 atoms, bf16, slot kernel) takes Adam steps on
     MoleculeLoader batches through make_step_fns; 4 + 4 triplet_slot
     launches per step, and 6 segment-sum launches (the per-graph
     readouts, layers + 1, and the embedding gather's adjoint); the first
     step's loss and gradients are held
     against the unfused branch of the same weights; radius_blocked_dropped
     must be 0; one eval pass through ThreeDEvaluator
  8. times: step ms, edges/s; per-layer triplet_slot kernel ms beside the
     bound and the plain version's ms, the forward also beside the einsum
     over the gathered x rows and sbf, tbf assembled outside the timed
     call
  9. kernel vs plain: the second-order triplet_slot kernel (xb, ptb, wsb,
     wtb, ctb) against the plain double backward at the three bucket shapes
     of the force bench (pt of a real batch), has_t on and off, f32 and
     bf16, u4 = u5 absent as in force training and once all present;
     repeated calls bitwise equal
 10. main path 3: SphereNet energy+force training (bench.py
     bench_spherenet_force: 4 x 128, n=3, k=6, K=16, bf16, slot kernel,
     BucketedMoleculeLoader slots {16: 27, 24: 43, 29: 26}, loss
     |E-y| + 100 |F_pred-F| per real graph, Adam) through
     make_bucketed_step_fns; per step 12 forward, 24 backward (12 with
     dpt: the inner create_graph pass; the outer pass needs none) and 12
     second-order triplet_slot launches and 18 segment sums (readouts and
     embedding gathers); the first step's loss and
     gradients held against the unfused branch (f32), and the bf16
     gradient against the f32 one by cosine and per-parameter norm;
     finite forces;
     radius_blocked_dropped must be 0; then one short
     Run3D(energy_and_force=True, slot_size=29) epoch
 11. times: force step ms, edges/s; per-layer, per-bucket second-order
     kernel ms beside its bound and the plain version's ms, split by
     kernel (slot_jvp_kernel, slot_bwd2_kernel, sum_partials_kernel;
     torch.profiler); the backward at each bucket with dpt and without
 12. kernel vs plain: the sorted-CSR segment sum at the two flat paths'
     shapes (receivers of real batches), f32 and bf16; at the main paths'
     other sums, their ids and row pointers made by the port's gather_rows
     and readout_sum on real batches: the adjoints of path 4a's sender
     gather (F = 128) and position gathers (F = 3; the flat edge list pads
     with node 0, so row 0 holds every padding edge) and its readout (F =
     1), path 4b's readout, sender and embedding gathers, path 3's readout
     and embedding gather and path 5a's embedding gather (bf16); and on a
     skewed random CSR; repeated calls bitwise equal; the closed autograd
     pair's gradients to second order against the plain version's
 13. main path 4a: flat SchNet energy+force training at the config of
     examples/threedgraph/run_morse_surrogate.py --model schnet --forces
     (4 x 128, 128 filters, 50 Gaussians, cutoff 5, max_edges 16384, f32,
     batches of 24 in slots of 29, Adam(1e-3), p = 100) with
     segment_eb=1024, through make_step_fns(energy_and_force=True); 18
     segment-sum launches per step (edge->node sums, the readout, the row
     gathers' adjoints); radius_overflow and csr_block_overflow
     0; finite forces; the first step's loss and gradients held against
     segment_eb=0 of the same weights; the segment sums a step counted by
     shape; then one short Run3D(energy_and_force=True, slot_size=29) epoch
 14. main path 4b: flat SphereNet energy training at the tutorial's widths
     (tutorials/threedgraph.md: 4 x 128, int_emb 64, basis 8/8/8, out_emb
     256, n=3, k=6, cutoff 5, f32) with max_edges 16384, max_in_degree 32,
     segment_eb=1024, MoleculeLoader batches of 32, Adam(5e-4); 13
     segment-sum launches per step; the same checks
 15. times: both flat steps in ms and edges/s; the segment-sum kernels per
     call at every shape of phase 12 (with its calls a step on paths 4a
     and 4b) beside the byte bound, the plain version and the PyTorch
     calls that compute the same sum; each flat step's segment sums in all
 16. kernel vs plain: fused_triplet_product (path 5a's widths) and
     fused_angle_product (path 5b's) with the bases, mask and raw triplet
     gather of a real batch, f32 and bf16: the forward, the backward with
     basis gradients on and off, the second order with u4 = u5 absent and
     all present; masked triplets' cotangent rows exactly 0; repeated calls
     bitwise equal
 17. main path 5a: SphereNet energy+force training on the unblocked NK
     layout (bench_spherenet_force's widths, nk_degree 16, block_size 0,
     pallas_triplet; MoleculeLoader batches of 96, Adam(5e-4), p = 100)
     through make_step_fns; per step 4 forward, 8 backward and 4
     second-order triplet_product launches (no triplet_pt launch) and 6
     segment sums (readouts, embedding gather); the first step held
     against the
     unfused branch (f32 1e-4 / 1e-3, bf16 by direction and size); finite
     forces; the uncapped pairs beside the kept NK edges
 18. main path 5b: DimeNet++ energy training (its published defaults, n=7,
     k=6) on the same layout, fused_angle_product without basis gradients;
     4 forward and 4 backward launches per step; the same checks without
     forces
 19. times: both steps in ms and edges/s; each triplet_product kernel per
     layer at both paths' shapes beside its bound and the plain version,
     the forward also beside the torch.einsum that computes it
 20. kernel vs plain: fused_triplet_pt at path 6a's shape (SphereNet's
     packed basis of a real batch, R = 30) and 6b's (DimeNet++'s, R = 49,
     no torsion), f32 and bf16: the forward, the backward with dpt asked
     for and not, the second order with u4 = u5 absent and all present;
     masked triplets' rows and columns exactly 0; repeated calls bitwise
     equal
 21. main path 6a: SphereNet energy+force on the unblocked NK layout with
     the packed basis (path 5a's widths and batches, pallas_triplet and
     pallas_fuse_basis: basis_pt once per forward, fused_triplet_pt in
     every layer) through make_step_fns; per step 4 forward, 8 backward (4
     with dpt: the inner create_graph pass) and 4 second-order triplet_pt
     launches, no triplet_product launch, 6 segment sums; the first step
     held against the unfused branch
     (f32 1e-4 / 1e-3, bf16 by direction and size); finite forces
 22. main path 6b: DimeNet++ at its published widths (n=7, k=6, out_emb
     256), energy+force on the same table through fused_triplet_pt without
     torsion; the same checks and launch counts
 23. repeatability: one step of paths 3, 4a and 6a from the same seeded
     state, each in two fresh processes (chip_smoke.py --repeat-step PATH
     OUT), gives the same bits for the loss and every parameter after Adam
 24. times: each triplet_pt kernel per layer at paths 6a's and 6b's
     shapes (the backward with dpt and without) beside its byte bound,
     the plain version and, for the
     forward, the einsum over sbf and tbf assembled outside the timed
     call; both steps in ms and edges/s
 25. kernel vs plain: fused_triplet_slot_geom (the basis rows evaluated in
     the kernel from theta, phi, d_kj / cutoff) at path 7a's shape, the
     geometry of a real batch, has_t on and off, f32 and bf16: the
     forward, the backward with dgeo and without, the second order with
     u1 = u4 = u5 absent and all present; dgeo and geob exactly 0 at masked
     triplets; repeated calls bitwise equal; the peak device memory of a
     forward and backward below the pt chain's
 26. main path 7a: the geometry op in energy+force training: path 2's
     batches with seeded forces, the port's SphereNet geometry, four
     layers of seeded leaves at the flagship slot width (x [E, 64], ws,
     wt), E_pred = sum of out . w_out, F = -dE_pred/dpos, loss |E_pred - y|
     + 100 mean|F - F_ref|^2, Adam on the leaves, bf16; exactly 4 forward,
     4 backward (all with dgeo: one first-order pass takes F and
     dE/dleaves) and 4 second-order geometry launches per step and no
     triplet_slot launch; the first f32 step held against the pt chain
     (basis_pt_k into the fused_triplet_slot kernels) and the plain
     geometry op, bf16 against f32 by direction and size; finite forces
 27. main path 7b: segment_sum_sorted_csr_chunked on bench.py
     bench_spmm_roofline's graph (synthetic_large_graph(60000, avg_deg
     16), F = 128, the planner's chunk table) and on phase 12's skewed CSR, f32
     and bf16: against its plain version and against the ported
     segment_sum_sorted_csr (the same bits), repeated calls the same bits,
     the VJP; spmm_csr on the same graph against its plain version; launch
     counts (launches_chunked counts calls: one per forward, each running
     the span pass and the row sums)
 28. times: the three geometry kernels per layer at path 7a's shape (the
     backward with dgeo and without) beside
     their bounds, plain versions and the pt chain through autograd (the
     forward also beside the einsum; the second order split by kernel,
     the split taken after phase 11's);
     path 7a's step; phase 11's triplet_slot second order at the three
     bucket shapes, split by kernel; the chunked sum (span pass and row
     sums) at path 7b's shape beside its bound, its plain version,
     the segment sum, torch.segment_reduce and index_add_
 29. main path 8a: ComENet energy+force at its published widths (4 x
     256, middle 64, n=2, k=3, cutoff 8) on the NK-blocked layout (K = 28
     keeps every pair of a 29-atom slot; radius_blocked_dropped 0),
     MoleculeLoader batches of 32 in slots of 29, f32, Adam(5e-4), loss
     |E - y| + 100 |F - F_ref| through make_step_fns; the first step held
     against the same step on the CPU (every op its plain version): loss
     1e-4, gradients 1e-3 (relative norm per parameter); the segment-sum
     launches a step (GraphNorm's statistics and readout, the row gathers'
     adjoints) the same every step and counted by shape; finite forces;
     one short Run3D(energy_and_force=True, slot_size=29) epoch
 30. main path 8b: ComENet-OCP at the same widths on synthetic crystals of
     20-80 atoms (cutoff 6, one shell of images), batches of 8; max_edges
     sized by pbc_overflow (0 dropped); the [N, N, 27] build's peak
     memory; the same checks
 31. main path 8c: ProNet all-atom at its published widths (4 x 128,
     mid_emb 64, cutoff 10) on the NK-blocked layout, K = 32, proteins of
     64-192 residues in batches of 16 in slots of 192, f32, energy
     training on the loader's y, deterministic; the same first-step check
     and launch count; the kept share of the in-cutoff pairs
 32. times: the segment sum at every call shape of paths 8a-8c (phase
     15's measurements), with its calls a step; each step's sums in all
 33. SchNetDense forces: path 1's model and buckets, F = -dE/dpos through
     the cfconv kernels (pos_grads=True: every backward with
     need_dist_grad) against the einsum branch of the same weights, f32
     1e-4 (relative norm), bf16 by direction and size against the f32
     einsum forces; the forward plus force pass timed; phase 5's backward
     with need_dist_grad beside it
 34. remat: path 3's force step on its 29-atom bucket with remat off and
     on, each in a fresh process (chip_smoke.py --remat-step 0|1
     bf16|f32 OUT) from the same seeded state, in bf16 and f32: the loss
     (within 1e-5), the gradients (f32 within 1e-5 per parameter; bf16
     against f32 by direction and size) and the parameters after Adam
     (whether the bits are the same is printed), and both peak memories
 35. main path 9: bench.py bench_lsgraph's partitioned GCN training
     (synthetic_large_graph(60000, avg_deg=16), generated once for paths
     7b and 9 and timed; 16 parts through the native partitioner, built
     with g++ at first use, which must be available; SubgraphLoader with
     4 parts a subgraph; ScalableGNN("gcn", N, 16, 128, 8, 3) with
     segment_eb sized from both row pointers, block_rows 64; cross-entropy
     over the in-batch rows, Adam(1e-3), the histories threaded through):
     the first step held against the same step on the CPU (loss 1e-5,
     every gradient and pushed history 1e-4); one warm and three timed
     epochs through spmm_bidir_csr (the sorted-CSR kernel forward by
     receiver and in the adjoint by sender: 24 launches an epoch, counted),
     ms an epoch, edges/s over the real edges, peak memory; the same
     epochs with SELL forced (no launch), timed beside them
 36. the segment sum at every call shape of a path-9 epoch (each
     subgraph's forward and adjoint tables, F = 128 and 8): kernel against
     plain (1e-5), then times as phase 15's, with the epoch's sums in all
 37. lsgraph at examples/lsgraph/run_graphfm.py's size (2,000 nodes, 16
     parts): mini_inference on the card (the kernel) against the CPU, and
     one GraphFM-IB step (sizes [3, 3], batch 64, hidden 64) against the
     CPU's
 38. main path 10: bench.py bench_ssl's GraphCL pretraining
     (synthetic_graph_dataset(512, seed=0), shuffled batches of 64: 1,024
     node rows, 11,008 edge slots; Encoder GIN 128 x 3, GraphCL dim 384,
     dropN / maskN at 0.2, f32, Adam(1e-3)): the first step on the card
     against the same step on the CPU (the same weights and batch, the
     views' noise drawn on the host; loss 1e-5, every gradient 1e-4) and
     repeated bit for bit; GraphCL.train for 1 + 3 epochs (graphs/s of the
     median warm epoch, the segment-sum launches a step: the neighbour
     sums by receiver, their adjoints by sender and the readouts, the
     same every epoch; peak memory); _embed_dataset on the card against
     the CPU's (1e-5)
 39. the segment sum at path 10's call shapes (the first batch's tables):
     kernel against plain, then times as phase 15's, with the calls a step
 40. path 10b, at the JAX tests' widths: one step each of InfoGraph (JSE
     local-global, GIN), MVGRL (GCN and DenseDiffusionEncoder over the PPR
     diffusion), GRACE and pGRACE (node level, one full batch) and
     GraphSemisupervised's finetune step (ResGCN), card against CPU
 41. path 11: auggraph: the first step of SMixup, RunnerRewardGen,
     RunnerGenerator and RunnerAugCls against the CPU's, then SMixup.train
     (1 epoch) and evaluate, and each runner for one epoch on the card
 42. main path 12: GraphDF at the published QM9 width (BASELINE.md row 13:
     max_size 20, edge_unroll 12: 162 edge steps, 182 masked views a
     molecule; 12 flow layers, 3 RGCN layers, nhid / nout 128, batch 32,
     Adam(1e-3), f32) on synthetic_smiles_dataset(max_size=20, repeat=8)
     (320 molecules, 10 steps an epoch): the first step on the card
     against the same step on the CPU from the same seeded weights: the
     discrete latents z exactly (a flipped straight-through argmax is
     reported with its logit margin), the loss 1e-6, every gradient 1e-4
     (relative norm), the batch norm's running statistics 1e-5; no kernel
     of the port's runs on this path (dense einsums)
 43. GraphDF.train_rand_gen on the card: a warm epoch, then 150 epochs
     (bench.py bench_ggraph_gen's count) timed: ms a step, peak memory
 44. run_rand_gen(n_mols=48, temperature=(0.35, 0.23), seed=1) from the
     trained weights on the card and on the CPU: the same canonical hashes
     in order and the same first-try flags (on a mismatch the two are run
     again in lockstep to name the flipped step and its margin); mols/s
     of the card's run after a warm run, validity and
     validity_no_resample as bench.py bench_ggraph_gen reports them, and
     the generated molecules' mean size beside the training molecules'
     (2-6 atoms: the synthetic set bounds them, not QM9's ~9)
 45. GraphAF at the same widths: the first step on the card against the
     CPU's from the same seeded weights and dequantisation noise (loss
     1e-5, gradients 1e-4), and run_rand_gen(8 molecules) from those
     weights on both: the same canonical hashes and first-try flags
 46. path 12b, at tests/test_ggraph.py's widths (hidden 24), card against
     CPU: a GraphAF step given its dequantization noise and its Gaussian
     generation of 8 molecules; a GraphEBM step given its noise and a
     30-step Langevin run (each step from the CPU's state, held in
     float64; float32's step error and the free runs' divergence printed);
     one PPOFineTuner step on GraphDF (the collated
     rollouts bit for bit, the PPO loss and gradients); a JTVAE step given
     its reparameterisation noise; a JTMPN assembly-scorer step, then
     train_assembler for one epoch on the card
 47. main path 13: xgraph at bench.py bench_xgraph's config
     (ba_2motifs(120, base_n=20), GCN_2l hidden 32): the first train step
     on the card against the CPU's (loss 1e-5, gradients 1e-4) and
     repeated bit for bit, and the same for run_benchmark.py's GIN_3l
     (hidden 64, sum readout); train_gnn(epochs=25) on the card (seconds,
     accuracy) and 1 + 20 timed train steps (ms a step, segment-sum
     launches a step); GNNExplainer(epochs=60, lr=0.05).explain_batch over
     graphs 1-32 after warm runs (explanations/s, the launches an epoch:
     every neighbour sum, readout and gather adjoint through the kernel),
     its 32 final edge and feature masks against the CPU's from the same
     weights and initial masks
 48. path 13b, from path 13's weights on one ba_2motifs graph, card
     against CPU: GradCAM, GNN-GI, DeepLIFT, FlowX and GNN-LRP scores, one
     PGExplainer step (its loss, weights and edge logits) and
     SubgraphX(rollout=5, min_atoms=3, sample_num=8)'s coalition
 49. main path 14: G-SphereNet at bench.py bench_ggraph3d_gen's config
     (QM93DGEN(num_steps_per_batch=16) on its synthetic molecules,
     GSphereNet(4, hidden=64, num_flow_layers=4), Adam(1e-3)): no radius
     edge dropped in any batch; the first step on the card against the
     CPU's from the same weights and dequantisation noise (loss 1e-5,
     gradients 1e-4), repeated bit for bit; GSphereNet.train for 4 epochs
     (ms a step, the loss history, 7 segment-sum launches a step: 3 edge
     sums, 3 sender-gather adjoints, the type embedding's gather adjoint);
     one encoder pass (3 launches); generate(256 molecules, max_atoms=9,
     seed=1) after a warm run (mols/s, atoms a molecule,
     RandGenEvaluator3D validity); a batch of 32 from the trained weights
     and the same draws on the card and the CPU: the types and atom
     counts exactly, positions 1e-4 of the largest coordinate, no radius
     edge dropped; then scripts/profile_torch_step.py's traces of its
     gspherenet and gspherenet_gen cases (busy ms, idle share, launches of
     a step and of a generation batch), one after the other
 50. the segment sum at the call shapes of paths 13 and 14: kernel
     against plain (1e-5), then times as phase 15's, with the calls a step
 51. main path 15: fairgraph's Graphair at run()'s widths (hidden 64,
     alpha 20, beta 0.9, gamma 0.7, lam 1) on synthetic_fair_graph(8192,
     avg_deg=16, seed=0) (POKEC's graphs do not fit the dense [N, N]
     layout): the first warm, adversary and main steps against the same
     steps on the CPU from the same weights and host-drawn uniforms (loss
     1e-4, gradients 1e-3; the edge samples' flips counted); fit_whole for
     about 25 s of epochs (ms an epoch, peak memory) and test() (accuracy,
     DP, EO); no kernel of the port's (dense products)
 52. main path 16: the parallel package at world size 1 in an NCCL group on
     a local file store: collective_selfcheck on a (1, 1) mesh; a DP step
     of the flat SchNet at tests/test_parallel.py's widths against
     make_step_fns on the CPU; the GP engine with GPGCN2 and GPPNA (hidden
     128, 3 layers) on synthetic_large_graph(60000, avg_deg=16) in one part
     and GPSchNet (3 x 64, 25 Gaussians) on 8,192 atoms, each first step
     against the CPU's (loss 1e-4, gradients 1e-3), then 8 Adam steps (ms
     a step, segment-sum launches a step: 2 a layer for GPGCN2 and
     GPSchNet, 3 a layer less one for GPPNA); TP on a (1, 1) mesh, PP with
     one stage and EP with all 16 experts on the rank against their plain
     results (1e-5); scripts/profile_torch_step.py's gp and graphair traces
 53. path 17: the train utilities on the card: StepProfiler over flat
     SchNet steps (the trace names segment_csr_row_kernel; busy and idle
     inside its train spans), debug_mode raising on a NaN in the segment
     sum's input at the first read of the kernel's output and silent on a
     clean step, assert_donation_discipline, Run3D(debug=True,
     profile_dir=...) for one epoch
 54. the segment sum at the call shapes of path 16's GP steps: kernel
     against plain (1e-5), then times as phase 15's, with the calls a step
The card's name and power limit (nvidia-smi), then the kernels as JSON,
are the two lines before the last; the last line is
{"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

CUTOFF, LAYERS, HIDDEN, GAUSSIANS = 5.0, 4, 128, 50
SLOT_COUNTS = {16: 252, 24: 380, 32: 236}
STEPS, WARMUP = 10, 3
# kernel vs plain: largest error over the largest reference value, per
# tensor. f32: sums in another order. bf16: operands on a rounding tie may
# round apart.
TOL = {"f32": 1e-4, "bf16": 2e-2}
# first training step, kernel branch vs the plain (einsum) branch of the
# same weights; loss: relative error, gradients: ||a-b|| / ||b|| per
# parameter. f32: sums in another order. bf16: the plain branch rounds every
# intermediate (the [G,n,n,F] filter, each einsum) to bf16 where the kernel
# keeps f32, so the two drift apart by bf16 rounding through 4 layers.
STEP_TOL = {"f32": (1e-4, 1e-3), "bf16": (5e-2, 2.5e-1)}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA
# pipes, HBM3. The special-function units give 16 results per clock per SM
# (NVIDIA's CUDA documentation, arithmetic instruction throughput,
# compute capability 9.0).
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
SFU_PER_SM_CLK = 16

# SphereNet energy training on the slot layout: bench.py:101-184
# (bench_spherenet), batches of 96 molecules in slots of 29 atoms
SN_KW = dict(cutoff=5.0, num_layers=4, hidden_channels=128, num_spherical=3,
             num_radial=6, nk_degree=16, block_size=29)
SN_SLOT = dict(pallas_triplet=True, pallas_fuse_basis=True, pallas_slot=True)
SN_G, SN_STEPS, SN_WARMUP = 96, 10, 3
SN_C = 64                                  # int_emb_size: the kernel's C
# kernel vs plain, largest error over the largest reference value per
# tensor. f32: sums in another order. bf16: both round the same operands
# (sbf, tbf, the gathered x) to bf16 and sum in f32, then round the output
# and the gradients to bf16 once, so a sum in another order may land one
# bf16 step (2^-8 of the value) away.
SN_TOL = {"f32": 1e-4, "bf16": 1e-2}
# first SphereNet step, slot kernel vs the unfused branch of the same
# weights: loss relative error, gradients ||a-b|| / ||b|| per parameter.
# f32: sums in another order. bf16: the unfused branch rounds the [T, C]
# basis projections, the per-triplet products and the sum over triplets to
# bf16 where the kernel keeps f32, and that drifts through 4 layers (the
# bounds are PR 1's for the same kind of comparison).
SN_STEP_TOL = {"f32": (1e-4, 1e-3), "bf16": (5e-2, 2.5e-1)}

# SphereNet energy+force training on slot-bucketed batches: bench.py:187-290
# (bench_spherenet_force), the model of SN_KW applied per bucket at the
# bucket's slot size; forces drawn from default_rng(0) as bench.py does
SF_SLOTS = {16: 27, 24: 43, 29: 26}
SF_STEPS, SF_WARMUP, SF_P = 8, 3, 100.0
SF_BENCH_STEPS = 10          # bench.py's molecule count: G * (10 + 4)
# second-order kernel vs plain, largest error over the largest reference
# value per output. Its outputs are float32 in both types and both sides
# use the same (bf16) operands, so only the order of the f32 sums differs.
BWD2_TOL = 1e-4
# first force step, slot kernel vs the unfused branch of the same weights:
# loss relative error, and gradients as ||a-b|| / ||b|| over all parameters
# at once (the worst single parameter is printed). f32: sums in another
# order through two derivative levels; the whole gradient and each
# parameter are held to 1e-3, the loss to 1e-4. bf16: each branch rounds
# at other places (the unfused one the [T, C] basis projections, the
# per-triplet products and their sums, the slot kernels only their
# operands) at the forward and at both backward levels, and the force
# loss (p = 100) sums the second derivatives of the energy over every
# atom, where that rounding does not cancel: at the random initial
# weights each bf16 branch's whole gradient lies 0.7-1.1 (relative norm)
# from the f32 gradient, and the JAX package's bf16 branches drift as far
# on the same inputs (tests/test_torch_force.py holds the port's drift to
# the JAX package's), so the two bf16 branches are not held to each other
# by distance. The bf16 loss is held to 5e-2 of the unfused branch's, and
# the slot branch's gradient to the f32 gradient by direction and size:
# its whole cosine at least 0.5 and its median per-parameter cosine at
# least 0.7 (SF_BF16_COS), and every parameter's gradient norm 0.5-5
# times the f32 one's (SF_BF16_NORM). A zero gradient (cosine 0) or a
# parameter whose gradient is dropped (norm ratio 0) fails. The limits sit
# below and above the card's readings (cosines 0.65 and 0.86 for the slot
# branch, 0.80 and 0.94 for the unfused one; per-parameter norm ratios
# 0.82-3.58 and 0.88-1.52).
SF_STEP_TOL = {"f32": (1e-4, 1e-3), "bf16": (5e-2, None)}
SF_BF16_COS = (0.5, 0.7)
SF_BF16_NORM = (0.5, 5.0)

# Flat SchNet energy+force training (path 4a):
# examples/threedgraph/run_morse_surrogate.py --model schnet --forces, which
# calls Run3D(batch_size=24, lr=1e-3, p=100, slot_size=29), with the
# sorted-CSR aggregation switched on (segment_eb=1024: the densest 32
# receiver rows of this data hold at most 716 edges, plus 127 of slack)
FS_KW = dict(cutoff=5.0, num_layers=4, hidden_channels=128, num_filters=128,
             num_gaussians=50, max_edges=16384, segment_eb=1024)
FS_G, FS_SLOT, FS_LR, FS_P = 24, 29, 1e-3, 100.0
FS_STEPS, FS_WARMUP = 10, 3
# Flat SphereNet energy training (path 4b): tutorials/threedgraph.md:18-27
# widths, batches of 32 molecules (n_node_pad 32 x 29 = 928)
SP_KW = dict(cutoff=5.0, num_layers=4, hidden_channels=128, int_emb_size=64,
             basis_emb_size_dist=8, basis_emb_size_angle=8,
             basis_emb_size_torsion=8, out_emb_channels=256,
             num_spherical=3, num_radial=6, max_edges=16384,
             max_in_degree=32, segment_eb=1024)
SP_G, SP_LR, SP_STEPS, SP_WARMUP = 32, 5e-4, 8, 3
# segment sum, kernel vs plain: largest error over the largest reference
# value. Both sum the same values (bf16 data read as bf16 by both) in
# float32; only the order differs (edge order against index_add_'s atomics).
SEG_TOL = 1e-5
# the closed pair's second derivative: products of two such sums
SEG_TOL2 = 1e-4
# first step of either flat path, segment_eb=1024 against segment_eb=0 of
# the same weights: both float32, the two branches differ only in the
# order of the edge->node sums (the kernel's edge order against
# index_add_'s atomics), a few float32 roundings per sum carried through
# 4 layers and, for forces, two derivative levels. Loss: relative error;
# gradients: ||a-b|| / ||b|| for every parameter.
FLAT_STEP_TOL = (1e-5, 1e-4)

# SphereNet energy+force on the unblocked NK layout (path 5a): the widths
# of bench.py bench_spherenet_force (:224-228) with the [N, N] top-k table
# (nk_degree 16, block_size 0) and the fused triplet product
# (pallas_triplet, basis gradients on); MoleculeLoader batches of 96
# molecules at the default pad (96 x 29 = 2,784 node rows, so E = 44,544
# edge rows and T = 712,704 triplet rows), make_step_fns(energy_and_force,
# p = 100), Adam(5e-4), bf16
NK_KW = dict(cutoff=5.0, num_layers=4, hidden_channels=128, num_spherical=3,
             num_radial=6, nk_degree=16, block_size=0)
# DimeNet++ energy training (path 5b): DimeNetPP's defaults, DIG's
# dimenetpp.py:88-93 and the published DimeNet++ (4 x 128, int_emb 64, basis
# 8, out_emb 256, n = 7, k = 6, cutoff 5), on the same table, without basis
# cotangents (the round-2 ladder's energy-only configuration)
DP_KW = dict(nk_degree=16, block_size=0, pallas_basis_grads=False)
NK_G, NK_P, NK_LR, NK_STEPS, NK_WARMUP = 96, 100.0, 5e-4, 6, 2
NK_C = 64                                  # int_emb_size: the kernels' C
# kernel vs plain, largest error over the largest reference value per
# tensor. f32: sums in another order. bf16: both compute in float32 from
# the same bf16 operands and round each output once, so a sum in another
# order may land one bf16 step (2^-8 of the value) away. The float32
# outputs of the second-order kernel (wsb, wtb, ctb) are held to the f32
# bound in both types.
NK_TOL = {"f32": 1e-4, "bf16": 1e-2}

# SphereNet (path 6a) and DimeNet++ (path 6b) energy+force on the same
# unblocked table with the packed basis: pallas_triplet and
# pallas_fuse_basis without the slot kernel, so basis_pt builds the [R, T]
# table once per forward and every layer runs fused_triplet_pt (the round-3
# force ladder's "packed transposed basis" rung, docs/performance.md:102).
# 6a at path 5a's widths; 6b at DimeNetPP's published defaults (n = 7,
# k = 6, out_emb 256), with basis gradients for the force loss. The same
# batches, Adam(5e-4), p = 100, bf16.
PT_PATHS = ("6a", "6b")
DP6_KW = dict(nk_degree=16, block_size=0)
# first force step of path 6b, kernel branch vs the unfused one: the f32
# force loss of DimeNet++ at n = 7 is ill-conditioned, so its loss bound
# holds the energy term and the force term gets a bound of its own (the
# third entry). The spherical Bessel closed forms up to l = 6 cancel
# catastrophically at short k-j distances (x = d_kj / cutoff down to 0.06
# in this data) and the forces are their derivatives: on the CPU the
# unfused branch's own f32 force term moves by 1.2e-4 when only the thread
# count (the order of its matmul sums) changes, on 8 molecules, while its
# energy term moves by 4e-6 (scripts/force_conditioning.py). Energy term
# 1e-4 and every parameter's gradient 1e-3 as on the other force paths;
# the force term 1e-2, which a dropped or wrong position path (an O(1)
# change) fails.
DP6_STEP_TOL = {"f32": (1e-4, 1e-3, 1e-2), "bf16": (5e-2, None)}

# Path 7a: fused_triplet_slot_geom (the basis evaluated in the kernel) in
# force training at the flagship slot layer's width: path 2's batches (96
# molecules in slots of 29, K = 16, n = 3, k = 6, torsion) with seeded
# forces, the geometry of the port's SphereNet, four layers of seeded leaves
# x [E, 64], ws [18, 64], wt [54, 64]; loss |E - y| + 100 mean|F - F_ref|^2,
# Adam(5e-4) on the leaves, bf16.
GA_STEPS, GA_WARMUP, GA_P, GA_LR = 5, 2, 100.0, 5e-4
# kernel vs plain, largest error over the largest reference value per
# tensor: (forward and backward, second order). f32: sums in another order;
# the rows are the float32 roundings of the same float64 closed forms on
# both sides. bf16: one bf16 step (2^-8) where a sum in another order or a
# row one float32 step apart rounds an operand the other way.
GA_TOL = {"f32": (1e-5, 1e-4), "bf16": (1e-2, 1e-2)}
# first f32 step through the geometry kernels against the pt chain and the
# plain geometry op of the same leaves: loss, first-order pieces (F and
# dE/dleaves) and every leaf's gradient, each relative to its largest value
# (the bounds of tests/test_pallas_triplet_slot.py:172-190)
GA_STEP_TOL = (1e-4, 2e-4, 1e-3)
# FP64 peak of one H100 SXM outside the tensor cores (NVIDIA data sheet)
PEAK_FP64 = 34e12
# Paths 8a-8c. ComENet's published defaults (dig_tpu/models/comenet.py:
# 155-162: cutoff 8, 4 layers, 256 hidden, 64 middle, 3 radial, 2
# spherical, 3 output layers) on the NK-blocked layout; K = 28 keeps every
# pair of a 29-atom slot. ComENet-OCP at the same widths, cutoff 6, one
# shell of images (tests/test_pbc.py:107). ProNet's published defaults
# (dig_tpu/models/pronet.py:126-138), all-atom, K = 32 in slots of 192
# residues. Each first step is held against the same step on the CPU.
CE_KW = dict(cutoff=8.0, num_layers=4, hidden_channels=256,
             middle_channels=64, num_radial=3, num_spherical=2,
             num_output_layers=3, nk_degree=28, block_size=29)
CE_A, CE_G, CE_LR, CE_P, CE_STEPS, CE_WARMUP = 29, 32, 5e-4, 100.0, 6, 2
OCP_KW = dict(cutoff=6.0, num_layers=4, hidden_channels=256,
              middle_channels=64, num_radial=3, num_spherical=2,
              num_output_layers=3, pbc_images=1)
OCP_G, OCP_ATOMS, OCP_STEPS = 8, (20, 80), 6
PN_KW = dict(level="allatom", num_blocks=4, hidden_channels=128, mid_emb=64,
             cutoff=10.0, max_num_neighbors=32, nk_degree=32,
             block_size=192)
PN_G, PN_RES, PN_LR, PN_STEPS, PN_WARMUP = 16, (64, 192), 5e-4, 6, 2
CPU_STEP_TOL = (1e-4, 1e-3)
# SchNetDense forces through the kernels against the einsum branch (f32);
# remat against no remat (one step, parameters after Adam)
DENSE_F_TOL = 1e-4
REMAT_TOL = 1e-5
# Path 7b: the chunked sorted-CSR sum on bench.py bench_spmm_roofline's
# graph (:560-571): synthetic_large_graph(60000, seed=0, avg_deg=16), F =
# 128. Against segment_sum_sorted_csr over a full window: the same bits
# (both add each row's edges in edge order). Against the plain version,
# whose index_add_ adds with atomics in another order: 1e-6 of the largest
# value on the bench graph (at most 38 edges a row), SEG_TOL (phase 12's bound)
# on the skewed CSR, whose largest row sums 5,000 edges.
CS_N, CS_F, CS_TOL = 60000, 128, 1e-6
_T0 = time.perf_counter()
# Path 9: bench.py bench_lsgraph's partitioned GCN training epoch
# (:372-443): the same graph in 16 parts through the native partitioner, 4
# parts a subgraph (4 subgraphs of about 15,000 in-batch nodes and 240,000
# edges), ScalableGNN("gcn", N, 16, 128, 8, 3) with segment_eb sized from
# both row pointers (block_rows 64), cross-entropy over the in-batch rows,
# Adam(1e-3), the histories threaded through; the features and labels in
# the loader's node order (bench.py gathers them by the permuted ids from
# the original order). The first step on the card against the same step
# on the CPU (every op its plain version; f32, TF32 off): the loss within
# 1e-5 (relative), every gradient and pushed history within 1e-4 (relative
# norm): the same values summed in other orders through three layers,
# forward and adjoint.
LS_PARTS, LS_BATCH_PARTS, LS_BR = 16, 4, 64
LS_HIDDEN, LS_OUT, LS_LAYERS, LS_LR, LS_EPOCHS = 128, 8, 3, 1e-3, 3
LS_STEP_TOL = (1e-5, 1e-4)
# examples/lsgraph/run_graphfm.py's graph for mini_inference and GraphFM-IB
LS_SMALL_N = 2000
# Path 10: bench.py bench_ssl (:611-641), uncut: GraphCL (dim 384, dropN and
# maskN views at 0.2, NT-Xent) over a 3-layer GIN of width 128 on
# synthetic_graph_dataset(512, seed=0) in shuffled batches of 64 (1,024
# node rows, 11,008 edge slots), Adam(1e-3), 1 warm + 3 timed epochs. The
# first step on the card against the same step on the CPU (the same
# weights, batch and view noise drawn on the host; f32, TF32 off): the
# loss within 1e-5 (relative), every gradient within 1e-4 (relative
# norm): the same values summed in other orders through three layers,
# forward and adjoint. _embed_dataset on the card against the CPU's 1e-5.
SSL_N, SSL_BS, SSL_EPOCHS, SSL_LR = 512, 64, 3, 1e-3
SSL_ENC = dict(feat_dim=8, hidden_dim=128, n_layers=3, gnn="gin")
SSL_GCL = dict(dim=384, aug_1="dropN", aug_2="maskN", aug_ratio=0.2)
SSL_STEP_TOL, SSL_EMBED_TOL = (1e-5, 1e-4), 1e-5
# Paths 10b and 11 at the JAX tests' widths (tests/test_ssl.py,
# tests/test_modules_misc.py): hidden 16; auggraph on 32 graphs in batches
# of 8; the same first-step bounds
AUG_N, AUG_BS, AUG_H = 32, 8, 16
# Path 12: GraphDF at the published QM9 config (BASELINE.md row 13,
# examples/ggraph/GraphDF/config/rand_gen_qm9_config_dict.json:9-29) on
# synthetic_smiles_dataset(max_size=20, repeat=8), the real QM9 CSV not
# being in the repository; bench.py bench_ggraph_gen's 48 molecules. The
# first step's z are one-hot argmaxes and must agree exactly; the loss
# then differs only in the order of its sums (1e-6, relative); the
# gradients pass the straight-through softmax at temperature 0.1 through
# 12 flow layers (1e-4, relative norm); the running statistics 1e-5.
GG_CONF = dict(max_size=20, edge_unroll=12, node_dim=4, bond_dim=4,
               num_flow_layer=12, num_rgcn_layer=3, nhid=128, nout=128)
# The generation weights are trained as long as bench_ggraph_gen trains
# (150 epochs); the synthetic molecules have 2-6 atoms (4.0 on average),
# which bounds the generated ones. GraphAF at the same widths: its first
# step (continuous flow, no argmax) 1e-5 loss and 1e-4 gradients, as
# path 12b, and 8 molecules from its seeded weights.
GG_BS, GG_LR, GG_EPOCHS, GG_REPEAT = 32, 1e-3, 150, 8
GG_GEN = dict(n_mols=48, temperature=(0.35, 0.23), seed=1)
GG_LOSS_TOL, GG_GRAD_TOL, GG_STATS_TOL = 1e-6, 1e-4, 1e-5
GG_AF_TOL, GG_AF_GEN = (1e-5, 1e-4), dict(n_mols=8, temperature=0.75, seed=2)
# Path 12b at tests/test_ggraph.py's widths (:58-61): first-step bounds
# as path 10b's; each Langevin step from the same state in float64 1e-9
# of its largest value (float32's rounding, which the step size of 30
# magnifies, is printed beside it)
GG_TINY = dict(max_size=9, edge_unroll=4, node_dim=4, bond_dim=4,
               num_flow_layer=2, num_rgcn_layer=2, nhid=24, nout=24)
GG_SMALL_TOL, GG_LANGEVIN_TOL = (1e-5, 1e-4), 1e-9
GG_SMILES = ["CCO", "CCN", "CCC", "CC=O", "C1CC1", "c1ccccc1", "CC(C)O",
             "CC(N)=O", "CCOC", "CNC", "c1ccccc1C", "c1ccccc1O",
             "CC(C)(C)O", "c1ccncc1C"]
# Path 13: bench.py bench_xgraph (:717-741), uncut: ba_2motifs(120,
# base_n=20, seed=0), GCN_2l(dim_hidden=32) trained by train_gnn(epochs=25)
# (batches of 32, Adam(5e-3) on the cosine schedule, up to 3 restarts below
# 0.95 accuracy), then run_benchmark.make_explainer's GNNExplainer(epochs=60,
# lr=0.05) over graphs 1-32 in one explain_batch at seed=1; beside it one
# step of run_benchmark.py's GRAPH_MODEL, GIN_3l(dim_hidden=64, readout=
# "sum"). First steps against the CPU's as paths 9-11. The 32 graphs' final
# mask logits against the CPU's from the same weights and initial masks:
# 60 Adam steps of 0.05 move a logit by up to 3, each step's gradient
# differing from the CPU's in the order of its float32 sums (~1e-6
# relative), which Adam's normalised steps pass on: 1e-3 absolute.
XG_DATA = dict(num_graphs=120, base_n=20, seed=0)
XG_MODEL = dict(dim_hidden=32, num_classes=2)
XG_TRAIN = dict(epochs=25, batch_size=32, lr=5e-3)
XG_EXPLAIN = dict(epochs=60, lr=0.05)
XG_GIN = dict(dim_hidden=64, readout="sum", num_classes=2)
XG_STEP_TOL, XG_MASK_TOL, XG_TIMED_STEPS = (1e-5, 1e-4), 1e-3, 20
# segment sums of a train step: two neighbour sums by receiver, the
# readout, the two sender gathers' adjoints (the features carry none)
XG_STEP_LAUNCHES = 5
# Path 13b: the other explainers as run_benchmark.make_explainer builds
# them, card against CPU on one graph: scores 1e-4 of their largest value
# (FlowX's are means of differences of probabilities: 1e-5 absolute); one
# PGExplainer step: loss 1e-5, weights within 5% of a step (lr 3e-3), the
# edge logits 1e-4; SubgraphX's coalition the same, its payoff 1e-5
XG_SCORE_TOL, XG_PROB_TOL, XG_PG_EPOCHS = 1e-4, 1e-5, 10
XG_SUBGRAPHX = dict(num_classes=2, rollout=5, min_atoms=3, sample_num=8)
# Path 14: bench.py bench_ggraph3d_gen (:698-714), uncut:
# QM93DGEN(num_steps_per_batch=16) on its synthetic molecules (64 of 4-9
# atoms; the gdb9 cache is not in the repository), GSphereNet(4, hidden=64,
# num_flow_layers=4), Adam(1e-3) for 4 epochs, then generate([6, 7, 8, 9],
# num_gen=256, max_atoms=9, seed=1) after a warm run. The first step as
# paths 9-11; a generation batch of 32 from the trained weights and the same
# draws: every discrete decision the CPU's (types, atom counts), positions
# 1e-4 of the largest coordinate (float32 flows and frames through 8
# placements).
GS_CONF = dict(num_node_types=4, hidden=64, num_flow_layers=4)
GS_STEPS, GS_LR, GS_EPOCHS, GS_TYPES = 16, 1e-3, 4, [6, 7, 8, 9]
GS_GEN = dict(num_gen=256, max_atoms=9)
GS_STEP_TOL, GS_POS_TOL, GS_LAUNCHES = (1e-5, 1e-4), 1e-4, 7
# Path 15: fairgraph.run()'s widths (num_hidden 64, alpha 20, beta 0.9,
# gamma 0.7, lam 1; optax AdamW(1e-4, 1e-5) written out) on the port's
# synthetic_fair_graph(8192, avg_deg=16, seed=0). POKEC's graphs (tens of
# thousands of nodes) do not fit the dense [N, N] layout of the JAX
# package (one f32 [N, N] at 67,000 nodes is 18 GB and a step keeps
# dozens): cut to 8,192 nodes (256 MB a matrix). The products stay
# torch.matmul, as the JAX package computes them outside Pallas. The first
# warm, adversary and main steps against the same steps on the CPU, from
# the same weights and host-drawn uniforms (CPU_STEP_TOL: the edge sample
# of a step thresholds 67M relaxed-Bernoulli values at 0.5, so the card
# and the CPU, whose z z^T differ in the order of their sums, may flip a
# few of the ~17M sampled edges; the flips are counted); then fit_whole for
# about FG_SECONDS of epochs and test() with its 500 classifier epochs.
FG_N, FG_DEG, FG_SECONDS, FG_CAL = 8192, 16, 25.0, 4
FG_KW = dict(num_hidden=64, alpha=20.0, beta=0.9, gamma=0.7, lam=1.0)
# Path 16: the parallel engines at world size 1 through an NCCL group on a
# local file store (the card machine has one card: NCCL refuses two ranks
# on one device). DP: one step of the flat SchNet at
# tests/test_parallel.py's widths (cutoff 3, 2 x 32, 16 Gaussians, 256
# edges, 2 molecules of at most 12 atoms in 32 rows), segment_eb 1024;
# the GP engine with GPGCN2 and GPPNA (hidden 128, 3 layers, Adam(1e-3),
# node_class_loss on the train mask) on bench_lsgraph's graph
# (synthetic_large_graph(60000, seed=0, avg_deg=16)) in one part, and
# GPSchNet at its defaults (cutoff 5, 3 x 64, 25 Gaussians,
# node_reg_loss) on 8,192 atoms of H, C, N, O uniform in a cube at 0.1
# atoms per cubic Angstrom (liquid-water density; ~50 neighbours within
# 5 A). Each first step against the CPU's (the module's forward and
# backward on the same part with an empty halo, the engine's math at one
# rank: CPU_STEP_TOL), then GP_STEPS Adam steps timed after GP_WARMUP.
# TP on a (1, 1) mesh, PP with one stage, EP with all 16 experts on the
# rank, each against its plain single-process result (1e-5).
PAR_DP_KW = dict(cutoff=3.0, num_layers=2, hidden_channels=32,
                 num_filters=32, num_gaussians=16, max_edges=256,
                 segment_eb=1024)
GP_HIDDEN, GP_LAYERS, GP_STEPS, GP_WARMUP = 128, 3, 8, 2
GPS_ATOMS, GPS_DENSITY = 8192, 0.1
GPS_KW = dict(cutoff=5.0, num_layers=3, hidden_channels=64, num_filters=64,
              num_gaussians=25)
PAR_TOL = 1e-5


def log(*a):
    if a and str(a[0]).startswith("== "):       # a phase: the seconds so far
        a = (f"{a[0]} [{time.perf_counter() - _T0:.0f} s]",) + a[1:]
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=50, warmup=3, spin_cycles=50_000_000):
    """Device time per call of a call shorter than its own host issue
    time: a spin kernel holds the stream while the calls are queued behind
    it, so the events time the card's work back to back and not the host's
    issue rate. The spin lasts at least spin_cycles (about 25 ms) and four
    times the host's issue time for the calls (its quickest warm-up call
    times iters, at no more than 2e9 cycles a second). Fails if the host
    did not get ahead."""
    issue = []
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        issue.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(spin_cycles, int(4 * min(issue) * iters * 2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    if not ahead:
        fail("device_ms: the spin ended before the calls were queued")
    return start.elapsed_time(end) / iters


def kernel_split(torch, fn, names, iters=5):
    """Device ms per call of each kernel named in ``names`` that ``fn``
    launches, from torch.profiler's device events (after one warm call)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = next((n for n in names if n in e.name), None)
            if name is not None:
                out[name] += e.time_range.elapsed_us() / 1e3 / iters
    return out


SECOND_ORDER_KERNELS = ("slot_jvp_kernel", "slot_bwd2_kernel",
                        "sum_partials_kernel")


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def cf_batches(torch, dev, n):
    """SchNetDense's size-bucketed batches (bench.py main()'s buckets)."""
    from dig_tpu_torch.datasets import (BucketedDenseMoleculeLoader,
                                        synthetic_molecules)
    mols = synthetic_molecules(sum(SLOT_COUNTS.values()) * (STEPS + 4),
                               seed=0, min_atoms=12, max_atoms=29, box=6.0)
    it = iter(BucketedDenseMoleculeLoader(mols, SLOT_COUNTS, max_per_slot=2,
                                          shuffle=True, seed=0, device=dev))
    return [next(it) for _ in range(n)]


def bucket_inputs(torch, batches, dev, seed=0):
    """Per bucket: masked distances of the real batch, random vj and
    filter weights at the model's widths."""
    from dig_tpu_torch.graph_dense import radius_adjacency
    from dig_tpu_torch.ops.cfconv import MASK_DIST
    gen = torch.Generator(device="cpu").manual_seed(seed)
    F, R = HIDDEN, GAUSSIANS
    out = {}
    for n, b in sorted(batches.items()):
        dist, adj = radius_adjacency(b.pos, b.node_mask, CUTOFF,
                                     mol_id=b.nodes["mol"])
        G = b.num_graphs
        w = [torch.randn(G, n, F, generator=gen),
             torch.randn(R, F, generator=gen) * 0.2,
             torch.randn(F, generator=gen) * 0.1,
             torch.randn(F, F, generator=gen) * F ** -0.5,
             torch.randn(F, generator=gen) * 0.1]
        g_out = torch.randn(G, n, F, generator=gen)
        out[n] = ([torch.where(adj, dist, MASK_DIST)] + [t.to(dev) for t in w],
                  g_out.to(dev), int(adj.sum()))
    return out


def grads_of(torch, fn, args, g_out):
    xs = [a.clone().requires_grad_() for a in args]
    out = fn(xs)
    return out, torch.autograd.grad(out, xs, g_out)


def phase_kernel_vs_plain(torch, cf, inputs):
    names = ["dist", "vj", "w1", "b1", "w2", "b2"]
    errs = {"fwd": 0.0, "bwd": 0.0}
    for n, (args, g_out, _) in inputs.items():
        for prec in ("f32", "bf16"):
            plain = lambda xs: cf.cfconv_reference(
                *xs, cutoff=CUTOFF, num_gaussians=GAUSSIANS, precision=prec)
            out_p, g_p = grads_of(torch, plain, args, g_out)
            by_flag, outs = {}, []
            for flag in (True, False):
                kern = lambda xs: cf.cfconv_fused(*xs, CUTOFF, GAUSSIANS,
                                                  prec, flag)
                out_k, g_k = grads_of(torch, kern, args, g_out)
                torch.cuda.synchronize()
                by_flag[flag] = g_k
                outs.append(out_k)
                e = rel_err(out_k, out_p)
                log(f"  n={n} {prec} need_dist_grad={flag}: fwd rel err "
                    f"{e:.3e}")
                if e >= TOL[prec]:
                    fail(f"forward n={n} {prec}: rel err {e} >= {TOL[prec]}")
                for name, a, b in zip(names, g_k, g_p):
                    if name == "dist" and not flag:
                        if float(a.abs().max()) != 0.0:
                            fail("need_dist_grad=False gave nonzero d_dist")
                        continue
                    e = rel_err(a, b)
                    log(f"    d_{name} rel err {e:.3e}")
                    if e >= TOL[prec]:
                        fail(f"backward d_{name} n={n} {prec}: rel err {e}")
                if prec == "bf16" and not flag:   # the main path's setting
                    errs["fwd"] = max(errs["fwd"],
                                      float((out_k - out_p).detach().abs().max()))
                    errs["bwd"] = max(errs["bwd"], max(
                        float((a.float() - b.float()).abs().max())
                        for a, b in zip(g_k[1:], g_p[1:])))
            for name, a, b in zip(names[1:], by_flag[True][1:],
                                  by_flag[False][1:]):
                if rel_err(b, a) >= 1e-6:
                    fail(f"need_dist_grad=False changed d_{name}")
            out_again, again = grads_of(torch, lambda xs: cf.cfconv_fused(
                *xs, CUTOFF, GAUSSIANS, prec, False), args, g_out)
            if not all(torch.equal(a, b) for a, b in zip(again,
                                                          by_flag[False])):
                fail(f"backward not bitwise repeatable (n={n}, {prec})")
            if not all(torch.equal(o, out_again) for o in outs):
                fail(f"forward not bitwise repeatable (n={n}, {prec})")
    log(f"  repeated forwards and backwards bitwise equal; max abs err "
        f"(bf16, main setting): fwd {errs['fwd']:.3e} bwd "
        f"{errs['bwd']:.3e}")
    return errs


def first_step_check(torch, make_model, batches):
    """Loss and gradients of one step, kernel branch vs plain branch, in
    f32 and in bf16; returns the errors."""
    from dig_tpu_torch.train import dense_loss
    errs = {}
    for prec, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res = {}
        for use_kernel in (True, False):
            m = make_model(cd)
            m.use_kernel = use_kernel
            loss = dense_loss(m, batches)
            loss.backward()
            res[use_kernel] = (float(loss.detach()),
                               [p.grad.float() for p in m.parameters()])
            del m, loss
        (lk, gk), (lp, gp) = res[True], res[False]
        loss_err = abs(lk - lp) / abs(lp)
        grad_err = max(float((a - b).norm() / b.norm().clamp_min(1e-12))
                       for a, b in zip(gk, gp))
        log(f"  first step {prec}: loss kernel {lk:.6f} plain {lp:.6f} (rel "
            f"{loss_err:.3e}); worst grad rel-norm err {grad_err:.3e}")
        tol_loss, tol_grad = STEP_TOL[prec]
        if not math.isfinite(lk) or loss_err >= tol_loss:
            fail(f"first-step loss {prec}: kernel {lk} vs plain {lp}")
        if grad_err >= tol_grad:
            fail(f"first-step gradients {prec} differ: {grad_err}")
        errs[prec] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err}
    return errs


def phase_main_path(torch, cf, dev, batches_list):
    from dig_tpu_torch.graph_dense import radius_adjacency
    from dig_tpu_torch.models import SchNetDense
    from dig_tpu_torch.threed import ThreeDEvaluator
    from dig_tpu_torch.train import make_dense_step_fns

    def make_model(cd):
        return SchNetDense(cutoff=CUTOFF, num_layers=LAYERS,
                           hidden_channels=HIDDEN, num_filters=HIDDEN,
                           num_gaussians=GAUSSIANS, compute_dtype=cd,
                           use_kernel=True, pos_grads=False,
                           generator=torch.Generator().manual_seed(0),
                           device=dev)

    step_errs = first_step_check(torch, make_model, batches_list[0])
    model = make_model(torch.bfloat16)

    edges = []
    for bs in batches_list:
        edges.append(sum(int(radius_adjacency(
            b.pos, b.node_mask, CUTOFF, mol_id=b.nodes["mol"])[1].sum())
            for b in bs.values()))
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    train_step, eval_step = make_dense_step_fns(model, opt, loss="l1")

    from dig_tpu_torch.ops import triplet_slot as ts
    cf.reset_launch_counts()
    ts.reset_launch_counts()
    losses, t_start = [], None
    for s, bs in enumerate(batches_list):
        if s == WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(train_step(bs)["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    counts = (cf.launches_fwd, cf.launches_bwd)
    losses = [float(x) for x in losses]
    want = LAYERS * len(SLOT_COUNTS) * len(batches_list)
    log(f"  {len(batches_list)} Adam steps, losses "
        f"{[round(x, 5) for x in losses]}")
    log(f"  launches fwd {counts[0]} bwd {counts[1]} (layers x buckets x "
        f"steps = {want})")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite loss")
    if counts != (want, want):
        fail(f"launch counts {counts} != ({want}, {want})")

    timed = len(batches_list) - WARMUP
    step_ms = dt / timed * 1e3
    edges_per_s = sum(edges[WARMUP:]) / dt
    out = eval_step(batches_list[0])
    preds, trues = [], []
    for n, o in out.items():
        m = o["mol_mask"]
        preds.append(o["y_pred"][m])
        trues.append(batches_list[0][n].globals["y"][..., :1][m])
    mae = ThreeDEvaluator().eval({"y_pred": torch.cat(preds),
                                  "y_true": torch.cat(trues)})["mae"]
    log(f"  eval MAE {mae:.5f} over {int(torch.cat(preds).shape[0])} "
        f"molecules")
    if not math.isfinite(mae):
        fail("non-finite eval MAE")
    log(f"  step {step_ms:.3f} ms, {edges_per_s:.6g} edges/s "
        f"({sum(edges[WARMUP:]) / timed:.0f} in-cutoff directed pairs per "
        f"step, mean of {timed} steps)")
    return {"launches_fwd": counts[0], "launches_bwd": counts[1],
            "steps": len(batches_list), "losses": losses,
            "step_ms": step_ms, "edges_per_s": edges_per_s,
            "edges_per_step": sum(edges[WARMUP:]) / timed,
            "first_step": step_errs, "eval_mae": mae}


def bounds(args, n_pairs, prec, kind, need_dist, sfu_rate):
    """Least time for the work this data needs: in-cutoff pairs only (the
    others contribute exactly zero), each input read once and each output
    written once."""
    dist, vj, w1, b1, w2, b2 = args
    F, R = vj.shape[-1], w1.shape[0]
    el = lambda t: t.numel() * t.element_size()
    w_bytes = sum(el(t) for t in (w1, b1, w2, b2))
    out_bytes = vj.numel() * 4
    P = n_pairs
    if kind == "fwd":
        flops = 2 * P * F * (R + F) + 3 * P * F
        mufu = P * (R + 2 * F + 1)
        nbytes = el(dist) + el(vj) + w_bytes + out_bytes
    else:
        # R basis exps, and per feature one exp(-|pre|) shared by the
        # softplus and the sigmoid, a log and a reciprocal
        flops = 2 * P * F * (2 * R + 3 * F) + 10 * P * F
        mufu = P * (R + 3 * F + 1)
        if need_dist:
            flops += 2 * P * F * R + 2 * P * (F + R)
            mufu += P
        nbytes = (el(dist) + el(vj) + w_bytes + out_bytes      # inputs + g
                  + el(dist) + el(vj) + w_bytes)               # gradients
    t_ops = max(flops / PEAK_FLOPS[prec], mufu / sfu_rate)
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, mufu, nbytes


def phase_times(torch, cf, inputs, sfu_rate):
    rows = []
    for n, (args, g_out, n_pairs) in inputs.items():
        vj16 = args[1].to(torch.bfloat16)
        main_args = [args[0], vj16] + args[2:]
        for prec in ("bf16", "f32"):
            k_args = cf._kernel_inputs(*main_args)
            g32 = g_out.float().contiguous()
            fwd_ms = cuda_ms(torch, lambda: cf.cfconv_forward_kernel(
                *k_args, CUTOFF, GAUSSIANS, prec))
            xs = [a.clone().requires_grad_() for a in main_args]
            out = cf.cfconv_reference(*xs, cutoff=CUTOFF,
                                      num_gaussians=GAUSSIANS, precision=prec)
            plain_fwd = cuda_ms(torch, lambda: cf.cfconv_reference(
                *main_args, cutoff=CUTOFF, num_gaussians=GAUSSIANS,
                precision=prec), iters=5, warmup=1)
            plain_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                out, xs, g_out, retain_graph=True), iters=5, warmup=1)
            del out, xs
            b_fwd = bounds(main_args, n_pairs, prec, "fwd", False,
                           sfu_rate)
            rows.append({"kernel": "cfconv_fwd", "n": n, "G": args[0].shape[0],
                         "precision": prec, "need_dist_grad": None,
                         "pairs": n_pairs, "ms": fwd_ms, "plain_ms": plain_fwd,
                         "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                         "flops": b_fwd[2], "mufu": b_fwd[3],
                         "bytes": b_fwd[4]})
            for need_dist in (False, True):
                bwd_ms = cuda_ms(torch, lambda: cf.cfconv_backward_kernel(
                    *k_args, g32, CUTOFF, GAUSSIANS, prec, need_dist))
                b_bwd = bounds(main_args, n_pairs, prec, "bwd",
                               need_dist, sfu_rate)
                rows.append({"kernel": "cfconv_bwd", "n": n,
                             "G": args[0].shape[0], "precision": prec,
                             "need_dist_grad": need_dist, "pairs": n_pairs,
                             "ms": bwd_ms, "plain_ms": plain_bwd,
                             "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
                             "flops": b_bwd[2], "mufu": b_bwd[3],
                             "bytes": b_bwd[4]})
    for r in rows:
        log(f"  {r['kernel']} n={r['n']} G={r['G']} {r['precision']} "
            f"need_dist_grad={r['need_dist_grad']}: {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.3f} of it; plain {r['plain_ms']:.3f} "
            f"ms)")
    return rows


# ---------------------------------------------------------------------------
# SphereNet on the slot layout: fused_triplet_slot
# ---------------------------------------------------------------------------

def sn_batches(torch, dev, n):
    """bench_spherenet's batches; the target is the first column of y, as
    its loss (``energy``)."""
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    mols = synthetic_molecules(SN_G * (n + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    it = iter(MoleculeLoader(mols, SN_G, slot_size=SN_KW["block_size"],
                             shuffle=True, seed=0, device=dev))
    return [b.replace_globals(energy=b.globals["y"][:, :1])
            for b in (next(it) for _ in range(n))]


def sn_pair_counts(torch, b, geo, block=SN_KW["block_size"]):
    """(uncapped in-cutoff directed pairs as bench.py:164-172 counts them,
    their largest in-degree, NK edges kept, radius_blocked_dropped)."""
    from dig_tpu_torch.ops.radius import radius_blocked_dropped
    pos, nm, ng = b.nodes["pos"], b.node_mask, b.node_graph
    d = (pos[:, None] - pos[None, :]).norm(dim=-1)
    eye = torch.eye(pos.shape[0], dtype=torch.bool, device=pos.device)
    adj = ((d < SN_KW["cutoff"]) & ~eye & nm[:, None] & nm[None, :]
           & (ng[:, None] == ng[None, :]))
    dropped = radius_blocked_dropped(pos, ng, nm, SN_KW["cutoff"], block)
    return (int(adj.sum()), int(adj.sum(1).max()),
            int(geo.nkg.edge_mask.sum()), int(dropped))


def sn_model(torch, dev, cd, slot):
    from dig_tpu_torch.models import SphereNet
    return SphereNet(**SN_KW, **(SN_SLOT if slot else {}), compute_dtype=cd,
                     generator=torch.Generator().manual_seed(0), device=dev)


def sn_kernel_inputs(torch, dev, batch, A=SN_KW["block_size"]):
    """pt, m2T, lj of a real batch with slots of A atoms (float32, the
    model's own operands) and seeded random x, ws, wt, output cotangent and
    second-order cotangents u1 (of dx), u2 (of dpt) at the flagship
    widths."""
    model = sn_model(torch, dev, torch.float32, True)
    with torch.no_grad():
        geo = model.geometry(batch.nodes["pos"], batch, A)
        pt, m2t, lj = model.slot_operands(geo, A)
    n, k = SN_KW["num_spherical"], SN_KW["num_radial"]
    K = SN_KW["nk_degree"]
    E = m2t.shape[1]
    gen = torch.Generator(device="cpu").manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    # the work this batch needs: real triplets (m2T != 0), the distinct x
    # rows (slot*A + lj)*K + s they gather, the edges that own one
    real = m2t != 0
    e = torch.arange(E, device=dev)
    x_rows = ((e // (A * K)) * A + lj[0].long()) * K \
        + torch.arange(K, device=dev)[:, None]
    work = {"triplets": int(real.sum()),
            "x_rows": int(torch.unique(x_rows[real]).numel()),
            "edges": int(real.any(0).sum())}
    return {"pt": pt, "m2t": m2t, "lj": lj, "x": r(E, SN_C),
            "ws": r(n * k, SN_C) * (n * k) ** -0.5,
            "wt": r(n * n * k, SN_C) * (n * n * k) ** -0.5,
            "ct": r(E, SN_C), "u1": r(E, SN_C), "u2": r(*pt.shape),
            "u4": r(n * k, SN_C), "u5": r(n * n * k, SN_C), "work": work}


def sn_args(torch, inp, has_t, dt):
    """Operands of fused_triplet_slot for one setting; (args, cfg)."""
    n, k = SN_KW["num_spherical"], SN_KW["num_radial"]
    R = n * k + n + (n * n if has_t else 0)
    wt = inp["wt"] if has_t else torch.zeros_like(inp["wt"][:1])
    args = [inp["x"].to(dt), inp["pt"][:, :R].to(dt).contiguous(),
            inp["ws"].to(dt), wt.to(dt), inp["m2t"].to(dt), inp["lj"]]
    return args, (n, k, has_t)


def slot_grads(torch, fn, args, ct, need_pt):
    """fn's output and the gradients of x, pt (None unless need_pt), ws
    and wt; wt's is 0 where fn does not use it (no torsion)."""
    xs = [a.clone().requires_grad_(i != 1 or need_pt)
          for i, a in enumerate(args[:4])]
    out = fn(xs + list(args[4:]))
    want = [x for x in xs if x.requires_grad]
    gs = torch.autograd.grad(out, want, ct, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for g, x in zip(gs, want)]
    if not need_pt:
        gs.insert(1, None)
    return out, gs


def phase_sn_kernel_vs_plain(torch, ts, inp):
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    names = ["dx", "dpt", "dws", "dwt"]
    errs = {}
    for has_t in (True, False):
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args, cfg = sn_args(torch, inp, has_t, dt)
            ct = inp["ct"].to(dt)
            plain = lambda xs: ts.fused_triplet_slot_reference(*xs, A, K, cfg)
            kern = lambda xs: ts.fused_triplet_slot(*xs, A, K, cfg)
            out_p, g_p = slot_grads(torch, plain, args, ct, True)
            out_k, g_k = slot_grads(torch, kern, args, ct, True)
            torch.cuda.synchronize()
            e = rel_err(out_k, out_p)
            line = [f"fwd {e:.3e}"]
            if out_k.dtype != dt or e >= SN_TOL[prec]:
                fail(f"triplet_slot forward has_t={has_t} {prec}: rel err "
                     f"{e} (dtype {out_k.dtype})")
            for nm, a, b in zip(names, g_k, g_p):
                e = rel_err(a, b)
                line.append(f"{nm} {e:.3e}")
                if a.dtype != b.dtype or e >= SN_TOL[prec]:
                    fail(f"triplet_slot {nm} has_t={has_t} {prec}: rel err "
                         f"{e}")
            _, g_n = slot_grads(torch, kern, args, ct, False)
            for nm, a, b in zip(names, g_n, g_k):
                if nm != "dpt" and not torch.equal(a, b):
                    fail(f"triplet_slot {nm} changed when dpt was not asked "
                         f"for (has_t={has_t}, {prec})")
            _, again = slot_grads(torch, kern, args, ct, False)
            if not all(a is None or torch.equal(a, b)
                       for a, b in zip(again, g_n)):
                fail(f"triplet_slot backward not bitwise repeatable "
                     f"(has_t={has_t}, {prec})")
            log(f"  has_t={has_t} {prec}: rel err " + ", ".join(line)
                + "; without dpt the same bits; repeated backward the same "
                "bits")
            if has_t and prec == "bf16":      # the main path's setting
                errs["fwd"] = float((out_k - out_p).detach().float().abs().max())
                errs["bwd"] = max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(g_n, g_p) if a is not None)
    log(f"  max abs err (bf16, has_t, no dpt as on the main path): fwd "
        f"{errs['fwd']:.3e} bwd {errs['bwd']:.3e}")
    return errs


def rel_norm(torch, g, ref):
    """||g - ref|| / ||ref||, the tensors of each list taken as one vector."""
    flat = lambda t: torch.cat([x.reshape(-1) for x in t])
    return float((flat(g) - flat(ref)).norm()
                 / flat(ref).norm().clamp_min(1e-12))


def first_step_vs_plain(torch, labels, make_model, make_step, batch, tols):
    """Loss and gradients of one step at lr 0 (the weights stay) through
    make_step(model, optimizer), the kernel branch make_model(dtype, True)
    against the plain branch make_model(dtype, False) of the same weights,
    for each precision of ``tols`` = {"f32" first, "bf16": (loss bound,
    gradient bound)}; ``labels`` names the two branches. The gradient bound
    holds every parameter's ||a-b|| / ||b||. None in its place (bf16 force
    steps) holds the kernel branch's gradient to the f32 plain one by
    direction and size instead (SF_BF16_COS, SF_BF16_NORM). A third entry
    (DP6_STEP_TOL) makes the loss bound hold the energy term of a force
    step and bounds the force term by itself. Returns the errors per
    precision."""
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    errs, truth = {}, None
    for prec, tol in tols.items():
        tol_loss, tol_grad = tol[:2]
        tol_force = tol[2] if len(tol) > 2 else None
        res, terms = {}, {}
        for kernel in (True, False):
            m = make_model(dtypes[prec], kernel)
            step = make_step(m, torch.optim.SGD(m.parameters(), lr=0.0))
            aux = step(batch)
            loss = float(aux["loss"])
            terms[kernel] = {k: float(v) for k, v in aux.items()
                             if k in ("e_loss", "f_loss")}
            res[kernel] = (loss, [p.grad.float() for p in m.parameters()])
            names = [n for n, _ in m.named_parameters()]
            del m, step
            torch.cuda.empty_cache()
        (lk, gk), (lp, gp) = res[True], res[False]
        loss_err = abs(lk - lp) / abs(lp)
        if tol_force is not None:
            rel = {k: abs(terms[True][k] - terms[False][k])
                   / abs(terms[False][k]) for k in ("e_loss", "f_loss")}
            log(f"  first step {prec}: energy term {labels[0]} "
                f"{terms[True]['e_loss']:.7f} {labels[1]} "
                f"{terms[False]['e_loss']:.7f} (rel {rel['e_loss']:.3e}, "
                f"held to {tol_loss}); force term rel {rel['f_loss']:.3e} "
                f"(held to {tol_force})")
            if not math.isfinite(lk) or rel["f_loss"] >= tol_force:
                fail(f"first-step force term {prec}: {terms}")
            loss_err = rel["e_loss"]
        per = sorted(((rel_norm(torch, [a], [b]), n)
                      for a, b, n in zip(gk, gp, names)), reverse=True)
        whole = rel_norm(torch, gk, gp)
        log(f"  first step {prec}: loss {labels[0]} {lk:.7f} {labels[1]} "
            f"{lp:.7f} ({'energy term ' if tol_force else ''}rel "
            f"{loss_err:.3e}); gradient rel-norm err "
            f"{whole:.3e} over all parameters, median parameter "
            f"{per[len(per) // 2][0]:.3e}, worst "
            + ", ".join(f"{n} {e:.3e}" for e, n in per[:3]))
        if not math.isfinite(lk) or loss_err >= tol_loss:
            fail(f"first-step loss {prec}: {labels[0]} {lk} vs {labels[1]} "
                 f"{lp} (rel {loss_err})")
        errs[prec] = {"loss_rel_err": loss_err, "grad_rel_err": whole,
                      "worst_param": per[0]}
        if truth is None:                       # f32
            truth = (lp, gp)
        if tol_grad is not None:
            if not per[0][0] < tol_grad:
                fail(f"first-step gradients {prec} differ: {per[:3]}")
            continue
        agree = {}
        for label, lx, g in ((labels[0], lk, gk), (labels[1], lp, gp)):
            a = agree[label] = agreement(torch, g, truth[1], names)
            log(f"    {label} {prec} against the f32 {labels[1]} step: loss "
                f"{abs(lx - truth[0]) / abs(truth[0]):.3e}, gradient "
                f"rel-norm {rel_norm(torch, g, truth[1]):.3e}, cosine "
                f"{a['cos']:.4f} over all parameters, median parameter "
                f"{a['median_cos']:.4f}; norm {a['norm']:.4f} x the f32 one "
                f"over all parameters, per parameter {a['least'][0]:.4f} "
                f"({a['least'][1]}) to {a['largest'][0]:.4f} "
                f"({a['largest'][1]})")
        a = errs[prec]["agreement"] = agree[labels[0]]
        if (not a["cos"] >= SF_BF16_COS[0]
                or not a["median_cos"] >= SF_BF16_COS[1]
                or not SF_BF16_NORM[0] <= a["least"][0]
                or not a["largest"][0] <= SF_BF16_NORM[1]):
            fail(f"{prec} force gradient of the {labels[0]} branch against "
                 f"the f32 one: {a}; cosines must reach {SF_BF16_COS}, each "
                 f"parameter's norm ratio lie within {SF_BF16_NORM}")
    return errs


def readout_launches(sc, want, what):
    """The sorted-CSR sums of a SphereNet step on the NK or slot layout
    must have gone through the segment-sum kernel: per model call the
    L + 1 per-graph readouts (their adjoints are row gathers, and the force
    loss's inner pass feeds them a constant) and, in the backward, the
    adjoint of the atom-embedding gather: L + 2."""
    if sc.launches != want:
        fail(f"{what}: {sc.launches} segment-sum launches, expected {want} "
             f"(the readouts and the embedding gather's adjoint)")
    return sc.launches


def phase_sn_main_path(torch, cf, ts, sc, dev, batches):
    from dig_tpu_torch.threed import ThreeDEvaluator
    from dig_tpu_torch.train import make_step_fns
    step_errs = first_step_vs_plain(
        torch, ("slot kernel", "unfused"),
        lambda cd, slot: sn_model(torch, dev, cd, slot),
        lambda m, opt: make_step_fns(m, opt, loss="l1",
                                     target_key="energy")[0],
        batches[0], SN_STEP_TOL)
    model = sn_model(torch, dev, torch.bfloat16, True)
    counts = []
    with torch.no_grad():
        for b in batches:
            counts.append(sn_pair_counts(
                torch, b, model.geometry(b.nodes["pos"], b)))
    if any(c[3] for c in counts):
        fail(f"radius_blocked_dropped {[c[3] for c in counts]}: the batches "
             f"are not slot-aligned")
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    train_step, eval_step = make_step_fns(model, opt, loss="l1",
                                          target_key="energy")
    reset_all(cf, ts, sc)
    losses, t_start = [], None
    for s, b in enumerate(batches):
        if s == SN_WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(train_step(b)["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    launches = (ts.launches_fwd, ts.launches_bwd)
    losses = [float(x) for x in losses]
    want = SN_KW["num_layers"] * len(batches)
    seg = readout_launches(sc, (SN_KW["num_layers"] + 2) * len(batches),
                           "path 2")
    log(f"  {len(batches)} Adam steps, losses {[round(x, 5) for x in losses]}")
    log(f"  triplet_slot launches fwd {launches[0]} bwd {launches[1]} "
        f"(layers x steps = {want}); segment sum {seg} ((layers + 2) x "
        f"steps: the readouts, the embedding gather's adjoint); cfconv "
        f"{cf.launches_fwd} {cf.launches_bwd}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite SphereNet loss")
    if launches != (want, want):
        fail(f"triplet_slot launch counts {launches} != ({want}, {want})")
    timed = len(batches) - SN_WARMUP
    pairs = sum(c[0] for c in counts[SN_WARMUP:])
    kept = sum(c[2] for c in counts[SN_WARMUP:])
    step_ms = dt / timed * 1e3
    out = eval_step(batches[0])
    m = out["graph_mask"]
    mae = ThreeDEvaluator().eval({"y_pred": out["y_pred"][m],
                                  "y_true": batches[0].globals["energy"][m]}
                                 )["mae"]
    if not math.isfinite(mae):
        fail("non-finite SphereNet eval MAE")
    log(f"  radius_blocked_dropped 0 in all {len(batches)} batches; largest "
        f"uncapped in-degree {max(c[1] for c in counts)}")
    log(f"  eval MAE {mae:.5f} over {int(m.sum())} molecules")
    log(f"  step {step_ms:.3f} ms (mean of {timed} steps); "
        f"{pairs / dt:.6g} edges/s counting the uncapped in-cutoff pairs "
        f"({pairs / timed:.0f} per step, as bench.py counts), "
        f"{kept / dt:.6g} edges/s counting the {kept / timed:.0f} NK edges "
        f"kept per step ({1 - kept / pairs:.3f} of the pairs dropped by the "
        f"K={SN_KW['nk_degree']} table)")
    return {"launches_fwd": launches[0], "launches_bwd": launches[1],
            "steps": len(batches), "losses": losses, "step_ms": step_ms,
            "edges_per_s": pairs / dt, "kept_edges_per_s": kept / dt,
            "pairs_per_step": pairs / timed, "kept_per_step": kept / timed,
            "first_step": step_errs, "eval_mae": mae}


def sn_bounds(args, work, prec, kind, need_dpt):
    """Least time for one call's work at this data: real triplets only
    (m2T = 0 contributes exactly zero). Bytes: each input read once where
    a real triplet needs it (pt's column and the gathered x row of each
    real triplet, the cotangent row of each edge that owns one), m2T, lj
    and the weights in full, each output written in full, all in the
    types the function takes and returns (the output and its cotangent in
    x's type, dx in x's, dpt in pt's, dws and dwt in the weights'), not in
    the kernel's float32 staging. Operations: per triplet the forward forms
    the NB = nk + ntk basis products, the two projections (2 C NB) and the
    triple product (3 C); the backward recomputes the projections, forms
    three cotangents (6 C), the weight gradients (2 C NB) and the dx sum
    (C), and with dpt the basis cotangents (2 C NB + 2 NB)."""
    x, pt, ws, wt, m2t, lj = args
    C, R = x.shape[1], pt.shape[1]
    NB = ws.shape[0] + (wt.shape[0] if wt.shape[0] > 1 else 0)
    T = work["triplets"]
    el = lambda t: t.numel() * t.element_size()
    w = el(ws) + el(wt)
    inputs = (work["x_rows"] * C * x.element_size() + T * R * pt.element_size()
              + el(m2t) + el(lj) + w)
    if kind == "fwd":
        flops = T * (2 * C * NB + 3 * C + NB)
        nbytes = inputs + el(x)
    else:
        flops = T * (4 * C * NB + 7 * C + NB)
        nbytes = inputs + work["edges"] * C * x.element_size() + el(x) + w
        if need_dpt:
            flops += T * (2 * C * NB + 2 * NB)
            nbytes += el(pt)
    t_ops = flops / PEAK_FLOPS[prec]
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def phase_sn_times(torch, ts, inp):
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    rows = []
    for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        args, cfg = sn_args(torch, inp, True, dt)
        k_args = ts._kernel_inputs(*args, A, K, cfg)
        ct32 = inp["ct"].float().contiguous()
        fwd_ms = cuda_ms(torch, lambda: ts.triplet_slot_forward_kernel(
            *k_args, A, K, cfg))
        plain_fwd = cuda_ms(torch, lambda: ts.fused_triplet_slot_reference(
            *args, A, K, cfg), iters=5, warmup=1)
        lib = slot_library_fwd(torch, args, args[1], cfg, dt, A, K)
        lib_err = rel_err(lib(), ts.fused_triplet_slot_reference(
            *args, A, K, cfg))
        if prec == "f32" and lib_err >= SN_TOL["f32"]:
            fail(f"einsum slot forward: rel err {lib_err} against plain")
        lib_ms = cuda_ms(torch, lib, iters=3, warmup=1)
        del lib
        torch.cuda.empty_cache()
        xs = [a.clone().requires_grad_(i != 1)        # pt: no grad, as on
              for i, a in enumerate(args[:4])]        # the main path
        want = [x for x in xs if x.requires_grad]
        out = ts.fused_triplet_slot_reference(*xs, *args[4:], A, K, cfg)
        ct = inp["ct"].to(dt)
        plain_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            out, want, ct, retain_graph=True), iters=5, warmup=1)
        del out, xs, want
        b = sn_bounds(args, inp["work"], prec, "fwd", False)
        rows.append({"kernel": "triplet_slot_fwd", "precision": prec,
                     "need_dpt": None, "ms": fwd_ms, "plain_ms": plain_fwd,
                     "bound_ms": b[0], "bound_by": b[1], "flops": b[2],
                     "bytes": b[3], "library_ms": lib_ms,
                     "library_err": lib_err})
        for need_dpt in (False, True):
            bwd_ms = cuda_ms(torch, lambda: ts.triplet_slot_backward_kernel(
                *k_args, ct32, A, K, cfg, need_dpt))
            b = sn_bounds(args, inp["work"], prec, "bwd", need_dpt)
            rows.append({"kernel": "triplet_slot_bwd", "precision": prec,
                         "need_dpt": need_dpt, "ms": bwd_ms,
                         "plain_ms": plain_bwd if not need_dpt else None,
                         "bound_ms": b[0], "bound_by": b[1], "flops": b[2],
                         "bytes": b[3], "library_ms": None})
    E = inp["x"].shape[0]
    w = inp["work"]
    log(f"  one layer's call at E={E}, K={K}, C={SN_C}: {w['triplets']} "
        f"real triplets of {E * K}, gathering {w['x_rows']} distinct x rows, "
        f"owned by {w['edges']} edges:")
    for r in rows:
        plain = ("" if r["plain_ms"] is None
                 else f"; plain {r['plain_ms']:.3f} ms")
        if r["library_ms"] is not None:
            plain += (f"; einsum over the gathered x rows and sbf, tbf "
                      f"assembled outside the timed call "
                      f"{r['library_ms']:.3f} ms (rel err "
                      f"{r['library_err']:.2e})")
        log(f"  {r['kernel']} {r['precision']} need_dpt={r['need_dpt']}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.3f} of it; "
            f"{r['flops'] / 1e9:.3f} GFLOP, {r['bytes'] / 1e6:.2f} MB"
            f"{plain})")
    return rows


# ---------------------------------------------------------------------------
# SphereNet energy+force on slot-bucketed batches: the second-order kernel
# ---------------------------------------------------------------------------

def sf_batches(torch, dev, n):
    """bench_spherenet_force's batches: its molecules, forces and bucketed
    loader (shuffled, seed 0); the first n batches."""
    import numpy as np
    from dig_tpu_torch.datasets import (BucketedMoleculeLoader,
                                        synthetic_molecules)
    G = sum(SF_SLOTS.values())
    mols = synthetic_molecules(G * (SF_BENCH_STEPS + 4), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    rng = np.random.default_rng(0)
    for m in mols:
        m["force"] = rng.normal(size=m["pos"].shape).astype(np.float32)
    it = iter(BucketedMoleculeLoader(mols, SF_SLOTS, shuffle=True, seed=0,
                                     device=dev))
    return [next(it) for _ in range(n)]


def bwd2_args(torch, inp, has_t, dt, all_u):
    """Operands of the second-order kernel for one setting: (args, ct,
    cotangents u1, u2, u4, u5, cfg); u4 = u5 = None unless all_u."""
    args, cfg = sn_args(torch, inp, has_t, dt)
    R = args[1].shape[1]
    us = [inp["u1"].to(dt), inp["u2"][:, :R].to(dt).contiguous(),
          inp["u4"] if all_u else None,
          (inp["u5"] if has_t else inp["u5"][:1]) if all_u else None]
    return args, inp["ct"].to(dt), us, cfg


def phase_sf_kernel_vs_plain(torch, ts, dev, batch):
    """The second-order kernel against the plain double backward at each
    bucket of a real batch; returns the per-bucket inputs and the largest
    absolute error in the main path's setting."""
    K = SN_KW["nk_degree"]
    names = ["xb", "ptb", "wsb", "wtb", "ctb"]
    inputs, err = {}, 0.0
    for A, b in batch.items():
        inp = sn_kernel_inputs(torch, dev, b, A)
        inputs[A] = inp
        settings = [(t, p, False) for t in (True, False)
                    for p in ("f32", "bf16")] + [(True, "f32", True)]
        for has_t, prec, all_u in settings:
            dt = torch.float32 if prec == "f32" else torch.bfloat16
            args, ct, us, cfg = bwd2_args(torch, inp, has_t, dt, all_u)
            k_args = ts._kernel_inputs(*args, A, K, cfg)
            ct32 = ct.float().contiguous()
            got = ts.triplet_slot_bwd2_kernel(*k_args, ct32, *us, A, K, cfg)
            torch.cuda.synchronize()
            want = ts.fused_triplet_slot_bwd2_reference(*args, ct, *us, A, K,
                                                        cfg)
            line = []
            for nm, a, w in zip(names, got, want):
                if not bool(torch.isfinite(a).all()):
                    fail(f"bwd2 {nm} not finite (A={A}, has_t={has_t}, "
                         f"{prec})")
                if nm == "wtb" and not has_t:
                    continue
                e = rel_err(a, w)
                line.append(f"{nm} {e:.2e}")
                if e >= BWD2_TOL:
                    fail(f"bwd2 {nm} A={A} has_t={has_t} {prec} all_u="
                         f"{all_u}: rel err {e} >= {BWD2_TOL}")
                if has_t and prec == "bf16" and not all_u:
                    err = max(err, float((a - w).abs().max()))
            again = ts.triplet_slot_bwd2_kernel(*k_args, ct32, *us, A, K, cfg)
            if not all(torch.equal(a, c) for a, c in zip(again, got)):
                fail(f"bwd2 not bitwise repeatable (A={A}, has_t={has_t}, "
                     f"{prec})")
            log(f"  A={A} E={args[0].shape[0]} has_t={has_t} {prec} "
                f"u4,u5={'present' if all_u else 'absent'}: rel err "
                + ", ".join(line) + "; repeated call the same bits")
    log(f"  max abs err (bf16, has_t, u4 = u5 absent as on the main path): "
        f"{err:.3e}")
    return inputs, err


def agreement(torch, g, ref, names):
    """How a gradient (one tensor per parameter) agrees with a reference:
    the cosine of the whole gradient and the median of the per-parameter
    cosines, the whole norm ratio, and the least and largest per-parameter
    norm ratio with the parameter's name. A zero or dropped gradient reads
    cosine 0 and norm ratio 0."""
    def cos(a, b):
        return float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))
    flat = lambda t: torch.cat([x.reshape(-1) for x in t])
    per = sorted(cos(a, b) for a, b in zip(g, ref))
    ratios = sorted((float(a.norm() / b.norm().clamp_min(1e-30)), n)
                    for a, b, n in zip(g, ref, names))
    return {"cos": cos(flat(g), flat(ref)), "median_cos": per[len(per) // 2],
            "norm": float(flat(g).norm() / flat(ref).norm()),
            "least": ratios[0], "largest": ratios[-1]}


def phase_sf_main_path(torch, cf, ts, sc, dev, batches):
    from dig_tpu_torch.threed import ThreeDEvaluator
    from dig_tpu_torch.train import make_bucketed_step_fns
    step_errs = first_step_vs_plain(
        torch, ("slot kernel", "unfused"),
        lambda cd, slot: sn_model(torch, dev, cd, slot),
        lambda m, opt: make_bucketed_step_fns(m, opt, p=SF_P)[0],
        batches[0], SF_STEP_TOL)
    model = sn_model(torch, dev, torch.bfloat16, True)
    counts = []                        # per batch: summed over the buckets
    with torch.no_grad():
        for bs in batches:
            per = [sn_pair_counts(torch, b, model.geometry(b.nodes["pos"], b,
                                                            A), A)
                   for A, b in bs.items()]
            counts.append((sum(c[0] for c in per), max(c[1] for c in per),
                           sum(c[2] for c in per), sum(c[3] for c in per)))
    if any(c[3] for c in counts):
        fail(f"radius_blocked_dropped {[c[3] for c in counts]}: the buckets "
             f"are not slot-aligned")
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    train_step, eval_step = make_bucketed_step_fns(model, opt, p=SF_P)
    reset_all(cf, ts, sc)
    losses, t_start = [], None
    for s, bs in enumerate(batches):
        if s == SF_WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(train_step(bs)["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    launches = (ts.launches_fwd, ts.launches_bwd, ts.launches_bwd2)
    with_dpt = ts.launches_bwd_dpt
    losses = [float(x) for x in losses]
    calls = SN_KW["num_layers"] * len(SF_SLOTS) * len(batches)
    want = (calls, 2 * calls, calls)
    seg = readout_launches(
        sc, (SN_KW["num_layers"] + 2) * len(SF_SLOTS) * len(batches),
        "path 3")
    log(f"  {len(batches)} Adam steps, losses {[round(x, 4) for x in losses]}")
    log(f"  triplet_slot launches fwd {launches[0]} bwd {launches[1]} bwd2 "
        f"{launches[2]} (layers x buckets x steps = {calls}: the backward "
        f"once with dpt under create_graph and once in the outer pass, "
        f"which needs no dpt); backward launches with dpt {with_dpt}, "
        f"without {launches[1] - with_dpt} (per step "
        f"{with_dpt // len(batches)} of {launches[1] // len(batches)}); "
        f"segment sum {seg} ((layers + 2) x buckets x steps: the readouts, "
        f"the embedding gather's adjoint); "
        f"cfconv {cf.launches_fwd} {cf.launches_bwd}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite force-training loss")
    if launches != want:
        fail(f"triplet_slot launch counts {launches} != {want}")
    if with_dpt != calls:
        fail(f"triplet_slot backward launches with dpt {with_dpt} != "
             f"{calls} (the inner pass's only)")
    out = eval_step(batches[0])
    preds, trues = [], []
    for A, o in out.items():
        if not bool(torch.isfinite(o["force_pred"]).all()):
            fail(f"non-finite forces in bucket {A}")
        m = o["graph_mask"]
        preds.append(o["y_pred"][m])
        trues.append(batches[0][A].globals["y"][:, :1][m])
    mae = ThreeDEvaluator().eval({"y_pred": torch.cat(preds),
                                  "y_true": torch.cat(trues)})["mae"]
    fmax = max(float(o["force_pred"].abs().max()) for o in out.values())
    if not math.isfinite(mae):
        fail("non-finite force-path eval MAE")
    timed = len(batches) - SF_WARMUP
    pairs = sum(c[0] for c in counts[SF_WARMUP:])
    kept = sum(c[2] for c in counts[SF_WARMUP:])
    step_ms = dt / timed * 1e3
    log(f"  radius_blocked_dropped 0 in all {len(batches)} batches; largest "
        f"uncapped in-degree {max(c[1] for c in counts)}")
    log(f"  eval: forces finite (largest |F| {fmax:.4g}), energy MAE "
        f"{mae:.5f} over {int(sum(len(p) for p in preds))} molecules")
    log(f"  force step {step_ms:.3f} ms (mean of {timed} steps); "
        f"{pairs / dt:.6g} edges/s counting the uncapped in-cutoff pairs "
        f"({pairs / timed:.0f} per step, as bench.py:268-278 counts), "
        f"{kept / dt:.6g} edges/s counting the {kept / timed:.0f} NK edges "
        f"kept per step")
    return {"launches_fwd": launches[0], "launches_bwd": launches[1],
            "launches_bwd2": launches[2], "launches_bwd_dpt": with_dpt,
            "steps": len(batches),
            "losses": losses, "step_ms": step_ms, "edges_per_s": pairs / dt,
            "kept_edges_per_s": kept / dt, "pairs_per_step": pairs / timed,
            "kept_per_step": kept / timed, "first_step": step_errs,
            "eval_mae": mae}


def phase_sf_run3d(torch, ts, dev):
    """One short Run3D epoch with energy_and_force at slots of 29 atoms:
    two training batches of 96, one validation and one test batch."""
    from dig_tpu_torch.datasets import synthetic_molecules
    from dig_tpu_torch.threed import Run3D, ThreeDEvaluator
    mols = synthetic_molecules(96 * 4, seed=1, min_atoms=12, max_atoms=29,
                               box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    model = sn_model(torch, dev, torch.bfloat16, True)
    before = ts.launches_bwd2
    t = time.perf_counter()
    res = Run3D().run(mols[:192], mols[192:288], mols[288:], model,
                      ThreeDEvaluator(), epochs=1, batch_size=96,
                      vt_batch_size=96, energy_and_force=True,
                      slot_size=SN_KW["block_size"], device=dev)
    torch.cuda.synchronize()
    n = ts.launches_bwd2 - before
    log(f"  Run3D epoch: best valid MAE {res['best_valid']:.5f}, test "
        f"{res['best_test']:.5f}; {n} second-order launches; "
        f"{time.perf_counter() - t:.1f} s")
    if not (math.isfinite(res["best_valid"])
            and math.isfinite(res["best_test"])):
        fail("Run3D energy_and_force: non-finite MAE")
    if n != 2 * SN_KW["num_layers"]:
        fail(f"Run3D: {n} second-order launches, expected "
             f"{2 * SN_KW['num_layers']}")


def sf_bwd2_bounds(args, ct, work, prec):
    """Least time for one second-order call's work at this data: real
    triplets only. Bytes, in the types the function takes and returns (as
    the JAX _run_bwd2 declares them, not the kernel's float32 staging): the
    x and u1 rows and the pt and u2 columns real triplets gather, the
    cotangent rows of the edges that own one, m2T, lj and the weights in
    full in; xb (x's type), ctb (ct's type), all of ptb (pt's type) and
    wsb, wtb (the weights' type) out. Operations per real triplet: the
    four basis products sv, tv, dsv, dtv (4 C NB), the weight gradients
    (4 C NB) and the basis cotangents (4 C NB), about 18 C for the
    per-channel products and 8 NB for the product rules of sbf and tbf."""
    x, pt, ws, wt, m2t, lj = args
    C, R = x.shape[1], pt.shape[1]
    NB = ws.shape[0] + (wt.shape[0] if wt.shape[0] > 1 else 0)
    T = work["triplets"]
    el = lambda t: t.numel() * t.element_size()
    w = el(ws) + el(wt)
    nbytes = (2 * work["x_rows"] * C * x.element_size()
              + 2 * T * R * pt.element_size()
              + work["edges"] * C * ct.element_size()
              + el(m2t) + el(lj) + w
              + el(x) + el(ct) + el(pt) + w)
    flops = T * (12 * C * NB + 18 * C + 8 * NB)
    t_ops = flops / PEAK_FLOPS[prec]
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def phase_sf_times(torch, ts, inputs):
    K = SN_KW["nk_degree"]
    rows = []
    for A, inp in inputs.items():
        for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            args, ct, us, cfg = bwd2_args(torch, inp, True, dt, False)
            k_args = ts._kernel_inputs(*args, A, K, cfg)
            ct32 = ct.float().contiguous()
            kern = lambda: ts.triplet_slot_bwd2_kernel(*k_args, ct32, *us, A,
                                                       K, cfg)
            ms = cuda_ms(torch, kern)
            split = kernel_split(torch, kern, SECOND_ORDER_KERNELS)
            plain = cuda_ms(torch, lambda: ts.fused_triplet_slot_bwd2_reference(
                *args, ct, *us, A, K, cfg), iters=3, warmup=1)
            b = sf_bwd2_bounds(args, ct, inp["work"], prec)
            rows.append({"kernel": "triplet_slot_bwd2", "A": A,
                         "E": args[0].shape[0], "precision": prec, "ms": ms,
                         "split": split, "plain_ms": plain, "bound_ms": b[0],
                         "bound_by": b[1], "flops": b[2], "bytes": b[3],
                         "triplets": inp["work"]["triplets"]})
            # the backward at the bucket, as the force step runs it: with
            # dpt in the inner pass, without in the outer
            for need_dpt in (True, False):
                ms = cuda_ms(torch, lambda: ts.triplet_slot_backward_kernel(
                    *k_args, ct32, A, K, cfg, need_dpt))
                plain = cuda_ms(torch, lambda: ts.fused_triplet_slot_bwd_reference(
                    *args, ct, A, K, cfg, need_dpt), iters=3, warmup=1)
                b = sn_bounds(args, inp["work"], prec, "bwd", need_dpt)
                rows.append({"kernel": "triplet_slot_bwd", "A": A,
                             "E": args[0].shape[0], "precision": prec,
                             "need_dpt": need_dpt, "ms": ms, "split": None,
                             "plain_ms": plain, "bound_ms": b[0],
                             "bound_by": b[1], "flops": b[2], "bytes": b[3],
                             "triplets": inp["work"]["triplets"]})
    for r in rows:
        dpt = "" if r["split"] is not None else f" need_dpt={r['need_dpt']}"
        log(f"  {r['kernel']} A={r['A']} E={r['E']} {r['precision']}{dpt} "
            f"({r['triplets']} real triplets): {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.4f} of it; {r['flops'] / 1e9:.3f} "
            f"GFLOP, {r['bytes'] / 1e6:.2f} MB; plain {r['plain_ms']:.3f} ms)"
            + ("" if r["split"] is None else f"; {split_text(r['split'])}"))
    return rows


def split_text(split):
    """A second order's per-kernel device ms as one phrase."""
    if not any(split.values()):
        return "by kernel: not measured (torch.profiler recorded no device time)"
    return "by kernel (torch.profiler) " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())


def geom_bwd2_split(torch, ts, dev):
    """The geometry second order's device ms by kernel at path 7a's shape
    (phase 25's inputs, bf16 and f32, u1 = u4 = u5 absent), taken right
    after phase 11's splits: in a process that has run much device work
    since its first profiling window torch.profiler drops device records
    (a split taken at phase 28 read 0), so every split is taken in one
    stretch and phase 28 prints this one."""
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    inp = ga_kernel_inputs(torch, dev, ga_batches(torch, dev, GA_STEPS)[-1])
    splits = {}
    for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        args, cfg = ga_args(torch, inp, True, dt)
        k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
        ct32 = inp["ct"].to(dt).float().contiguous()
        splits[prec] = kernel_split(
            torch, lambda: ts.triplet_slot_geom_bwd2_kernel(
                *k_args, ct32, None, inp["ug"], None, None, A, K, cfg),
            SECOND_ORDER_KERNELS)
    return splits


# ---------------------------------------------------------------------------
# The flat layout: sorted-CSR segment sum, flat SchNet and SphereNet
# ---------------------------------------------------------------------------

def fs_molecules(n, seed=0):
    """run_morse_surrogate.py's data: Morse molecules of 12-29 atoms, the
    targets standardised to unit variance (forces by the same scale)."""
    import numpy as np
    from dig_tpu_torch.datasets import synthetic_morse_molecules
    mols = synthetic_morse_molecules(n, seed=seed, min_atoms=12, max_atoms=29)
    ys = np.array([m["y"][0] for m in mols])
    mu, sd = ys.mean(), ys.std()
    for m in mols:
        m["y"] = ((m["y"][:1] - mu) / sd).astype(np.float32)
        m["force"] = (m["force"] / sd).astype(np.float32)
    return mols


def fs_batches(torch, dev, n):
    from dig_tpu_torch.datasets import MoleculeLoader
    mols = fs_molecules(FS_G * (n + 1))
    it = iter(MoleculeLoader(mols, FS_G, slot_size=FS_SLOT, shuffle=True,
                             seed=0, device=dev))
    return [next(it) for _ in range(n)]


def sp_batches(torch, dev, n):
    """The tutorial's batches of 32 synthetic molecules (12-29 atoms, 6 A
    box); the target is the first column of y."""
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    mols = synthetic_molecules(SP_G * (n + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    it = iter(MoleculeLoader(mols, SP_G, shuffle=True, seed=0, device=dev))
    return [b.replace_globals(energy=b.globals["y"][:, :1])
            for b in (next(it) for _ in range(n))]


def flat_csr(torch, g, kw):
    """What the model's edge->node sum sees for batch g: the receivers of
    the flat radius graph as the sum's ids (-1 at padding), rowptr, the
    uncapped in-cutoff pairs (as Run3D counts them), radius_overflow,
    csr_block_overflow at the model's segment_eb, and the largest
    in-degree."""
    from dig_tpu_torch.ops.radius import (_pairwise_same_graph,
                                          radius_graph_flat, radius_overflow)
    from dig_tpu_torch.ops.segment_csr import csr_block_overflow
    pos, ng, nm = g.nodes["pos"], g.node_graph, g.node_mask
    N = g.num_nodes
    _, recv, emask = radius_graph_flat(pos, ng, nm, kw["cutoff"],
                                       kw["max_edges"])
    seg = torch.where(emask, recv, -1)
    rowptr = torch.searchsorted(
        torch.where(emask, recv, N),
        torch.arange(N + 1, dtype=torch.int32, device=pos.device),
        out_int32=True)
    d2, valid = _pairwise_same_graph(pos, ng, nm)
    adj = valid & (d2 < kw["cutoff"] ** 2)
    return {"seg": seg, "rowptr": rowptr, "N": N,
            "pairs": int(adj.sum()),
            "radius_overflow": int(radius_overflow(pos, ng, nm, kw["cutoff"],
                                                   kw["max_edges"])),
            "block_overflow": int(csr_block_overflow(rowptr, N, 32,
                                                     kw["segment_eb"])),
            "max_degree": int(adj.sum(1).max())}


def port_csr(out):
    """The (ids, row pointer) that the port's sorted-CSR autograd node
    under ``out`` saved: what its sum (or the gather's adjoint) runs on."""
    todo = [out.grad_fn]
    while todo:
        node = todo.pop(0)
        if node is None:
            continue
        if type(node).__name__ in ("_RowGatherBackward",
                                   "_SegmentSumSortedCSRBackward"):
            return node.saved_tensors[:2]
        todo += [n for n, _ in node.next_functions]
    fail("no sorted-CSR node under the output")


def model_csr(torch, dev, fs_g, sp_g):
    """The ids and row pointers of the main paths' other segment sums, made
    by the port's own gather_rows and readout_sum on real batches: (name,
    ids, rowptr, N, F, dtype). Path 4a: the adjoint of the senders' row
    gather (models/schnet.py:81, F = 128) and of the two position gathers
    of edge_distances (F = 3): the flat edge list pads with node 0, so row
    0 of both holds every padding edge; the readout (F = 1). Path 4b: the
    readout (F = 1; its last graph's range runs through the batch's padding
    rows), the adjoint of the first block's sender gather and of the
    embedding gather (models/spherenet.py:207, F = 128). Path 3 (the
    24-atom bucket) and path 5a: the embedding gather's adjoint in bf16 and
    path 3's readout."""
    from dig_tpu_torch.ops.radius import radius_graph_flat
    from dig_tpu_torch.ops.segment import gather_rows, readout_sum

    def gather(idx, N, F, dt=torch.float32):
        x = torch.zeros(N, F, device=dev, dtype=dt, requires_grad=True)
        return port_csr(gather_rows(x, idx))

    def readout(g):
        h = torch.zeros(g.num_nodes, 1, device=dev, requires_grad=True)
        return port_csr(readout_sum(h, g.node_graph, g.num_graphs,
                                    g.node_mask))

    cases = []
    for tag, g, kw in (("4a", fs_g, FS_KW), ("4b", sp_g, SP_KW)):
        send, recv, _ = radius_graph_flat(g.nodes["pos"], g.node_graph,
                                          g.node_mask, kw["cutoff"],
                                          kw["max_edges"])
        N = g.num_nodes
        cases.append((f"{tag}_sender_adjoint", *gather(send, N, 128), N,
                      128, torch.float32))
        if tag == "4a":
            for name, idx in (("send", send), ("recv", recv)):
                cases.append((f"4a_position_adjoint_{name}",
                              *gather(idx, N, 3), N, 3, torch.float32))
        else:
            cases.append(("4b_embedding_adjoint",
                          *gather(g.nodes["z"], 95, 128), 95, 128,
                          torch.float32))
        cases.append((f"{tag}_readout", *readout(g), g.num_graphs, 1,
                      torch.float32))
    sf_g = sf_batches(torch, dev, 1)[0][24]
    nk_g = nk_batches(torch, dev, 1)[0]
    for tag, g in (("3", sf_g), ("5a", nk_g)):
        cases.append((f"{tag}_embedding_adjoint",
                      *gather(g.nodes["z"], 95, 128, torch.bfloat16), 95,
                      128, torch.bfloat16))
    cases.append(("3_readout", *readout(sf_g), sf_g.num_graphs, 1,
                  torch.bfloat16))
    return cases


def seg_cases(torch, dev, fs_b, sp_b):
    """Inputs of the segment sum: each flat path's real receivers with
    seeded random edge rows at its width (F = 128: SchNet's filters,
    SphereNet's hidden channels), in the types its path uses; the main
    paths' gather adjoints and readouts (model_csr) with seeded rows; and a
    skewed random CSR (one row holds a quarter of 20,000 edges, every 50th
    row empty, a -1 tail) at F = 24 and 128."""
    from dig_tpu_torch.ops.segment_csr import full_window
    gen = torch.Generator(device="cpu").manual_seed(5)
    cases = []
    for name, g, kw, dts in (("schnet_4a", fs_b, FS_KW, (torch.float32,)),
                             ("spherenet_4b", sp_b, SP_KW,
                              (torch.float32, torch.bfloat16))):
        c = flat_csr(torch, g, kw)
        data = torch.randn(c["seg"].shape[0], 128, generator=gen).to(dev)
        for dt in dts:
            cases.append(dict(c, name=name, data=data.to(dt),
                              eb=kw["segment_eb"]))
    for name, seg, rp, N, F, dt in model_csr(torch, dev, fs_b, sp_b):
        data = torch.randn(seg.shape[0], F, generator=gen).to(dev, dt)
        cases.append({"name": name, "seg": seg.detach(), "rowptr": rp.detach(),
                      "N": N, "data": data, "eb": full_window(seg.shape[0])})
    N, E = 1000, 20000
    rows = torch.randint(0, N, (E,), generator=gen)
    rows = rows[rows % 50 != 7]
    rows[: E // 4] = 123
    seg = torch.sort(rows).values.to(torch.int32)
    rowptr = torch.searchsorted(seg, torch.arange(N + 1, dtype=torch.int32),
                                out_int32=True)
    seg = torch.cat([seg, torch.full((512,), -1, dtype=torch.int32)]).to(dev)
    for F in (24, 128):
        for dt in (torch.float32, torch.bfloat16):
            data = torch.randn(seg.shape[0], F, generator=gen).to(dev, dt)
            cases.append({"name": "skewed", "seg": seg,
                          "rowptr": rowptr.to(dev), "N": N, "data": data,
                          "eb": 8192})
    return cases


def seg_shape(sc, E, F, N, dtype, eb):
    """A segment-sum call's key: edges, width, rows, data type, and whether
    its window holds every edge (the gathers' adjoints and the readouts) or
    is the model's segment_eb (the edge->node sums)."""
    return (E, F, N, str(dtype)[6:], eb >= sc.full_window(E))


class SegmentCalls:
    """Notes each segment-sum call's seg_shape, in call order, while active,
    by wrapping segment_csr_kernel (the call each sum of the autograd pair
    makes on the card), and each shape's first row pointer and ids;
    sc.launches counts as before."""

    def __init__(self, sc):
        self.sc, self.calls, self.rowptr, self.ids = sc, [], {}, {}

    def __enter__(self):
        self.orig = orig = self.sc.segment_csr_kernel

        def noted(data, seg_ids, rowptr, num_rows, block_rows, eb):
            key = seg_shape(self.sc, *data.shape, num_rows, data.dtype, eb)
            self.calls.append(key)
            self.rowptr.setdefault(key, rowptr)
            self.ids.setdefault(key, seg_ids)
            return orig(data, seg_ids, rowptr, num_rows, block_rows, eb)
        self.sc.segment_csr_kernel = noted
        return self

    def __exit__(self, *exc):
        self.sc.segment_csr_kernel = self.orig

    def per_step(self, steps):
        """Calls a step by shape."""
        return {k: self.calls.count(k) / steps for k in set(self.calls)}


def phase_seg_kernel_vs_plain(torch, sc, cases):
    """Every case: kernel against plain, one launch, a repeated call the
    same bits; the closed pair to second order in f32. Returns the largest
    absolute error over path 4a's shapes."""
    err_4a = 0.0
    for c in cases:
        seg, rp, N, data = c["seg"], c["rowptr"], c["N"], c["data"]
        before = sc.launches
        out = sc.segment_sum_sorted_csr(data, seg, rp, N, 32, c["eb"])
        torch.cuda.synchronize()
        if sc.launches != before + 1:
            fail(f"segment sum {c['name']}: {sc.launches - before} launches")
        want = sc.segment_sum_sorted_csr_reference(data, seg, rp, N)
        e = rel_err(out, want)
        again = sc.segment_sum_sorted_csr(data, seg, rp, N, 32, c["eb"])
        same = torch.equal(again, out)
        log(f"  {c['name']} N={N} E={data.shape[0]} F={data.shape[1]} "
            f"{str(data.dtype)[6:]}: rel err {e:.3e}; repeated call the same "
            f"bits: {same}")
        if e >= SEG_TOL or out.dtype != torch.float32:
            fail(f"segment sum {c['name']}: rel err {e} >= {SEG_TOL}")
        if not same:
            fail(f"segment sum {c['name']} not bitwise repeatable")
        if c["name"].startswith(("schnet_4a", "4a_")):
            err_4a = max(err_4a, float((out - want).abs().max()))
        if data.dtype != torch.float32:
            continue
        gen = torch.Generator(device="cpu").manual_seed(6)
        cw = torch.randn(N, data.shape[1], generator=gen).to(data.device)
        v = torch.randn(*data.shape, generator=gen).to(data.device)
        res = []
        for fn in (lambda d: sc.segment_sum_sorted_csr(d, seg, rp, N, 32,
                                                       c["eb"]),
                   lambda d: sc.segment_sum_sorted_csr_reference(d, seg, rp,
                                                                 N)):
            d = data.clone().requires_grad_()
            o = fn(d)
            (g1,) = torch.autograd.grad(torch.sum(cw * o * o), d,
                                        create_graph=True)
            (g2,) = torch.autograd.grad(torch.sum(g1 * v * d), d)
            res.append((g1.detach(), g2))
        e1, e2 = rel_err(res[0][0], res[1][0]), rel_err(res[0][1], res[1][1])
        log(f"    closed pair: first derivative rel err {e1:.3e}, second "
            f"{e2:.3e}")
        if e1 >= SEG_TOL or e2 >= SEG_TOL2:
            fail(f"segment sum {c['name']} derivatives: {e1}, {e2}")
    log(f"  max abs err over path 4a's shapes: {err_4a:.3e}")
    return err_4a


def fs_model(torch, dev, segment_eb):
    from dig_tpu_torch.models import SchNet
    return SchNet(**dict(FS_KW, segment_eb=segment_eb),
                  generator=torch.Generator().manual_seed(0), device=dev)


def sp_model(torch, dev, segment_eb):
    from dig_tpu_torch.models import SphereNet
    return SphereNet(**dict(SP_KW, segment_eb=segment_eb),
                     generator=torch.Generator().manual_seed(0), device=dev)


def check_flat_batches(torch, batches, kw, what):
    """Per batch: the flat_csr audit; fails on any dropped edge."""
    csr = [flat_csr(torch, b, kw) for b in batches]
    for key in ("radius_overflow", "block_overflow"):
        if any(c[key] for c in csr):
            fail(f"{what}: {key} {[c[key] for c in csr]}")
    log(f"  radius_overflow 0 and csr_block_overflow 0 in all "
        f"{len(batches)} batches; in-cutoff pairs per batch "
        f"{min(c['pairs'] for c in csr)}-{max(c['pairs'] for c in csr)} of "
        f"max_edges {kw['max_edges']}; largest in-degree "
        f"{max(c['max_degree'] for c in csr)}")
    return csr


def reset_all(cf, ts, sc):
    cf.reset_launch_counts()
    ts.reset_launch_counts()
    sc.reset_launch_counts()


def others_idle(cf, ts, what):
    counts = (cf.launches_fwd, cf.launches_bwd, ts.launches_fwd,
              ts.launches_bwd, ts.launches_bwd2)
    if any(counts):
        fail(f"{what}: kernels of other paths launched {counts}")


def timed_steps(torch, train_step, batches, warmup):
    losses, t_start = [], None
    for s, b in enumerate(batches):
        if s == warmup:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(train_step(b)["loss"])
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t_start


def phase_fs_main_path(torch, cf, ts, sc, dev, batches):
    from dig_tpu_torch.threed import ThreeDEvaluator
    from dig_tpu_torch.train import make_step_fns
    csr = check_flat_batches(torch, batches, FS_KW, "path 4a")
    step_errs = first_step_vs_plain(
        torch, ("kernel", "index_add_"),
        lambda cd, k: fs_model(torch, dev, FS_KW["segment_eb"] if k else 0),
        lambda m, opt: make_step_fns(m, opt, energy_and_force=True, p=FS_P,
                                     loss="l1")[0],
        batches[0], {"f32": FLAT_STEP_TOL})
    model = fs_model(torch, dev, FS_KW["segment_eb"])
    opt = torch.optim.Adam(model.parameters(), lr=FS_LR)
    train_step, eval_step = make_step_fns(model, opt, energy_and_force=True,
                                          p=FS_P, loss="l1")
    reset_all(cf, ts, sc)
    with SegmentCalls(sc) as calls:
        losses, dt = timed_steps(torch, train_step, batches, FS_WARMUP)
    launches = sc.launches
    others_idle(cf, ts, "path 4a")
    want = (4 * FS_KW["num_layers"] + 2) * len(batches)
    log(f"  {len(batches)} Adam steps, losses {[round(x, 4) for x in losses]}")
    log(f"  segment-sum launches {launches} ((4 x layers + 2) x steps = "
        f"{want}: per layer the edge->node sum in the forward and in the "
        f"outer backward, where the force graph's row gathers re-enter it, "
        f"and the sender gather's adjoint in the inner and the outer "
        f"backward; the readout, and the inner backward's adjoints of the "
        f"two position gathers of the edge lengths)")
    if not all(math.isfinite(x) for x in losses):
        fail("path 4a: non-finite loss")
    if launches != want:
        fail(f"path 4a: {launches} segment-sum launches, expected {want}")
    out = eval_step(batches[0])
    if not bool(torch.isfinite(out["force_pred"]).all()):
        fail("path 4a: non-finite forces")
    m = out["graph_mask"]
    mae = ThreeDEvaluator().eval({"y_pred": out["y_pred"][m],
                                  "y_true": batches[0].globals["y"][m]})["mae"]
    if not math.isfinite(mae):
        fail("path 4a: non-finite eval MAE")
    timed = len(batches) - FS_WARMUP
    pairs = sum(c["pairs"] for c in csr[FS_WARMUP:])
    step_ms = dt / timed * 1e3
    log(f"  eval: forces finite (largest |F| "
        f"{float(out['force_pred'].abs().max()):.4g}), energy MAE {mae:.5f}")
    log(f"  force step {step_ms:.3f} ms (mean of {timed} steps); "
        f"{pairs / dt:.6g} edges/s over {pairs / timed:.0f} in-cutoff "
        f"pairs per step (as Run3D counts them)")
    return {"launches": launches, "steps": len(batches), "losses": losses,
            "step_ms": step_ms, "edges_per_s": pairs / dt,
            "pairs_per_step": pairs / timed, "first_step": step_errs,
            "eval_mae": mae, "by_shape": calls.per_step(len(batches))}


def phase_fs_run3d(torch, sc, dev):
    """One Run3D epoch as run_morse_surrogate.py calls it: 4 training
    batches of 24, one validation and one test batch."""
    from dig_tpu_torch.threed import Run3D, ThreeDEvaluator
    mols = fs_molecules(FS_G * 6, seed=1)
    model = fs_model(torch, dev, FS_KW["segment_eb"])
    sc.reset_launch_counts()
    t = time.perf_counter()
    res = Run3D().run(mols[:4 * FS_G], mols[4 * FS_G:5 * FS_G],
                      mols[5 * FS_G:], model,
                      ThreeDEvaluator(), epochs=1, batch_size=FS_G,
                      vt_batch_size=FS_G, lr=FS_LR, lr_decay_factor=0.5,
                      lr_decay_step_size=15, energy_and_force=True, p=FS_P,
                      slot_size=FS_SLOT, device=dev)
    torch.cuda.synchronize()
    n, L = sc.launches, FS_KW["num_layers"]
    # 4 force steps, 2 evaluation batches (a forward and its backward for
    # the forces)
    want = 4 * (4 * L + 2) + 2 * (2 * L + 2)
    log(f"  Run3D epoch: best valid MAE {res['best_valid']:.5f}, test "
        f"{res['best_test']:.5f}; {n} segment-sum launches (expected {want}:"
        f" {4 * L + 2} per training step, {2 * L + 2} per evaluation "
        f"batch); {time.perf_counter() - t:.1f} s")
    if not (math.isfinite(res["best_valid"])
            and math.isfinite(res["best_test"])):
        fail("Run3D flat SchNet: non-finite MAE")
    if n != want:
        fail(f"Run3D flat SchNet: {n} segment-sum launches, expected {want}")


def phase_sp_main_path(torch, cf, ts, sc, dev, batches):
    from dig_tpu_torch.threed import ThreeDEvaluator
    from dig_tpu_torch.train import make_step_fns
    csr = check_flat_batches(torch, batches, SP_KW, "path 4b")
    if max(c["max_degree"] for c in csr) > SP_KW["max_in_degree"]:
        fail("path 4b: an in-degree exceeds max_in_degree")
    step_errs = first_step_vs_plain(
        torch, ("kernel", "index_add_"),
        lambda cd, k: sp_model(torch, dev, SP_KW["segment_eb"] if k else 0),
        lambda m, opt: make_step_fns(m, opt, loss="l1",
                                     target_key="energy")[0],
        batches[0], {"f32": FLAT_STEP_TOL})
    model = sp_model(torch, dev, SP_KW["segment_eb"])
    opt = torch.optim.Adam(model.parameters(), lr=SP_LR)
    train_step, eval_step = make_step_fns(model, opt, loss="l1",
                                          target_key="energy")
    torch.cuda.reset_peak_memory_stats()
    reset_all(cf, ts, sc)
    with SegmentCalls(sc) as calls:
        losses, dt = timed_steps(torch, train_step, batches, SP_WARMUP)
    launches = sc.launches
    others_idle(cf, ts, "path 4b")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (2 * SP_KW["num_layers"] + 5) * len(batches)
    log(f"  {len(batches)} Adam steps, losses {[round(x, 5) for x in losses]}")
    log(f"  segment-sum launches {launches} ((2 x layers + 5) x steps = "
        f"{want}: the layers + 1 edge->node sums, the layers + 1 readouts, "
        f"the adjoints of the embedding gather and of the two row gathers "
        f"of the first block); peak device memory {peak:.2f} GiB")
    if not all(math.isfinite(x) for x in losses):
        fail("path 4b: non-finite loss")
    if launches != want:
        fail(f"path 4b: {launches} segment-sum launches, expected {want}")
    out = eval_step(batches[0])
    m = out["graph_mask"]
    mae = ThreeDEvaluator().eval({"y_pred": out["y_pred"][m],
                                  "y_true": batches[0].globals["energy"][m]}
                                 )["mae"]
    if not math.isfinite(mae):
        fail("path 4b: non-finite eval MAE")
    timed = len(batches) - SP_WARMUP
    pairs = sum(c["pairs"] for c in csr[SP_WARMUP:])
    step_ms = dt / timed * 1e3
    log(f"  eval MAE {mae:.5f} over {int(m.sum())} molecules")
    log(f"  step {step_ms:.3f} ms (mean of {timed} steps); "
        f"{pairs / dt:.6g} edges/s over {pairs / timed:.0f} in-cutoff pairs "
        f"per step")
    return {"launches": launches, "steps": len(batches), "losses": losses,
            "step_ms": step_ms, "edges_per_s": pairs / dt,
            "pairs_per_step": pairs / timed, "first_step": step_errs,
            "eval_mae": mae, "peak_gib": peak,
            "by_shape": calls.per_step(len(batches))}


def seg_bound(c):
    """Least time for one call at this data: the counted edge rows, their
    ids and the row pointers read once, the float32 output written once
    (bytes); one add per element of a counted row (operations, f32)."""
    nnz = int(((c["seg"] >= 0)).sum())
    F = c["data"].shape[1]
    nbytes = (nnz * F * c["data"].element_size() + 4 * nnz
              + 4 * (c["N"] + 1) + 4 * c["N"] * F)
    t_bytes, t_ops = nbytes / PEAK_BYTES, nnz * F / PEAK_FLOPS["f32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nnz, nbytes)


def seg_path(name):
    """The flat path whose step makes a case's calls (None: another path's
    shape, or the skewed CSR)."""
    for path, prefixes in (("4a", ("schnet_4a", "4a_")),
                           ("4b", ("spherenet_4b", "4b_"))):
        if name.startswith(prefixes):
            return path
    return None


def seg_time_row(torch, sc, c):
    """One case's times (see phase_seg_times): the bare launch, its plain
    version, the library calls, the host-clocked launch and wrapper, the
    bound."""
    seg, rp, N, data = c["seg"], c["rowptr"], c["N"], c["data"]
    launch = lambda: sc.segment_csr_launch(data, seg, rp, N)
    k_ms = device_ms(torch, launch)
    issued_ms = cuda_ms(torch, launch)
    w_ms = cuda_ms(torch, lambda: sc.segment_csr_kernel(
        data, seg, rp, N, 32, c["eb"]))
    plain_ms = device_ms(torch, lambda: sc.segment_sum_sorted_csr_reference(
        data, seg, rp, N))
    bound_ms, by, nnz, nbytes = seg_bound(c)
    keep = seg >= 0
    real, idx = data[keep].contiguous(), seg[keep].long()
    offsets = torch.searchsorted(idx, torch.arange(N + 1, device=idx.device))
    lib = {"index_add_": device_ms(torch, lambda: torch.zeros(
        N, data.shape[1], dtype=data.dtype, device=data.device
    ).index_add_(0, idx, real))}
    try:
        lib["segment_reduce"] = device_ms(torch, lambda: torch.segment_reduce(
            real, "sum", offsets=offsets, axis=0))
    except RuntimeError as exc:          # a yardstick only, not the port
        log(f"  torch.segment_reduce does not run here: "
            f"{str(exc).splitlines()[0]}")
    best = min(lib, key=lib.get)
    span = (rp[1:].clamp(max=seg.shape[0]) - rp[:-1].clamp(min=0))
    return {"case": c["name"], "dtype": str(data.dtype)[6:], "N": N,
            "E": data.shape[0], "nnz": nnz, "F": data.shape[1],
            "longest": int(span.max()),
            "key": seg_shape(sc, *data.shape, N, data.dtype, c["eb"]),
            "ms": k_ms, "issued_ms": issued_ms, "wrapper_ms": w_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "bytes": nbytes, "library": lib, "library_ms": lib[best],
            "library_call": best}


def seg_log_row(r):
    libs = ", ".join(f"{k} {v:.4f} ms" for k, v in r["library"].items())
    log(f"  segment_sum_sorted_csr {r['case']} {r['dtype']} N={r['N']} "
        f"E={r['E']} ({r['nnz']} counted, longest row range "
        f"{r['longest']}) F={r['F']}: kernel "
        f"{r['ms']:.4f} ms (bound {r['bound_ms']:.5f} ms by "
        f"{r['bound_by']}, {r['bytes'] / 1e6:.3f} MB, "
        f"{r['bound_ms'] / r['ms']:.3f} of it); plain {r['plain_ms']:.4f}"
        f" ms; {libs}; host-clocked: kernel as issued "
        f"{r['issued_ms']:.4f} ms, checked wrapper {r['wrapper_ms']:.4f}"
        f" ms" + (f"; calls a step of path {r['path']}: {r['per_step']:g}"
                  if r.get("path") else ""))


def phase_seg_times(torch, sc, cases, by_shape):
    """Per call at every case's shape, device time with the host ahead
    (device_ms): the bare launch, its plain version, and the PyTorch calls
    that compute the same sum over the counted edges (taken out of the
    data before timing): index_add_ into zeros, and segment_reduce over
    their row offsets where it runs (library_ms is the faster one). Beside
    them, host-clocked: the launch at the rate the host issues it, and the
    checked wrapper the path calls (input checks and the overflow audit
    read on the host). ``by_shape`` maps a flat path to its calls a step
    by seg_shape (phases 13 and 14); each path's step total sums, per
    shape, its calls a step times the mean of its cases' times."""
    rows = []
    for c in cases:
        r = seg_time_row(torch, sc, c)
        path = seg_path(c["name"])
        r.update(path=path, per_step=by_shape.get(path, {}).get(r["key"], 0))
        rows.append(r)
    for r in rows:
        seg_log_row(r)
    totals = {}
    for path in ("4a", "4b"):
        keys = {r["key"] for r in rows if r["path"] == path}
        tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
        for key in keys:
            same = [r for r in rows if r["path"] == path and r["key"] == key]
            for f in tot:
                tot[f] += (by_shape[path].get(key, 0)
                           * sum(r[f] for r in same) / len(same))
        missed = set(by_shape[path]) - keys
        if missed:
            fail(f"path {path}: segment sums of shapes no case times: "
                 f"{sorted(missed)}")
        tot["bound_by"] = max((r for r in rows if r["path"] == path),
                              key=lambda r: r["bound_ms"])["bound_by"]
        totals[path] = tot
        log(f"  path {path} step, every segment sum ({sum(by_shape[path].values()):g}"
            f" calls): kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f}"
            f" ms, plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms")
    return rows, totals


# ---------------------------------------------------------------------------
# The unblocked NK layout: fused_triplet_product / fused_angle_product
# ---------------------------------------------------------------------------

def nk_batches(torch, dev, n):
    """Paths 5a and 5b: MoleculeLoader batches of 96 synthetic molecules
    (12-29 atoms, 6 A box, seeded forces) at the loader's default pad of
    96 x 29 node rows; the target is the first column of y."""
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    mols = synthetic_molecules(NK_G * (n + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    it = iter(MoleculeLoader(mols, NK_G, shuffle=True, seed=0, device=dev))
    return [next(it) for _ in range(n)]


def nk_model(torch, dev, cd, fused, path):
    """The SphereNet of paths 5a / 6a or the DimeNet++ of paths 5b / 6b on
    the unblocked table, the fused branch or the unfused one: on paths 5a
    and 5b ``pallas_triplet`` (the triplet product), on 6a and 6b
    ``pallas_triplet`` with ``pallas_fuse_basis`` (the packed basis)."""
    from dig_tpu_torch.models import DimeNetPP, SphereNet
    M, kw = {"5a": (SphereNet, NK_KW), "5b": (DimeNetPP, DP_KW),
             "6a": (SphereNet, NK_KW), "6b": (DimeNetPP, DP6_KW)}[path]
    packed = dict(pallas_fuse_basis=fused) if path in PT_PATHS else {}
    return M(**kw, **packed, pallas_triplet=fused, compute_dtype=cd,
             generator=torch.Generator().manual_seed(0), device=dev)


def nk_pair_counts(torch, b, geo, cutoff=5.0):
    """(uncapped in-cutoff directed pairs, their largest in-degree, NK
    edges kept by the K-table after the symmetrisation)."""
    from dig_tpu_torch.ops.radius import _pairwise_same_graph
    d2, valid = _pairwise_same_graph(b.nodes["pos"], b.node_graph,
                                     b.node_mask)
    adj = valid & (d2 < cutoff * cutoff)
    return (int(adj.sum()), int(adj.sum(1).max()),
            int(geo.nkg.edge_mask.sum()))


def nk_kernel_inputs(torch, dev, batch, path):
    """The operands of the path's triplet product at one layer from a real
    batch: sbf (and tbf) and the triplet mask of the model's own geometry,
    xg the raw expand_kj_raw gather of seeded edge rows (garbage at masked
    triplets, as on the path), seeded weights at the path's widths, output
    cotangent and second-order cotangents u1..u5; all float32. ``work``
    counts the real triplets and the edges that own one."""
    from dig_tpu_torch.ops.triplets import expand_kj_raw
    model = nk_model(torch, dev, torch.float32, True, path)
    with torch.no_grad():
        geo = model.geometry(batch.nodes["pos"], batch)
        sbf, tbf = model.bases(geo)
        K = model.nk_degree
        E = geo.nkg.senders.shape[0]
        gen = torch.Generator(device="cpu").manual_seed(7)
        r = lambda *s: torch.randn(*s, generator=gen).to(dev)
        xg = expand_kj_raw(r(E, NK_C), geo.trip)
    S1, S2 = sbf.shape[1], (0 if tbf is None else tbf.shape[1])
    m2d = geo.trip.mask.reshape(E, K).float()
    T = E * K
    inp = {"xg": xg, "sbf": sbf, "tbf": tbf, "ws": r(S1, NK_C) * S1 ** -0.5,
           "wt": r(S2, NK_C) * S2 ** -0.5 if S2 else None, "m2d": m2d,
           "ct": r(E, NK_C), "K": K,
           "us": [r(T, NK_C), r(T, S1), r(T, S2) if S2 else None,
                  r(S1, NK_C), r(S2, NK_C) if S2 else None],
           "work": {"triplets": int(m2d.sum()),
                    "edges": int((m2d != 0).any(1).sum())}}
    return inp


def nk_args(torch, inp, dt):
    """(xg, sbf, tbf, ws, wt, m2d) in the path's compute type ``dt``."""
    c = lambda t: None if t is None else t.to(dt)
    return [c(inp[k]) for k in ("xg", "sbf", "tbf", "ws", "wt", "m2d")]


def nk_vjp(torch, tp, args, ct, K, basis):
    """The op's output and its gradients with respect to (xg, sbf, tbf,
    ws, wt) through the autograd tower (None for an absent input)."""
    xs = [None if a is None else a.clone().requires_grad_()
          for a in args[:5]]
    out = tp.fused_triplet_product(*xs, args[5], K, basis_grads=basis)
    live = [x for x in xs if x is not None]
    g = iter(torch.autograd.grad(out, live, ct))
    return out, [None if x is None else next(g) for x in xs]


def phase_nk_kernel_vs_plain(torch, tp, inputs):
    """Every kernel against its plain version at paths 5a's and 5b's
    shapes, f32 and bf16: the forward; the backward with basis gradients on
    and off; the second order with u4 = u5 absent and with all present.
    Masked triplets' cotangent rows exactly 0; repeated calls the same
    bits. Returns the largest absolute error per kernel in the main
    paths' setting (bf16; 5a with basis gradients, u4 = u5 absent)."""
    errs = {"fwd": 0.0, "bwd": 0.0, "bwd2": 0.0}
    for path, inp in inputs.items():
        K = inp["K"]
        masked = inp["m2d"].reshape(-1) == 0
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = nk_args(torch, inp, dt)
            ct = inp["ct"].to(dt)
            line = []
            for basis in (True, False):
                out_k, g_k = nk_vjp(torch, tp, args, ct, K, basis)
                torch.cuda.synchronize()
                out_p = tp.fused_triplet_product_reference(*args[:5], K,
                                                           args[5])
                want = tp.fused_triplet_product_bwd_reference(*args, ct, K,
                                                              basis)
                e = rel_err(out_k, out_p)
                if basis:
                    line.append(f"fwd {e:.2e}")
                if out_k.dtype != dt or e >= NK_TOL[prec]:
                    fail(f"triplet_product forward {path} {prec}: rel err {e}")
                for nm, a, w in zip(("dxg", "dsbf", "dtbf", "dws", "dwt"),
                                    g_k, want):
                    if w is None:
                        continue
                    if nm in ("dsbf", "dtbf") and not basis:
                        if float(a.abs().max()) != 0.0:
                            fail(f"{nm} not 0 without basis gradients")
                        continue
                    e = rel_err(a, w)
                    line.append(f"{nm}{'' if basis else '(no basis)'} "
                                f"{e:.2e}")
                    if a.dtype != w.dtype or e >= NK_TOL[prec]:
                        fail(f"triplet_product {nm} {path} {prec} basis="
                             f"{basis}: rel err {e}")
                    if a.shape[0] == masked.shape[0] and \
                            float(a[masked].abs().max()) != 0.0:
                        fail(f"triplet_product {nm}: masked rows not 0")
                out_again, again = nk_vjp(torch, tp, args, ct, K, basis)
                if not torch.equal(out_again, out_k):
                    fail(f"triplet_product forward not bitwise repeatable "
                         f"({path}, {prec}, basis={basis})")
                if not all(a is None or torch.equal(a, b)
                           for a, b in zip(again, g_k)):
                    fail(f"triplet_product backward not bitwise repeatable "
                         f"({path}, {prec}, basis={basis})")
                if prec == "bf16" and (basis == (path == "5a")):
                    errs["fwd"] = max(errs["fwd"], float(
                        (out_k.detach() - out_p).float().abs().max()))
                    errs["bwd"] = max(errs["bwd"], max(
                        float((a.float() - w.float()).abs().max())
                        for a, w in zip(g_k, want)
                        if w is not None and a is not None))
            k_args = tp._kernel_inputs(*args, K)
            ct32 = ct.float().contiguous()
            u123 = [None if u is None else u.to(dt) for u in inp["us"][:3]]
            for all_u in (False, True):
                us = u123 + (inp["us"][3:] if all_u else [None] * 2)
                got = tp.triplet_product_bwd2_kernel(*k_args, ct32, *us, K)
                torch.cuda.synchronize()
                f = lambda t: None if t is None else t.float()
                want = tp.fused_triplet_product_bwd2_reference(
                    *(f(a) for a in args[:5]), args[5], ct32, *us, K)
                for nm, a, w in zip(("xb", "sb", "tb", "wsb", "wtb", "ctb"),
                                    got, want):
                    if w is None:
                        continue
                    if not bool(torch.isfinite(a).all()):
                        fail(f"bwd2 {nm} not finite ({path}, {prec})")
                    e = rel_err(a, w)
                    tol = NK_TOL[prec] if a.dtype == dt else NK_TOL["f32"]
                    line.append(f"{nm}{'(all u)' if all_u else ''} {e:.2e}")
                    if e >= tol:
                        fail(f"bwd2 {nm} {path} {prec} all_u={all_u}: rel "
                             f"err {e} >= {tol}")
                    if a.shape[0] == masked.shape[0] and \
                            float(a[masked].abs().max()) != 0.0:
                        fail(f"bwd2 {nm}: masked rows not 0")
                    if path == "5a" and prec == "bf16" and not all_u:
                        errs["bwd2"] = max(errs["bwd2"], float(
                            (a.float() - w.float()).abs().max()))
                again = tp.triplet_product_bwd2_kernel(*k_args, ct32, *us, K)
                if not all(a is None or torch.equal(a, b)
                           for a, b in zip(again, got)):
                    fail(f"bwd2 not bitwise repeatable ({path}, {prec})")
            log(f"  {path} E={args[5].shape[0]} K={K} S1={args[1].shape[1]} "
                f"S2={0 if args[2] is None else args[2].shape[1]} {prec}: rel "
                f"err " + ", ".join(line) + "; masked rows 0; repeated calls "
                "the same bits")
    log(f"  max abs err (bf16 as on the paths): fwd {errs['fwd']:.3e}, bwd "
        f"{errs['bwd']:.3e}, bwd2 {errs['bwd2']:.3e}")
    return errs


def phase_nk_main_path(torch, cf, ts, sc, tp, tpt, dev, batches, path):
    """Path 5a (SphereNet energy+force) or 5b (DimeNet++ energy) through
    the triplet product, or 6a (SphereNet) or 6b (DimeNet++ at its
    published widths) energy+force through the packed basis, with
    make_step_fns and Adam(5e-4), bf16: launch counts, finite losses (and
    forces), uncapped pairs beside the kept NK edges, step ms and edges/s."""
    from dig_tpu_torch.threed import ThreeDEvaluator
    from dig_tpu_torch.train import make_step_fns
    force = path != "5b"
    op, other = (tpt, tp) if path in PT_PATHS else (tp, tpt)
    op_name = "triplet_pt" if path in PT_PATHS else "triplet_product"
    step_errs = first_step_vs_plain(
        torch, ("fused", "unfused"),
        lambda cd, fused: nk_model(torch, dev, cd, fused, path),
        lambda m, opt: make_step_fns(m, opt, energy_and_force=force, p=NK_P,
                                     loss="l1")[0],
        batches[0], (DP6_STEP_TOL if path == "6b" else SF_STEP_TOL) if force
        else SN_STEP_TOL)
    model = nk_model(torch, dev, torch.bfloat16, True, path)
    with torch.no_grad():
        counts = [nk_pair_counts(torch, b, model.geometry(b.nodes["pos"], b))
                  for b in batches]
    opt = torch.optim.Adam(model.parameters(), lr=NK_LR)
    train_step, eval_step = make_step_fns(model, opt, energy_and_force=force,
                                          p=NK_P, loss="l1")
    torch.cuda.reset_peak_memory_stats()
    reset_all(cf, ts, sc)
    tp.reset_launch_counts()
    tpt.reset_launch_counts()
    warm = NK_WARMUP
    losses, dt = timed_steps(torch, train_step, batches, warm)
    launches = (op.launches_fwd, op.launches_bwd, op.launches_bwd2)
    others_idle(cf, ts, f"path {path}")
    if other.launches_fwd or other.launches_bwd or other.launches_bwd2:
        fail(f"path {path}: the other triplet kernels launched")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L, n = len(model.update_es), len(batches)
    seg = readout_launches(sc, (L + 2) * n, f"path {path}")
    want = (L * n, 2 * L * n, L * n) if force else (L * n, L * n, 0)
    log(f"  {n} Adam steps, losses {[round(x, 4) for x in losses]}")
    log(f"  {op_name} launches fwd {launches[0]} bwd {launches[1]} bwd2 "
        f"{launches[2]} (expected {want}: per step and layer one forward"
        + (", the backward in the inner create_graph pass and in the outer "
           "pass, one second order)" if force else ", one backward)")
        + f"; no other triplet kernel; segment sum {seg} ((layers + 2) x "
        f"steps: the readouts, the embedding gather's adjoint); peak device "
        f"memory {peak:.2f} GiB")
    if not all(math.isfinite(x) for x in losses):
        fail(f"path {path}: non-finite loss")
    if launches != want:
        fail(f"path {path}: {op_name} launches {launches} != {want}")
    if path in PT_PATHS:
        with_dpt = tpt.launches_bwd_dpt
        log(f"  triplet_pt backward launches with dpt {with_dpt}, without "
            f"{launches[1] - with_dpt} (per step {with_dpt // n} of "
            f"{launches[1] // n}: the inner create_graph pass needs dpt, the "
            f"outer pass does not)")
        if with_dpt != L * n:
            fail(f"path {path}: triplet_pt backward launches with dpt "
                 f"{with_dpt} != {L * n} (the inner pass's only)")
    else:
        with_basis, want_basis = tp.launches_bwd_basis, L * n if force else 0
        log(f"  triplet_product backward launches with basis cotangents "
            f"{with_basis}, without {launches[1] - with_basis} (per step "
            f"{with_basis // n} of {launches[1] // n}: "
            + ("the inner create_graph pass needs them, the outer pass does "
               "not)" if force else "pallas_basis_grads=False)"))
        if with_basis != want_basis:
            fail(f"path {path}: triplet_product backward launches with basis "
                 f"cotangents {with_basis} != {want_basis}")
    out = eval_step(batches[0])
    m = out["graph_mask"]
    mae = ThreeDEvaluator().eval({"y_pred": out["y_pred"][m],
                                  "y_true": batches[0].globals["y"][m]})["mae"]
    if not math.isfinite(mae):
        fail(f"path {path}: non-finite eval MAE")
    fmax = None
    if force:
        if not bool(torch.isfinite(out["force_pred"]).all()):
            fail(f"path {path}: non-finite forces")
        fmax = float(out["force_pred"].abs().max())
    timed = n - warm
    pairs = sum(c[0] for c in counts[warm:])
    kept = sum(c[2] for c in counts[warm:])
    step_ms = dt / timed * 1e3
    log(f"  eval: energy MAE {mae:.5f} over {int(m.sum())} molecules"
        + (f"; forces finite (largest |F| {fmax:.4g})" if force else ""))
    log(f"  step {step_ms:.3f} ms (mean of {timed} steps); {pairs / dt:.6g} "
        f"edges/s over the {pairs / timed:.0f} uncapped in-cutoff pairs per "
        f"step, {kept / dt:.6g} over the {kept / timed:.0f} NK edges kept "
        f"({1 - kept / pairs:.3f} of the pairs dropped by the K="
        f"{NK_KW['nk_degree']} top-k and the symmetrisation); largest "
        f"uncapped in-degree {max(c[1] for c in counts)}")
    return {"launches": launches, "steps": n, "losses": losses,
            "step_ms": step_ms, "edges_per_s": pairs / dt,
            "kept_edges_per_s": kept / dt, "pairs_per_step": pairs / timed,
            "kept_per_step": kept / timed, "first_step": step_errs,
            "eval_mae": mae, "peak_gib": peak}


def nk_bounds(args, inp, prec, kind, basis=True, all_u=False):
    """Least time for one call's work at this data: real triplets only
    (a masked one contributes exactly zero). Bytes, in the types the
    function takes and returns (as the JAX _run_fwd/_run_bwd/_run_bwd2
    declare them): the xg, sbf and tbf rows of each real triplet (the
    second order also u1, u2, u3's), the output cotangent rows of the
    edges that own one, the mask and the weights in full in; out [E, C],
    or dxg / xb [T, C], dsbf / sb, dtbf / tb and the weight cotangents
    (ctb [E, C] in ct's type) in full out. Operations per real triplet, NB
    = S1 + S2: forward 2 C NB for the basis products and 3 C; backward 4 C
    NB (the products again, the weight gradients) and 6 C, with basis
    gradients 2 C NB more; second order 10 C NB (s, t; P, Q from u2, u3;
    sb, tb; wsb, wtb) and 20 C, with u4, u5 4 C NB more."""
    xg, sbf, tbf, ws, wt, m2d = args
    C = xg.shape[1]
    S1, S2 = sbf.shape[1], (0 if tbf is None else tbf.shape[1])
    NB, es = S1 + S2, xg.element_size()
    Tr, Er = inp["work"]["triplets"], inp["work"]["edges"]
    el = lambda t: 0 if t is None else t.numel() * t.element_size()
    w = el(ws) + el(wt)
    rows = Tr * (C + NB) * es
    small = el(m2d) + w
    if kind == "fwd":
        flops = Tr * (2 * C * NB + 3 * C)
        nbytes = rows + small + m2d.shape[0] * C * es
    elif kind == "bwd":
        flops = Tr * (4 * C * NB + 6 * C + (2 * C * NB if basis else 0))
        nbytes = (rows + Er * C * es + small + el(xg) + w
                  + ((el(sbf) + el(tbf)) if basis else 0))
    else:
        flops = Tr * (10 * C * NB + 20 * C + (4 * C * NB if all_u else 0))
        nbytes = (2 * rows + Er * C * es + small + (w if all_u else 0)
                  + el(xg) + el(sbf) + el(tbf) + w + m2d.shape[0] * C * es)
    t_ops = flops / PEAK_FLOPS[prec]
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def nk_library_fwd(torch, args, K):
    """The one PyTorch call that computes the forward: an einsum over the
    [E, K] views of the triplet rows (torch picks the contraction order,
    opt_einsum's where that package is installed, else left to right).
    Timed only; the port never calls it."""
    xg, sbf, tbf, ws, wt, m2d = args
    v = lambda t: t.view(m2d.shape[0], K, t.shape[1])
    if tbf is None:
        return lambda: torch.einsum("ek,ekc,eks,sc->ec", m2d, v(xg), v(sbf),
                                    ws)
    return lambda: torch.einsum("ek,ekc,eks,sc,ekr,rc->ec", m2d, v(xg),
                                v(sbf), ws, v(tbf), wt)


def phase_nk_times(torch, tp, inputs):
    """One call of each kernel per layer at each path's shape, the bare
    launch on validated operands (CUDA events), beside its bound and the
    plain version's time; at path 5a the backward both with the basis
    cotangents (the force step's inner pass) and without (its outer pass).
    The forward also beside the einsum that computes it (library_ms), held
    once to the plain forward; no PyTorch call returns the backward's or
    the second order's cotangents."""
    opt = torch.backends.opt_einsum.is_available()
    log(f"  torch.einsum contraction order: "
        f"{'opt_einsum' if opt else 'left to right'}")
    rows = []
    for path, inp in inputs.items():
        K = inp["K"]
        basis = path == "5a"
        for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            args = nk_args(torch, inp, dt)
            k_args = tp._kernel_inputs(*args, K)
            ct = inp["ct"].to(dt)
            ct32 = ct.float().contiguous()
            us = [None if u is None else u.to(dt) for u in inp["us"][:3]] + \
                [None, None]
            plain = {
                "fwd": lambda: tp.fused_triplet_product_reference(
                    *args[:5], K, args[5]),
                "bwd": lambda: tp.fused_triplet_product_bwd_reference(
                    *args, ct, K, basis),
                "bwd2": lambda: tp.fused_triplet_product_bwd2_reference(
                    *args, ct, *us, K)}
            kern = {
                "fwd": lambda: tp.triplet_product_forward_kernel(*k_args, K),
                "bwd": lambda: tp.triplet_product_backward_kernel(
                    *k_args, ct32, K, basis),
                "bwd2": lambda: tp.triplet_product_bwd2_kernel(
                    *k_args, ct32, *us, K)}
            kern["bwd_nobasis"] = lambda: tp.triplet_product_backward_kernel(
                *k_args, ct32, K, False)
            plain["bwd_nobasis"] = lambda: \
                tp.fused_triplet_product_bwd_reference(*args, ct, K, False)
            kinds = ("fwd", "bwd", "bwd_nobasis", "bwd2") if basis \
                else ("fwd", "bwd")
            for kind in kinds:
                ms = cuda_ms(torch, kern[kind])
                p_ms = cuda_ms(torch, plain[kind], iters=3, warmup=1)
                b = nk_bounds(args, inp, prec, kind[:3] if kind != "bwd2"
                              else kind, basis and kind != "bwd_nobasis")
                lib_ms = lib_err = None
                if kind == "fwd":
                    lib = nk_library_fwd(torch, args, K)
                    lib_err = rel_err(lib(), plain["fwd"]())
                    if prec == "f32" and lib_err >= NK_TOL["f32"]:
                        fail(f"einsum forward {path}: rel err {lib_err} "
                             f"against the plain forward")
                    lib_ms = cuda_ms(torch, lib, iters=3, warmup=1)
                    torch.cuda.empty_cache()
                rows.append({"kernel": f"triplet_product_{kind}", "path": path,
                             "precision": prec,
                             "basis_grads": basis and kind != "bwd_nobasis",
                             "ms": ms, "plain_ms": p_ms, "bound_ms": b[0],
                             "bound_by": b[1], "flops": b[2], "bytes": b[3],
                             "library_ms": lib_ms, "library_err": lib_err,
                             "triplets": inp["work"]["triplets"],
                             "T": args[0].shape[0]})
    for r in rows:
        log(f"  {r['kernel']} path {r['path']} {r['precision']} (basis_grads "
            f"{r['basis_grads']}; {r['triplets']} real triplets of {r['T']}): "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.4f} of it; "
            f"{r['flops'] / 1e9:.3f} GFLOP, {r['bytes'] / 1e6:.2f} MB; plain "
            f"{r['plain_ms']:.3f} ms"
            + ("" if r["library_ms"] is None else
               f"; einsum {r['library_ms']:.3f} ms, rel err "
               f"{r['library_err']:.2e} against plain") + ")")
    return rows


# ---------------------------------------------------------------------------
# The packed basis on the unblocked NK layout: fused_triplet_pt
# ---------------------------------------------------------------------------

def pt_kernel_inputs(torch, dev, batch, path):
    """The operands of the path's packed-basis product at one layer from a
    real batch: the model's own pt [R, T] (basis_pt of its geometry) and
    triplet mask, xg the raw expand_kj_raw gather of seeded edge rows
    (garbage at masked triplets, as on the path), seeded weights at the
    path's widths (wt a [1, C] zero dummy without torsion), the output
    cotangent and the second-order cotangents u1 (of dxg), u2 (of dpt), u4,
    u5; all float32. ``work`` counts the real triplets and the edges that
    own one."""
    from dig_tpu_torch.ops.triplet_pt import basis_pt
    from dig_tpu_torch.ops.triplets import expand_kj_raw
    model = nk_model(torch, dev, torch.float32, True, path)
    n, k, has_t = model.num_spherical, model.num_radial, model.use_torsion
    with torch.no_grad():
        geo = model.geometry(batch.nodes["pos"], batch)
        pt = basis_pt(n, k, geo.angle, geo.phi, geo.dist_kj / model.cutoff,
                      has_t)
        K = model.nk_degree
        E = geo.nkg.senders.shape[0]
        gen = torch.Generator(device="cpu").manual_seed(8)
        r = lambda *s: torch.randn(*s, generator=gen).to(dev)
        xg = expand_kj_raw(r(E, NK_C), geo.trip)
    nk, ntk = n * k, (n * n * k if has_t else 1)
    m2 = geo.trip.mask.reshape(E, K).float()
    T = E * K
    return {"xg": xg, "pt": pt, "ws": r(nk, NK_C) * nk ** -0.5,
            "wt": (r(ntk, NK_C) * ntk ** -0.5 if has_t
                   else torch.zeros(1, NK_C, device=dev)),
            "m2": m2, "ct": r(E, NK_C), "K": K, "cfg": (n, k, has_t),
            "us": [r(T, NK_C), r(*pt.shape), r(nk, NK_C), r(ntk, NK_C)],
            "work": {"triplets": int(m2.sum()),
                     "edges": int((m2 != 0).any(1).sum())}}


def pt_args(torch, inp, dt):
    """(xg, pt, ws, wt, m2) in the path's compute type ``dt``."""
    return [inp[k].to(dt) for k in ("xg", "pt", "ws", "wt", "m2")]


def pt_vjp(torch, tpt, args, ct, K, cfg, need_dpt):
    """The op's output and its gradients with respect to (xg, pt, ws, wt)
    through the autograd tower (pt's None unless need_dpt, wt's None
    without torsion)."""
    live = [True, need_dpt, True, cfg[2]]
    xs = [a.clone().requires_grad_(f) for a, f in zip(args[:4], live)]
    out = tpt.fused_triplet_pt(*xs, args[4], K, 128, cfg)
    g = iter(torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                                 ct))
    return out, [next(g) if x.requires_grad else None for x in xs]


def masked_zero(a, masked):
    """Whether the rows (xg-shaped) or columns (pt-shaped) of masked
    triplets are exactly 0."""
    if a.shape[0] == masked.shape[0]:
        return float(a[masked].abs().max()) == 0.0
    return float(a[:, masked].abs().max()) == 0.0


def phase_pt_kernel_vs_plain(torch, tpt, inputs):
    """Every triplet_pt kernel against its plain version at paths 6a's and
    6b's shapes, f32 and bf16: the forward; the backward with dpt asked for
    and not; the second order with u4 = u5 absent and with all present.
    Masked triplets' rows and columns exactly 0; repeated calls the same
    bits. The second order's float32 outputs (wsb, wtb, ctb) are held to
    the f32 bound against the plain version, which computes in float32
    from the same operands. Returns the largest absolute error per kernel
    in path 6a's setting (bf16, dpt asked for, u4 = u5 absent)."""
    errs = {"fwd": 0.0, "bwd": 0.0, "bwd2": 0.0}
    for path, inp in inputs.items():
        K, cfg = inp["K"], inp["cfg"]
        masked = inp["m2"].reshape(-1) == 0
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            args = pt_args(torch, inp, dt)
            ct = inp["ct"].to(dt)
            line = []
            out_k, g_k = pt_vjp(torch, tpt, args, ct, K, cfg, True)
            torch.cuda.synchronize()
            out_p = tpt.fused_triplet_pt_ref(*args, K, cfg)
            want = tpt.fused_triplet_pt_bwd_ref(*args, ct, K, cfg)
            e = rel_err(out_k, out_p)
            line.append(f"fwd {e:.2e}")
            if out_k.dtype != dt or e >= NK_TOL[prec]:
                fail(f"triplet_pt forward {path} {prec}: rel err {e}")
            for nm, a, w in zip(("dxg", "dpt", "dws", "dwt"), g_k, want):
                if a is None:
                    continue
                e = rel_err(a, w)
                line.append(f"{nm} {e:.2e}")
                if a.dtype != dt or e >= NK_TOL[prec]:
                    fail(f"triplet_pt {nm} {path} {prec}: rel err {e}")
                if nm in ("dxg", "dpt") and not masked_zero(a, masked):
                    fail(f"triplet_pt {nm}: masked triplets not 0")
            _, g_n = pt_vjp(torch, tpt, args, ct, K, cfg, False)
            if not all(b is None or torch.equal(a, b)
                       for i, (a, b) in enumerate(zip(g_k, g_n)) if i != 1):
                fail(f"triplet_pt gradients changed without dpt ({path}, "
                     f"{prec})")
            out_again, again = pt_vjp(torch, tpt, args, ct, K, cfg, True)
            if not torch.equal(out_again, out_k):
                fail(f"triplet_pt forward not bitwise repeatable ({path}, "
                     f"{prec})")
            if not all(a is None or torch.equal(a, b)
                       for a, b in zip(again, g_k)):
                fail(f"triplet_pt backward not bitwise repeatable ({path}, "
                     f"{prec})")
            if prec == "bf16" and path == "6a":
                errs["fwd"] = float((out_k.detach() - out_p).float().abs().max())
                errs["bwd"] = max(float((a.float() - w.float()).abs().max())
                                  for a, w in zip(g_k, want) if a is not None)
            k_args = tpt._kernel_inputs(*args, K, cfg)
            ct32 = ct.float().contiguous()
            u12 = [u.to(dt) for u in inp["us"][:2]]
            for all_u in (False, True):
                us = u12 + (inp["us"][2:] if all_u else [None, None])
                got = tpt.triplet_pt_bwd2_kernel(*k_args, ct32, *us, K, cfg)
                torch.cuda.synchronize()
                want = tpt.fused_triplet_pt_bwd2_ref(*args, ct, *us, K, cfg)
                for nm, a, w in zip(("xb", "ptb", "wsb", "wtb", "ctb"), got,
                                    want):
                    if nm == "wtb" and not cfg[2]:
                        continue
                    if not bool(torch.isfinite(a).all()):
                        fail(f"bwd2 {nm} not finite ({path}, {prec})")
                    e = rel_err(a, w)
                    tol = NK_TOL[prec] if a.dtype == dt else NK_TOL["f32"]
                    line.append(f"{nm}{'(all u)' if all_u else ''} {e:.2e}")
                    if e >= tol:
                        fail(f"triplet_pt bwd2 {nm} {path} {prec} all_u="
                             f"{all_u}: rel err {e} >= {tol}")
                    if nm in ("xb", "ptb") and not masked_zero(a, masked):
                        fail(f"triplet_pt bwd2 {nm}: masked triplets not 0")
                    if path == "6a" and prec == "bf16" and not all_u:
                        errs["bwd2"] = max(errs["bwd2"], float(
                            (a.float() - w.float()).abs().max()))
                again = tpt.triplet_pt_bwd2_kernel(*k_args, ct32, *us, K,
                                                   cfg)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    fail(f"triplet_pt bwd2 not bitwise repeatable ({path}, "
                         f"{prec})")
            log(f"  {path} E={args[4].shape[0]} K={K} R={args[1].shape[0]} "
                f"has_t={cfg[2]} {prec}: rel err " + ", ".join(line)
                + "; masked triplets 0; without dpt the same other "
                "gradients; repeated calls the same bits")
    log(f"  max abs err (bf16 as on path 6a): fwd {errs['fwd']:.3e}, bwd "
        f"{errs['bwd']:.3e}, bwd2 {errs['bwd2']:.3e}")
    return errs


REPEAT_PATHS = ("3", "4a", "6a")


def repeat_case(torch, dev, path):
    """(model, train step, batch) of one step of path 3, 4a or 6a from the
    seeded state."""
    from dig_tpu_torch.train import make_bucketed_step_fns, make_step_fns
    adam = lambda m, lr: torch.optim.Adam(m.parameters(), lr=lr)
    if path == "3":
        m = sn_model(torch, dev, torch.bfloat16, True)
        return (m, make_bucketed_step_fns(m, adam(m, 5e-4), p=SF_P)[0],
                sf_batches(torch, dev, 1)[0])
    if path == "4a":
        m = fs_model(torch, dev, FS_KW["segment_eb"])
        return (m, make_step_fns(m, adam(m, FS_LR), energy_and_force=True,
                                 p=FS_P, loss="l1")[0],
                fs_batches(torch, dev, 1)[0])
    m = nk_model(torch, dev, torch.bfloat16, True, "6a")
    return (m, make_step_fns(m, adam(m, NK_LR), energy_and_force=True,
                             p=NK_P, loss="l1")[0],
            nk_batches(torch, dev, 1)[0])


def repeat_step(path, out):
    """``chip_smoke.py --repeat-step PATH OUT``: one step of the path from
    the seeded state in this process; the loss and the parameters after
    Adam go to OUT (torch.save)."""
    import torch
    model, step, batch = repeat_case(torch, torch.device("cuda"), path)
    loss = step(batch)["loss"]
    torch.save({"loss": loss.detach().cpu(),
                **{n: p.detach().cpu() for n, p in model.named_parameters()}},
               out)


def run_fresh(jobs):
    """Run ``chip_smoke.py <args>`` for each job in a fresh process, all at
    once (each builds its own state from the seed; the card serves them
    in turn), and fail on any that does not exit 0."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for k, (what, args) in enumerate(jobs.items()):
                err = open(os.path.join(tmp, f"{k}.err"), "w+")
                procs[what] = (subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), *args],
                    stdout=subprocess.DEVNULL, stderr=err), err)
            errs = {}
            for what, (p, err) in procs.items():
                p.wait(timeout=900)
                if p.returncode != 0:
                    err.seek(0)
                    errs[what] = err.read()[-2000:]
        finally:
            for p, err in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                err.close()
    if errs:
        fail(f"fresh processes failed: {errs}")


def phase_repeat(torch):
    """Per path, two fresh processes each take one step from the same
    seeded state on the same batch: the loss and every parameter after
    Adam must be the same bits. (Within one process a second force step
    need not repeat the first: the autograd engine orders the outer
    backward by sequence numbers that the double backward's nodes draw
    from the device thread's counter, which runs on across steps.)"""
    with tempfile.TemporaryDirectory() as tmp:
        outs = {(path, i): os.path.join(tmp, f"{path}_{i}.pt")
                for path in REPEAT_PATHS for i in range(2)}
        run_fresh({f"path {p} step process {i}": ["--repeat-step", p, out]
                   for (p, i), out in outs.items()})
        for path in REPEAT_PATHS:
            a, b = (torch.load(outs[path, i]) for i in range(2))
            same = [torch.equal(a[k], b[k]) for k in a if k != "loss"]
            log(f"  path {path}: loss {float(a['loss']):.7f} and "
                f"{float(b['loss']):.7f}, the same bits: "
                f"{torch.equal(a['loss'], b['loss'])}; {sum(same)} of "
                f"{len(same)} parameters the same bits after Adam")
            if not (torch.equal(a["loss"], b["loss"]) and all(same)):
                fail(f"path {path}: two identical steps differ")


def pt_bounds(args, inp, prec, kind, all_u=False, need_dpt=True):
    """Least time for one call's work at this data: real triplets only
    (a masked one contributes exactly zero). Bytes, in the types the
    function takes and returns (as the JAX _run_fwd/_run_bwd/_run_bwd2
    declare them): the xg row and the pt column of each real triplet (the
    second order also u1's row and u2's column), the output cotangent rows
    of the edges that own one, the mask and the weights in full in; out
    [E, C], or dxg / xb [T, C] and dpt / ptb [R, T] and the weight
    cotangents (ctb [E, C] in ct's type) in full out. Operations per real
    triplet, NB = nk + ntk assembled basis rows: forward NB products for
    the assembly, 2 C NB for the basis products and 3 C; backward (with
    dpt, as in the force paths' inner pass) the assembly and the products
    again, the weight gradients (2 C NB), 6 C, and the basis cotangents
    (2 C NB) with their adjoint through the assembly (about 3 NB), without
    dpt (the outer pass) neither the cotangents nor dpt out; second order
    10 C NB
    (sv, tv; dsv, dtv; the weight gradients; the basis cotangents) and
    20 C, about 10 NB for the assembly, its tangent and adjoints, with u4,
    u5 4 C NB more."""
    xg, pt, ws, wt, m2 = args
    C, R = xg.shape[1], pt.shape[0]
    NB = ws.shape[0] + (wt.shape[0] if wt.shape[0] > 1 else 0)
    es, ps = xg.element_size(), pt.element_size()
    Tr, Er = inp["work"]["triplets"], inp["work"]["edges"]
    el = lambda t: t.numel() * t.element_size()
    w = el(ws) + el(wt)
    rows = Tr * (C * es + R * ps)
    small = el(m2) + w
    if kind == "fwd":
        flops = Tr * (2 * C * NB + 3 * C + NB)
        nbytes = rows + small + m2.shape[0] * C * es
    elif kind == "bwd" and need_dpt:
        flops = Tr * (6 * C * NB + 6 * C + 4 * NB)
        nbytes = rows + Er * C * es + small + el(xg) + el(pt) + w
    elif kind == "bwd":
        flops = Tr * (4 * C * NB + 6 * C + NB)
        nbytes = rows + Er * C * es + small + el(xg) + w
    else:
        flops = Tr * (10 * C * NB + 20 * C + 10 * NB
                      + (4 * C * NB if all_u else 0))
        nbytes = (2 * rows + Er * C * es + small + (w if all_u else 0)
                  + el(xg) + el(pt) + w + m2.shape[0] * C * es)
    t_ops = flops / PEAK_FLOPS[prec]
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def pt_assembled(torch, args, cfg):
    """sbf [T, nk] and tbf [T, ntk] (None without torsion) assembled from
    pt and rounded to its type, as the kernels form them: the operands of
    the einsum that stands beside the forward (nk_library_fwd)."""
    n, k, has_t = cfg
    nk = n * k
    f = args[1].float()
    sbf = (f[:nk] * f[nk:nk + n].repeat_interleave(k, 0)).t()
    tbf = ((f[nk + n:].repeat_interleave(k, 0) * f[:nk].repeat(n, 1)).t()
           if has_t else None)
    c = lambda t: None if t is None else t.to(args[1].dtype).contiguous()
    return c(sbf), c(tbf)


def phase_pt_times(torch, tpt, inputs):
    """One call of each triplet_pt kernel per layer at each path's shape,
    the bare launch on validated operands (CUDA events), as the force
    paths run it (dpt asked for, u4 = u5 absent), beside its bound and the
    plain version's time. The forward also beside the einsum over sbf and
    tbf assembled outside the timed call (library_ms), held once to the
    plain forward; no PyTorch call returns the backward's or the second
    order's cotangents."""
    rows = []
    for path, inp in inputs.items():
        K, cfg = inp["K"], inp["cfg"]
        for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            args = pt_args(torch, inp, dt)
            k_args = tpt._kernel_inputs(*args, K, cfg)
            ct = inp["ct"].to(dt)
            ct32 = ct.float().contiguous()
            us = [u.to(dt) for u in inp["us"][:2]] + [None, None]
            plain = {
                "fwd": lambda: tpt.fused_triplet_pt_ref(*args, K, cfg),
                "bwd": lambda: tpt.fused_triplet_pt_bwd_ref(*args, ct, K,
                                                            cfg),
                "bwd2": lambda: tpt.fused_triplet_pt_bwd2_ref(
                    *args, ct, *us, K, cfg)}
            kern = {
                "fwd": lambda: tpt.triplet_pt_forward_kernel(*k_args, K,
                                                             cfg),
                "bwd": lambda: tpt.triplet_pt_backward_kernel(
                    *k_args, ct32, K, cfg, True),
                "bwd2": lambda: tpt.triplet_pt_bwd2_kernel(
                    *k_args, ct32, *us, K, cfg)}
            kern["bwd_nodpt"] = lambda: tpt.triplet_pt_backward_kernel(
                *k_args, ct32, K, cfg, False)
            plain["bwd_nodpt"] = lambda: tpt.fused_triplet_pt_bwd_ref(
                *args, ct, K, cfg, False)
            for kind in ("fwd", "bwd", "bwd_nodpt", "bwd2"):
                ms = cuda_ms(torch, kern[kind])
                p_ms = cuda_ms(torch, plain[kind], iters=3, warmup=1)
                b = pt_bounds(args, inp, prec, kind[:3] if kind != "bwd2"
                              else kind, need_dpt=kind == "bwd")
                lib_ms = lib_err = None
                if kind == "fwd":
                    sbf, tbf = pt_assembled(torch, args, cfg)
                    lib = nk_library_fwd(torch, [args[0], sbf, tbf, args[2],
                                                 args[3] if cfg[2] else None,
                                                 args[4]], K)
                    lib_err = rel_err(lib(), plain["fwd"]())
                    if prec == "f32" and lib_err >= NK_TOL["f32"]:
                        fail(f"einsum forward {path}: rel err {lib_err} "
                             f"against the plain forward")
                    lib_ms = cuda_ms(torch, lib, iters=3, warmup=1)
                    del sbf, tbf, lib
                    torch.cuda.empty_cache()
                rows.append({"kernel": f"triplet_pt_{kind}", "path": path,
                             "precision": prec, "ms": ms, "plain_ms": p_ms,
                             "bound_ms": b[0], "bound_by": b[1],
                             "flops": b[2], "bytes": b[3],
                             "library_ms": lib_ms, "library_err": lib_err,
                             "triplets": inp["work"]["triplets"],
                             "T": args[0].shape[0]})
    for r in rows:
        log(f"  {r['kernel']} path {r['path']} {r['precision']} "
            f"({r['triplets']} real triplets of {r['T']}): {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.4f} of it; {r['flops'] / 1e9:.3f} "
            f"GFLOP, {r['bytes'] / 1e6:.2f} MB; plain {r['plain_ms']:.3f} ms"
            + ("" if r["library_ms"] is None else
               f"; einsum over sbf and tbf assembled outside the timed call "
               f"{r['library_ms']:.3f} ms, rel err {r['library_err']:.2e} "
               f"against plain") + ")")
    return rows


# ---------------------------------------------------------------------------
# Path 7a: fused_triplet_slot_geom, the basis evaluated in the kernel
# ---------------------------------------------------------------------------

def ga_batches(torch, dev, n):
    """Path 7a: path 2's molecules and MoleculeLoader batches (96 in slots
    of 29 atoms), with seeded forces drawn as the force bench draws them;
    the first n batches."""
    import numpy as np
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    mols = synthetic_molecules(SN_G * (n + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    rng = np.random.default_rng(0)
    for m in mols:
        m["force"] = rng.normal(size=m["pos"].shape).astype(np.float32)
    it = iter(MoleculeLoader(mols, SN_G, slot_size=SN_KW["block_size"],
                             shuffle=True, seed=0, device=dev))
    return [b.replace_globals(energy=b.globals["y"][:, :1])
            for b in (next(it) for _ in range(n))]


def ga_operands(torch, model, batch, pos):
    """The port's SphereNet geometry of ``pos`` (differentiable back to
    it) as the geometry op takes it, geo [K, 3, E] = (theta, phi, d_kj /
    cutoff) s-leading, and as the pt chain takes it, pt [K, R, E] built as
    slot_operands builds it; the mask m2T and the ids lj."""
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    geo = model.geometry(pos, batch, A)
    pt, m2t, lj = model.slot_operands(geo, A)
    E = m2t.shape[1]
    smaj = lambda v: v.reshape(E, K).t()
    g = torch.stack([smaj(geo.angle), smaj(geo.phi),
                     smaj(geo.dist_kj) / SN_KW["cutoff"]], 1)
    return g, pt, m2t, lj


def ga_kernel_inputs(torch, dev, batch):
    """geo, pt, m2T, lj of a real path-7a batch (float32) and seeded x,
    ws, wt, output cotangent and second-order cotangents u1 (of dx), ug (of
    dgeo), u4, u5 at the flagship widths; ``work`` counts the real
    triplets, the distinct x rows they gather and the edges that own
    one."""
    model = sn_model(torch, dev, torch.float32, True)
    with torch.no_grad():
        geo, pt, m2t, lj = ga_operands(torch, model, batch,
                                       batch.nodes["pos"])
    n, k = SN_KW["num_spherical"], SN_KW["num_radial"]
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    E = m2t.shape[1]
    gen = torch.Generator(device="cpu").manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=gen).to(dev)
    real = m2t != 0
    e = torch.arange(E, device=dev)
    x_rows = ((e // (A * K)) * A + lj[0].long()) * K \
        + torch.arange(K, device=dev)[:, None]
    work = {"triplets": int(real.sum()),
            "x_rows": int(torch.unique(x_rows[real]).numel()),
            "edges": int(real.any(0).sum()),
            "dk_min": float(geo[:, 2][real].min())}
    return {"geo": geo, "pt": pt, "m2t": m2t, "lj": lj, "x": r(E, SN_C),
            "ws": r(n * k, SN_C) * (n * k) ** -0.5,
            "wt": r(n * n * k, SN_C) * (n * n * k) ** -0.5,
            "ct": r(E, SN_C), "u1": r(E, SN_C), "ug": r(*geo.shape),
            "u4": r(n * k, SN_C), "u5": r(n * n * k, SN_C), "work": work}


def ga_args(torch, inp, has_t, dt):
    """Operands of fused_triplet_slot_geom for one setting; (args, cfg).
    Without torsion geo keeps (theta, d_kj / cutoff)."""
    n, k = SN_KW["num_spherical"], SN_KW["num_radial"]
    geo = inp["geo"] if has_t else inp["geo"][:, [0, 2]].contiguous()
    wt = inp["wt"] if has_t else torch.zeros_like(inp["wt"][:1])
    args = [inp["x"].to(dt), geo, inp["ws"].to(dt), wt.to(dt),
            inp["m2t"].to(dt), inp["lj"]]
    return args, (n, k, has_t)


def ga_masked(ts, t, m2t, lj):
    """The largest |value| of a [K, NG, E] geometry gradient at the masked
    triplets (0 or lj outside the slot)."""
    live = ts._live(m2t, lj, SN_KW["block_size"])
    return float(t.float().abs().masked_fill(live[:, None, :], 0.0).max())


def phase_ga_kernel_vs_plain(torch, ts, inp):
    """The three geometry kernels against their plain versions at path
    7a's shape (geo of a real batch), has_t on and off, f32 and bf16: the
    forward; the backward with dgeo and without (the other gradients the
    same bits); the second order with u1 = u4 = u5 absent as in force
    training and with all present. dgeo and geob exactly 0 at masked
    triplets; repeated calls the same bits. Then the peak device memory of
    one forward and backward beside the pt chain's (the geometry op's must
    be the lower). Returns the largest absolute errors in the main path's
    setting (bf16, has_t)."""
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    errs = {"fwd": 0.0, "bwd": 0.0, "bwd2": 0.0}
    log(f"  E={inp['x'].shape[0]}, {inp['work']['triplets']} real triplets; "
        f"shortest d_kj / cutoff {inp['work']['dk_min']:.4f}")
    for has_t in (True, False):
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tol1, tol2 = GA_TOL[prec]
            args, cfg = ga_args(torch, inp, has_t, dt)
            ct = inp["ct"].to(dt)
            plain = lambda xs: ts.fused_triplet_slot_geom_reference(
                *xs, A, K, cfg)
            kern = lambda xs: ts.fused_triplet_slot_geom(*xs, A, K, cfg)
            out_p, g_p = slot_grads(torch, plain, args, ct, True)
            out_k, g_k = slot_grads(torch, kern, args, ct, True)
            torch.cuda.synchronize()
            line = [f"fwd {rel_err(out_k, out_p):.2e}"]
            if out_k.dtype != dt or rel_err(out_k, out_p) >= tol1:
                fail(f"geom forward has_t={has_t} {prec}: rel err "
                     f"{rel_err(out_k, out_p)}")
            for nm, a, b in zip(["dx", "dgeo", "dws", "dwt"], g_k, g_p):
                if nm == "dwt" and not has_t:
                    continue
                e = rel_err(a, b)
                line.append(f"{nm} {e:.2e}")
                if a.dtype != b.dtype or not bool(torch.isfinite(a).all()) \
                        or e >= tol1:
                    fail(f"geom {nm} has_t={has_t} {prec}: rel err {e}")
            masked = ga_masked(ts, g_k[1], args[4], args[5])
            if masked != 0.0:
                fail(f"geom dgeo at masked triplets {masked} (has_t={has_t}, "
                     f"{prec})")
            _, g_n = slot_grads(torch, kern, args, ct, False)
            if not all(a is None or torch.equal(a, b)
                       for a, b in zip(g_n, g_k)):
                fail(f"geom gradients changed without dgeo (has_t={has_t}, "
                     f"{prec})")
            _, again = slot_grads(torch, kern, args, ct, True)
            if not all(torch.equal(a, b) for a, b in zip(again, g_k)):
                fail(f"geom backward not bitwise repeatable (has_t={has_t}, "
                     f"{prec})")
            k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
            ct32 = ct.float().contiguous()
            for all_u in (False, True):
                us = [inp["u1"].to(dt) if all_u else None, inp["ug"][:,
                      [0, 1, 2] if has_t else [0, 2]].contiguous(),
                      inp["u4"] if all_u else None,
                      inp["u5"] if all_u and has_t else None]
                got = ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *us, A,
                                                       K, cfg)
                torch.cuda.synchronize()
                want = ts.fused_triplet_slot_geom_bwd2_reference(
                    *args, ct, *us, A, K, cfg)
                for nm, a, w in zip(["xb", "geob", "wsb", "wtb", "ctb"], got,
                                    want):
                    if nm == "wtb" and not has_t:
                        continue
                    e = rel_err(a, w)
                    line.append(f"{nm}{'*' if all_u else ''} {e:.2e}")
                    if not bool(torch.isfinite(a).all()) or e >= tol2:
                        fail(f"geom bwd2 {nm} has_t={has_t} {prec} all_u="
                             f"{all_u}: rel err {e}")
                    if has_t and prec == "bf16" and not all_u:
                        errs["bwd2"] = max(errs["bwd2"],
                                           float((a - w).abs().max()))
                masked = ga_masked(ts, got[1], args[4], args[5])
                if masked != 0.0:
                    fail(f"geom geob at masked triplets {masked}")
                again = ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *us,
                                                         A, K, cfg)
                if not all(torch.equal(a, c) for a, c in zip(again, got)):
                    fail(f"geom bwd2 not bitwise repeatable (has_t={has_t}, "
                         f"{prec})")
            log(f"  has_t={has_t} {prec}: rel err " + ", ".join(line)
                + " (* u1, u4, u5 present); dgeo and geob 0 at masked "
                "triplets; without dgeo the same bits; repeated calls the "
                "same bits")
            if has_t and prec == "bf16":
                errs["fwd"] = float((out_k - out_p).detach().float().abs()
                                    .max())
                errs["bwd"] = max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(g_k, g_p))
    # peak extra device memory of one forward and backward, bf16, has_t
    args, cfg = ga_args(torch, inp, True, torch.bfloat16)
    ct = inp["ct"].to(torch.bfloat16)
    n, k = cfg[0], cfg[1]

    def geom_run(xs):
        return ts.fused_triplet_slot_geom(*xs, A, K, cfg)

    def pt_run(xs):
        g = xs[1]
        pt = ts.basis_pt_k(n, k, g[:, 0], g[:, 1], g[:, 2], True)
        return ts.fused_triplet_slot(xs[0], pt.to(torch.bfloat16), *xs[2:],
                                     A, K, cfg)
    peaks = {}
    for name, fn in (("geometry op", geom_run), ("pt chain", pt_run)):
        xs = [a.clone().requires_grad_() for a in args[:4]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(xs + list(args[4:]))
        grads = torch.autograd.grad(out, xs, ct)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        del out, grads, xs
    log(f"  peak extra device memory of one forward and backward (bf16, "
        f"has_t, with dgeo): geometry op {peaks['geometry op']:.1f} MiB, pt "
        f"chain {peaks['pt chain']:.1f} MiB")
    if not peaks["geometry op"] < peaks["pt chain"]:
        fail(f"the geometry op's peak memory is not the lower: {peaks}")
    log(f"  max abs err (bf16, has_t, u1 = u4 = u5 absent as on the main "
        f"path): fwd {errs['fwd']:.3e} bwd {errs['bwd']:.3e} bwd2 "
        f"{errs['bwd2']:.3e}")
    return errs


def ga_leaves(torch, dev, E):
    """Four layers' seeded leaves x [E, 64], ws [18, 64], wt [54, 64]
    (float32 master copies) and the readout vector w_out [64]."""
    n, k = SN_KW["num_spherical"], SN_KW["num_radial"]
    gen = torch.Generator(device="cpu").manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=gen)
    layers = [[r(E, SN_C), r(n * k, SN_C) * (n * k) ** -0.5,
               r(n * n * k, SN_C) * (n * n * k) ** -0.5]
              for _ in range(SN_KW["num_layers"])]
    w_out = (r(SN_C) * 0.01 * SN_C ** -0.5).to(dev)   # forces of O(1)
    return [[t.to(dev).requires_grad_() for t in l] for l in layers], w_out


def ga_step(torch, ts, model, leaves, w_out, batch, dt, branch):
    """One path-7a force step at the current leaves: E_pred = sum over
    layers of out_l . w_out, summed over the edges; F = -dE_pred/dpos
    (create_graph); loss = |E_pred - y| + GA_P mean|F - F_ref|^2 over the
    real atoms (y: the batch's summed energy). The leaves' gradient is
    sign(E_pred - y) dE_pred/dleaves, from the same first backward as F,
    plus the force term's, the second order. ``branch``: "kernel" (the
    geometry kernels), "plain" (its plain version) or "pt" (basis_pt_k
    into the fused_triplet_slot kernels)."""
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    cfg = (SN_KW["num_spherical"], SN_KW["num_radial"], True)
    pos = batch.nodes["pos"].detach().clone().requires_grad_()
    geo, pt, m2t, lj = ga_operands(torch, model, batch, pos)
    m2t = m2t.to(dt)
    flat = [t for layer in leaves for t in layer]
    e_pred = 0.0
    for x, ws, wt in leaves:
        ops = (x.to(dt), ws.to(dt), wt.to(dt))
        if branch == "kernel":
            out = ts.fused_triplet_slot_geom(ops[0], geo, *ops[1:], m2t, lj,
                                             A, K, cfg)
        elif branch == "plain":
            out = ts.fused_triplet_slot_geom_reference(ops[0], geo, *ops[1:],
                                                       m2t, lj, A, K, cfg)
        else:
            out = ts.fused_triplet_slot(ops[0], pt.to(dt), *ops[1:], m2t, lj,
                                        A, K, cfg)
        e_pred = e_pred + (out.float() @ w_out).sum()
    y = batch.globals["energy"][batch.graph_mask].sum()
    first = torch.autograd.grad(e_pred, [pos] + flat, create_graph=True)
    force = -first[0]
    nm = batch.node_mask
    f_loss = GA_P * ((force - batch.nodes["force"])[nm] ** 2).mean()
    e_loss = (e_pred - y).abs()
    second = torch.autograd.grad(f_loss, flat, allow_unused=True)
    sign = torch.sign(e_pred - y).detach()
    grads = [sign * a.detach() + (0.0 if b is None else b)
             for a, b in zip(first[1:], second)]
    return {"loss": float((e_loss + f_loss).detach()),
            "e_loss": float(e_loss.detach()),
            "f_loss": float(f_loss.detach()), "force": force.detach(),
            "e_grads": [a.detach() for a in first[1:]], "grads": grads}


def phase_ga_main_path(torch, ts, sc, dev, batches):
    """Path 7a: the first step in f32 through the geometry kernels held
    against the pt chain and the plain geometry op (loss 1e-4; F and
    dE/dleaves 2e-4; every leaf's gradient 1e-3, each relative to its
    largest value: tests/test_pallas_triplet_slot.py:172-190); bf16 against
    f32 by direction and size; then Adam steps in bf16 with exactly 4
    forward, 4 backward and 4 second-order geometry launches per step and
    no triplet_slot or segment-sum launch; finite forces."""
    model = sn_model(torch, dev, torch.float32, True)
    E = SN_G * SN_KW["block_size"] * SN_KW["nk_degree"]
    b0 = batches[0]
    res = {}
    for branch, dt in (("kernel", torch.float32), ("plain", torch.float32),
                       ("pt", torch.float32), ("kernel_bf16",
                                               torch.bfloat16)):
        leaves, w_out = ga_leaves(torch, dev, E)
        res[branch] = ga_step(torch, ts, model, leaves, w_out, b0, dt,
                              branch.split("_")[0])
        torch.cuda.empty_cache()
    k = res["kernel"]
    worst = {}
    for ref in ("plain", "pt"):
        r = res[ref]
        loss_err = abs(k["loss"] - r["loss"]) / abs(r["loss"])
        f_err = rel_err(k["force"], r["force"])
        e_err = max(rel_err(a, b) for a, b in zip(k["e_grads"],
                                                       r["e_grads"]))
        g_err = max(rel_err(a, b) for a, b in zip(k["grads"],
                                                       r["grads"]))
        worst[ref] = (loss_err, f_err, e_err, g_err)
        log(f"  first step f32, geometry kernels against the {ref} branch: "
            f"loss {k['loss']:.7f} vs {r['loss']:.7f} (rel {loss_err:.2e}; "
            f"energy term {k['e_loss']:.5f}, force term {k['f_loss']:.5f}); "
            f"F rel err {f_err:.2e}, dE/dleaves worst {e_err:.2e}, worst "
            f"leaf gradient {g_err:.2e}")
        if not (loss_err < GA_STEP_TOL[0] and f_err < GA_STEP_TOL[1]
                and e_err < GA_STEP_TOL[1] and g_err < GA_STEP_TOL[2]):
            fail(f"path 7a first step against the {ref} branch: "
                 f"{worst[ref]} (bounds {GA_STEP_TOL})")
    names = [f"layer{l}.{n}" for l in range(SN_KW["num_layers"])
             for n in ("x", "ws", "wt")]
    a = agreement(torch, res["kernel_bf16"]["grads"], k["grads"], names)
    log(f"  first step bf16 against f32 (geometry kernels): loss "
        f"{res['kernel_bf16']['loss']:.5f} vs {k['loss']:.5f}; cosine "
        f"{a['cos']:.4f} over all leaves, median leaf {a['median_cos']:.4f}; "
        f"norm {a['norm']:.4f} x, per leaf {a['least'][0]:.4f} "
        f"({a['least'][1]}) to {a['largest'][0]:.4f} ({a['largest'][1]})")
    if (not a["cos"] >= SF_BF16_COS[0] or not a["median_cos"] >= SF_BF16_COS[1]
            or not SF_BF16_NORM[0] <= a["least"][0]
            or not a["largest"][0] <= SF_BF16_NORM[1]):
        fail(f"path 7a bf16 gradient against f32: {a}")
    del res
    torch.cuda.empty_cache()
    leaves, w_out = ga_leaves(torch, dev, E)
    opt = torch.optim.Adam([t for layer in leaves for t in layer], lr=GA_LR)
    ts.reset_launch_counts()
    sc.reset_launch_counts()
    losses, t_start = [], None
    for s, b in enumerate(batches):
        if s == GA_WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        r = ga_step(torch, ts, model, leaves, w_out, b, torch.bfloat16,
                    "kernel")
        if not bool(torch.isfinite(r["force"]).all()):
            fail(f"path 7a step {s}: non-finite forces")
        for p, g in zip(opt.param_groups[0]["params"], r["grads"]):
            p.grad = g
        opt.step()
        losses.append(r["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    launches = (ts.launches_geom_fwd, ts.launches_geom_bwd,
                ts.launches_geom_bwd2)
    with_dgeo = ts.launches_geom_bwd_dgeo
    want = SN_KW["num_layers"] * len(batches)
    log(f"  {len(batches)} Adam steps (bf16), losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"  geometry launches fwd {launches[0]} bwd {launches[1]} bwd2 "
        f"{launches[2]} (layers x steps = {want} each); backward launches "
        f"with dgeo {with_dgeo} (per step {with_dgeo // len(batches)} of "
        f"{launches[1] // len(batches)}: the one first-order pass takes F and "
        f"dE/dleaves together); triplet_slot "
        f"{ts.launches_fwd} {ts.launches_bwd} {ts.launches_bwd2}; segment "
        f"sum {sc.launches}")
    if launches != (want, want, want):
        fail(f"path 7a geometry launches {launches} != {want} each")
    if with_dgeo != want:
        fail(f"path 7a geometry backward launches with dgeo {with_dgeo} != "
             f"{want}")
    if ts.launches_fwd or ts.launches_bwd or ts.launches_bwd2:
        fail("path 7a launched triplet_slot kernels")
    if not all(math.isfinite(x) for x in losses):
        fail(f"path 7a non-finite loss {losses}")
    step_ms = dt / (len(batches) - GA_WARMUP) * 1e3
    log(f"  step {step_ms:.3f} ms (mean of {len(batches) - GA_WARMUP} "
        f"steps)")
    return {"launches": launches, "step_ms": step_ms, "losses": losses,
            "first_step": worst, "bf16": a}


def ga_bounds(args, inp, prec, kind, ops, need_dgeo=True):
    """Least time for one call's work at this data, the largest of three:
    bytes (the geo column and the gathered x row of each real triplet; the
    mask, the ids and the weights in full; out, or for the backward the
    cotangent rows of the edges that own a triplet in and dx, dgeo, dws,
    dwt out, for the second order also the u1 rows and ug columns in and
    xb, geob, wsb, wtb, ctb out, in the types the function takes and
    returns) over 3.35 TB/s; the float32 operations of the contraction
    (sn_bounds' counts, and for the second order pt_bounds' 10 C NB + 20 C
    per triplet) over 67 TF/s; and the float64 operations of the rows
    (``ops``: sympy's count of the generated closed forms, a lower bound on
    their work: the rows in the forward, the rows and their gradients in
    the backward, one fused jet (rows, gradients and second derivatives)
    in the second order) at every real triplet over the 34 TF/s of the
    FP64 pipes (NVIDIA's data sheet)."""
    x, geo, ws, wt, m2t, lj = args
    C, NG = x.shape[1], geo.shape[1]
    NB = ws.shape[0] + (wt.shape[0] if wt.shape[0] > 1 else 0)
    T, Er = inp["work"]["triplets"], inp["work"]["edges"]
    el = lambda t: t.numel() * t.element_size()
    w = el(ws) + el(wt)
    rows = inp["work"]["x_rows"] * C * x.element_size() + T * NG * 4
    small = el(m2t) + el(lj) + w
    if kind == "fwd":
        flops = T * (2 * C * NB + 3 * C + NB)
        nbytes = rows + small + el(x)
    elif kind == "bwd":
        flops = T * ((6 if need_dgeo else 4) * C * NB + 7 * C
                     + (3 if need_dgeo else 1) * NB)
        nbytes = rows + small + Er * C * x.element_size() + el(x) + \
            (el(geo) if need_dgeo else 0) + w
    else:
        flops = T * (10 * C * NB + 20 * C + 10 * NB)
        nbytes = (2 * rows + small + Er * C * 4 + el(x) + el(geo) + w
                  + x.shape[0] * C * 4)
    row_ops = {"fwd": ops["row"],
               "bwd": ops["row"] + (ops["grad"] if need_dgeo else 0),
               "bwd2": ops["jet"]}[kind]
    t_ops = flops / PEAK_FLOPS["f32"]
    t_rows = T * row_ops / PEAK_FP64
    t_bytes = nbytes / PEAK_BYTES
    by = max((t_ops, "operations (f32)"), (t_rows, "operations (f64 rows)"),
             (t_bytes, "bytes"))
    return by[0] * 1e3, by[1], flops, nbytes


def slot_library_fwd(torch, args, rows, cfg, dt, A, K):
    """The one PyTorch call that computes the slot forward: nk_library_fwd's
    einsum over the triplets, e-major, with the x rows gathered and sbf, tbf
    formed from the rows [K, R, E] (pt_assembled) outside the timed call.
    Timed only; the port never calls it."""
    x, ws, wt, m2t, lj = args[0], args[2], args[3], args[4], args[5]
    E, Kr, R = x.shape[0], rows.shape[0], rows.shape[1]
    e = torch.arange(E, device=x.device)
    ids = (((e // (A * K)) * A + lj[0].long()) * K)[:, None] \
        + torch.arange(K, device=x.device)                    # [E, K]
    sbf, tbf = pt_assembled(torch, [None, rows.permute(1, 2, 0).reshape(
        R, E * Kr)], cfg)
    em = lambda t: None if t is None else t.to(dt)
    return nk_library_fwd(torch, [x[ids.reshape(-1)], em(sbf), em(tbf), ws,
                                  wt if cfg[2] else None,
                                  m2t.t().to(x.dtype)], K)


def phase_ga_times(torch, ts, inp, splits):
    """One call of each geometry kernel per layer at path 7a's shape (the
    bare launch on validated operands, as the force path runs it: dgeo
    asked for, u1 = u4 = u5 absent) beside its bound, its plain version,
    and the pt chain that computes the same function through autograd in
    the same call (basis_pt_k and the fused_triplet_slot kernels: the
    forward; the first backward from a kept graph; the second backward of
    dgeo's cotangent from a kept first-order graph); the forward also
    beside the einsum over sbf and tbf assembled outside the timed call;
    the second order beside its split by kernel (``splits``, taken by
    geom_bwd2_split)."""
    from dig_tpu_torch.ops.basis import basis_row_ops
    A, K = SN_KW["block_size"], SN_KW["nk_degree"]
    rows = []
    for prec, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        args, cfg = ga_args(torch, inp, True, dt)
        ops = basis_row_ops(*cfg)
        k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
        ct = inp["ct"].to(dt)
        ct32 = ct.float().contiguous()
        ug = inp["ug"]
        kern = {
            "fwd": lambda: ts.triplet_slot_geom_forward_kernel(*k_args, A, K,
                                                               cfg),
            "bwd": lambda: ts.triplet_slot_geom_backward_kernel(
                *k_args, ct32, A, K, cfg, True),
            "bwd_nodgeo": lambda: ts.triplet_slot_geom_backward_kernel(
                *k_args, ct32, A, K, cfg, False),
            "bwd2": lambda: ts.triplet_slot_geom_bwd2_kernel(
                *k_args, ct32, None, ug, None, None, A, K, cfg)}
        plain = {
            "fwd": lambda: ts.fused_triplet_slot_geom_reference(*args, A, K,
                                                                cfg),
            "bwd": lambda: ts.fused_triplet_slot_geom_bwd_reference(
                *args, ct, A, K, cfg),
            "bwd_nodgeo": lambda: ts.fused_triplet_slot_geom_bwd_reference(
                *args, ct, A, K, cfg, False),
            "bwd2": lambda: ts.fused_triplet_slot_geom_bwd2_reference(
                *args, ct, None, ug, None, None, A, K, cfg)}
        n, k = cfg[0], cfg[1]
        xs = [a.clone().requires_grad_() for a in args[:4]]

        def chain(xs):
            g = xs[1]
            pt = ts.basis_pt_k(n, k, g[:, 0], g[:, 1], g[:, 2], True)
            return ts.fused_triplet_slot(xs[0], pt.to(dt), *xs[2:],
                                         *args[4:], A, K, cfg)
        with torch.no_grad():
            chain_fwd = cuda_ms(torch, lambda: chain(args[:4]), iters=10)
        out = chain(xs)
        chain_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            out, xs, ct, retain_graph=True), iters=10)
        first = torch.autograd.grad(out, xs, ct, create_graph=True)
        chain_bwd2 = cuda_ms(torch, lambda: torch.autograd.grad(
            first[1], xs, ug, retain_graph=True, allow_unused=True), iters=10)
        del out, first, xs
        chain_ms = {"fwd": chain_fwd, "bwd": chain_bwd, "bwd_nodgeo": None,
                    "bwd2": chain_bwd2}
        for kind in ("fwd", "bwd", "bwd_nodgeo", "bwd2"):
            ms = cuda_ms(torch, kern[kind])
            split = splits[prec] if kind == "bwd2" else None
            p_ms = cuda_ms(torch, plain[kind], iters=3, warmup=1)
            b = ga_bounds(args, inp, prec, kind[:4].rstrip("_"), ops,
                          need_dgeo=kind != "bwd_nodgeo")
            lib_ms = lib_err = None
            if kind == "fwd":
                lib = slot_library_fwd(torch, args, ts.geom_rows_pt(
                    args[1], args[4], args[5], A, cfg), cfg, dt, A, K)
                lib_err = rel_err(lib(), plain["fwd"]())
                if prec == "f32" and lib_err >= NK_TOL["f32"]:
                    fail(f"einsum geometry forward: rel err {lib_err} "
                         f"against the plain forward")
                lib_ms = cuda_ms(torch, lib, iters=3, warmup=1)
                del lib
                torch.cuda.empty_cache()
            rows.append({"kernel": f"triplet_slot_geom_{kind}",
                         "precision": prec, "ms": ms, "split": split,
                         "plain_ms": p_ms,
                         "chain_ms": chain_ms[kind], "bound_ms": b[0],
                         "bound_by": b[1], "flops": b[2], "bytes": b[3],
                         "library_ms": lib_ms, "library_err": lib_err})
    log(f"  one layer's call at E={inp['x'].shape[0]}, K={K}, C={SN_C}: "
        f"{inp['work']['triplets']} real triplets; pt chain = basis_pt_k "
        f"and the fused_triplet_slot kernels through autograd:")
    for r in rows:
        log(f"  {r['kernel']} {r['precision']}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.4f} of it; {r['flops'] / 1e9:.3f} "
            f"GFLOP f32, {r['bytes'] / 1e6:.2f} MB); "
            + ("" if r["chain_ms"] is None else
               f"pt chain {r['chain_ms']:.4f} ms; ")
            + f"plain {r['plain_ms']:.3f} ms"
            + ("" if r["library_ms"] is None else
               f"; einsum over sbf and tbf assembled outside the timed call "
               f"{r['library_ms']:.3f} ms (rel err {r['library_err']:.2e})")
            + ("" if r["split"] is None else f"; {split_text(r['split'])}"))
    return rows


# ---------------------------------------------------------------------------
# Path 7b: the chunked sorted-CSR segment sum and spmm_csr
# ---------------------------------------------------------------------------

_MEMO = {}


def large_graph():
    """synthetic_large_graph(60000, seed=0, avg_deg=16), the graph of paths
    7b, 9 and 16 (bench.py bench_spmm_roofline and bench_lsgraph), built
    once a process; its generator draws about 960,000 edge ends in a
    Python loop, timed."""
    from dig_tpu_torch.lsgraph import synthetic_large_graph
    if "g60k" in _MEMO:
        return _MEMO["g60k"]
    t = time.perf_counter()
    g = synthetic_large_graph(CS_N, seed=0, avg_deg=16)
    log(f"  synthetic_large_graph({CS_N}, avg_deg=16): "
        f"{len(g['senders'])} directed edges in "
        f"{time.perf_counter() - t:.1f} s (host)")
    _MEMO["g60k"] = g
    return g


def cs_graph(torch, dev, g):
    """bench.py bench_spmm_roofline's graph (:560-571), ``g`` of
    large_graph(): receivers sorted into seg and rowptr, data [E, 128] f32
    from default_rng(0); the senders in the same order as spmm_csr's
    columns."""
    import numpy as np
    order = np.argsort(g["receivers"], kind="stable")
    seg = g["receivers"][order].astype(np.int32)
    E = len(seg)
    rowptr = np.zeros(CS_N + 1, np.int32)
    np.add.at(rowptr, seg + 1, 1)
    rowptr = np.cumsum(rowptr).astype(np.int32)
    data = np.random.default_rng(0).normal(size=(E, CS_F)).astype(np.float32)
    return {"seg": torch.from_numpy(seg).to(dev),
            "rowptr_np": rowptr, "rowptr": torch.from_numpy(rowptr).to(dev),
            "col": torch.from_numpy(
                g["senders"][order].astype(np.int32)).to(dev),
            "data": torch.from_numpy(data).to(dev), "N": CS_N, "E": E,
            "max_degree": int(np.diff(rowptr).max())}


def cs_skewed(torch, dev):
    """Phase 12's skewed CSR (one row holds a quarter of 20,000 edges, every
    50th row empty, a -1 tail of 512) at F = 128, f32."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    N, E = 1000, 20000
    rows = torch.randint(0, N, (E,), generator=gen)
    rows = rows[rows % 50 != 7]
    rows[: E // 4] = 123
    seg = torch.sort(rows).values.to(torch.int32)
    rowptr = torch.searchsorted(seg, torch.arange(N + 1, dtype=torch.int32),
                                out_int32=True)
    seg = torch.cat([seg, torch.full((512,), -1, dtype=torch.int32)])
    data = torch.randn(seg.shape[0], CS_F, generator=gen)
    return {"seg": seg.to(dev), "rowptr_np": rowptr.numpy(),
            "rowptr": rowptr.to(dev), "data": data.to(dev), "N": N}


def phase_cs_path(torch, sc, g, skew):
    """Path 7b: the chunked sum against its plain version (CS_TOL on the
    bench graph, SEG_TOL on the skewed CSR) and against the ported
    segment_sum_sorted_csr over a full window (the same bits), f32 and
    bf16 (float32 out); repeated calls the same bits; the VJP against the
    plain one; spmm_csr with seeded values against its plain version; one
    chunked launch per forward and none in its VJP."""
    errs = {}
    for name, c in (("bench graph", g), ("skewed", skew)):
        for dt in (torch.float32, torch.bfloat16):
            data, seg, rp, N = c["data"].to(dt), c["seg"], c["rowptr"], c["N"]
            BN, EB, meta_np, _ = sc.choose_chunk_plan(c["rowptr_np"], N,
                                                      data.shape[1], dt)
            meta = torch.from_numpy(meta_np).to(data.device)
            before = sc.launches_chunked
            out = sc.segment_sum_sorted_csr_chunked(data, seg, meta, N, BN, EB)
            torch.cuda.synchronize()
            if sc.launches_chunked != before + 1:
                fail(f"chunked sum {name}: {sc.launches_chunked - before} "
                     f"launches")
            want = sc.segment_sum_sorted_csr_chunked_reference(
                data, seg, meta, N, BN, EB)
            full = sc.segment_csr_launch(data.contiguous(), seg, rp, N)
            e, same_full = rel_err(out, want), torch.equal(out, full)
            tol = CS_TOL if name == "bench graph" else SEG_TOL
            again = sc.segment_sum_sorted_csr_chunked(data, seg, meta, N, BN,
                                                      EB)
            same = torch.equal(again, out)
            log(f"  {name} {str(dt)[6:]} N={N} E={data.shape[0]} "
                f"F={data.shape[1]}: plan BN={BN} EB={EB}, "
                f"{meta.shape[1]} chunks; rel err {e:.2e} against plain "
                f"(held to {tol}); the same bits as segment_sum_sorted_csr: "
                f"{same_full}; repeated call the same bits: {same}")
            if out.dtype != torch.float32 or e >= tol or not same_full:
                fail(f"chunked sum {name} {dt}: rel err {e}, the same bits "
                     f"as segment_sum_sorted_csr: {same_full}")
            if not same:
                fail(f"chunked sum {name} {dt} not bitwise repeatable")
            if name == "bench graph" and dt == torch.float32:
                errs["fwd"] = float((out - want).abs().max())
                gen = torch.Generator(device="cpu").manual_seed(8)
                cw = torch.randn(N, data.shape[1], generator=gen).to(
                    data.device)
                res = []
                for fn in (sc.segment_sum_sorted_csr_chunked,
                           sc.segment_sum_sorted_csr_chunked_reference):
                    d = data.clone().requires_grad_()
                    (gd,) = torch.autograd.grad(
                        (fn(d, seg, meta, N, BN, EB) * cw).sum(), d)
                    res.append(gd)
                e_vjp = rel_err(res[0], res[1])
                log(f"    VJP (the row gather) rel err {e_vjp:.2e}")
                if e_vjp >= CS_TOL:
                    fail(f"chunked sum VJP: rel err {e_vjp}")
    gen = torch.Generator(device="cpu").manual_seed(9)
    val = torch.randn(g["E"], generator=gen).to(g["data"].device)
    x = torch.randn(g["N"], CS_F, generator=gen).to(g["data"].device)
    before = sc.launches
    got = sc.spmm_csr(g["rowptr"], g["col"], val, x, g["N"],
                      max_edges_per_block=sc.full_window(g["E"]))
    torch.cuda.synchronize()
    want = sc.segment_sum_sorted_csr_reference(
        x[g["col"].long()] * val[:, None], g["seg"], g["rowptr"], g["N"])
    e = rel_err(got, want)
    log(f"  spmm_csr on the bench graph (seeded values, x [{g['N']}, "
        f"{CS_F}]): rel err {e:.2e} against its plain version; "
        f"{sc.launches - before} segment-sum launch")
    if e >= CS_TOL or sc.launches - before != 1:
        fail(f"spmm_csr: rel err {e}, {sc.launches - before} launches")
    return errs


def cs_bound(data, seg, N):
    """Least time at this data: each counted edge row, its id and the
    float32 output once (bytes; 0.157 ms for f32 at the bench graph), one
    add per element of a counted row (f32 operations)."""
    nnz = int((seg >= 0).sum())
    F = data.shape[1]
    nbytes = nnz * F * data.element_size() + 4 * nnz + 4 * N * F
    t_bytes, t_ops = nbytes / PEAK_BYTES, nnz * F / PEAK_FLOPS["f32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_cs_times(torch, sc, g):
    """Per call at path 7b's shape (f32 and bf16; CUDA events): the bare
    chunked launch beside its bound, its plain version, the ported
    segment sum (segment_csr_launch) on the same graph,
    torch.segment_reduce and index_add_ (library_ms: the faster of the
    two)."""
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        data, seg, rp, N = g["data"].to(dt), g["seg"], g["rowptr"], g["N"]
        BN, EB, meta_np, _ = sc.choose_chunk_plan(g["rowptr_np"], N,
                                                  data.shape[1], dt)
        meta = torch.from_numpy(meta_np).to(data.device)
        ms = cuda_ms(torch, lambda: sc.segment_csr_chunked_launch(
            data, seg, meta, N, BN, EB), iters=50)
        plain = cuda_ms(
            torch, lambda: sc.segment_sum_sorted_csr_chunked_reference(
                data, seg, meta, N, BN, EB), iters=5, warmup=1)
        csr = cuda_ms(torch, lambda: sc.segment_csr_launch(data, seg, rp, N),
                      iters=50)
        lib = {"index_add_": cuda_ms(torch, lambda: torch.zeros(
            N, data.shape[1], dtype=dt, device=data.device).index_add_(
                0, seg.long(), data), iters=20)}
        try:
            lib["segment_reduce"] = cuda_ms(torch, lambda: torch.segment_reduce(
                data, "sum", offsets=rp.long(), axis=0), iters=20)
        except RuntimeError as exc:          # a yardstick only, not the port
            log(f"  torch.segment_reduce does not run here: "
                f"{str(exc).splitlines()[0]}")
        best = min(lib, key=lib.get)
        b = cs_bound(data, seg, N)
        rows.append({"dtype": str(dt)[6:], "BN": BN, "EB": EB,
                     "chunks": meta.shape[1], "ms": ms, "plain_ms": plain,
                     "csr_ms": csr, "library": lib, "library_ms": lib[best],
                     "bound_ms": b[0], "bound_by": b[1], "bytes": b[2]})
    for r in rows:
        libs = ", ".join(f"{k} {v:.4f} ms" for k, v in r["library"].items())
        log(f"  segment_sum_sorted_csr_chunked {r['dtype']} (BN={r['BN']}, "
            f"EB={r['EB']}, {r['chunks']} chunks): {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bytes'] / 1e6:.2f} MB, {r['bound_ms'] / r['ms']:.3f} of "
            f"it); segment sum {r['csr_ms']:.4f} ms; plain "
            f"{r['plain_ms']:.3f} ms; {libs}")
    return rows


# ---------------------------------------------------------------------------
# Paths 8a-8c: ComENet, ComENet-OCP, ProNet; SchNetDense forces; remat
# ---------------------------------------------------------------------------

def first_step_vs_cpu(torch, what, build, dev, tol=CPU_STEP_TOL,
                      repeat=False, noise_floor=None):
    """One step's loss and gradients on the card (the kernels) and on the
    CPU (every op its plain version), from the same seeded weights, batch
    and noise. ``build(d) -> (loss, modules)`` makes the step on device
    ``d``; a loss that still carries its graph is backpropagated here (a
    trainer's step runs its own backward and returns it detached). The
    loss within tol[0] (relative), every parameter's gradient within
    tol[1] (||a-b|| / ||b||; zeros where none reaches it). ``repeat``: the
    card step again must give the same bits. ``noise_floor``: a parameter
    whose CPU gradient lies below noise_floor x the model's largest
    gradient entry (a direction the loss does not see, its gradient
    rounding noise) must have the card's below it too, and is left out of
    the relative check. Returns the errors."""
    def grads(d):
        t = time.perf_counter()
        loss, mods = build(d)
        if loss.requires_grad:
            loss.backward()
        ps = _params(torch, mods)
        return (loss.detach().float().cpu(), [n for n, _ in ps],
                [torch.zeros(p.shape) if p.grad is None
                 else p.grad.detach().float().cpu() for _, p in ps],
                time.perf_counter() - t)
    runs = [grads(d) for d in [dev] * (2 if repeat else 1)
            + [torch.device("cpu")]]
    (lk, names, gk, card_s), (lp, _, gp, cpu_s) = runs[0], runs[-1]
    loss_err = float((lk - lp).abs() / lp.abs().clamp_min(1e-12))
    floor = (0.0 if noise_floor is None else
             noise_floor * max(float(g.abs().max()) for g in gp))
    quiet = [n for a, b, n in zip(gk, gp, names)
             if float(b.abs().max()) < floor]
    loud_card = [n for a, b, n in zip(gk, gp, names)
                 if n in quiet and float(a.abs().max()) >= floor]
    if loud_card:
        fail(f"{what}: gradients at rounding level on the CPU but not on "
             f"the card: {loud_card}")
    per = sorted(((rel_norm(torch, [a], [b]), n)
                  for a, b, n in zip(gk, gp, names) if n not in quiet),
                 reverse=True)
    same = None
    if repeat:
        l2, _, g2, _ = runs[1]
        same = bool(torch.equal(lk, l2)) and all(
            torch.equal(a, b) for a, b in zip(gk, g2))
    if quiet:
        log(f"  {what}: rounding-level gradients (largest |entry|, card / "
            f"CPU): " + ", ".join(
                f"{n} {float(a.abs().max()):.2e} / {float(b.abs().max()):.2e}"
                for a, b, n in zip(gk, gp, names) if n in quiet))
    log(f"  {what}: first step, card against CPU: loss {float(lk):.7f} / "
        f"{float(lp):.7f} (rel {loss_err:.3e}, held to {tol[0]}); "
        f"{len(names)} gradients, rel-norm err {rel_norm(torch, gk, gp):.3e}"
        " over all, worst "
        + ", ".join(f"{n} {e:.3e}" for e, n in per[:3])
        + f" (each held to {tol[1]})"
        + (f"; rounding-level gradients on both: {quiet}" if quiet else "")
        + ("" if same is None else
           f"; the card step repeated: the same bits {same}")
        + f"; card {card_s:.2f} s, CPU {cpu_s:.1f} s")
    if not math.isfinite(float(lk)) or loss_err >= tol[0]:
        fail(f"{what}: first-step loss card {float(lk)} vs CPU {float(lp)}")
    if not per[0][0] < tol[1]:
        fail(f"{what}: first-step gradients differ from the CPU's: {per[:3]}")
    if same is False:
        fail(f"{what}: the repeated card step gave other bits")
    return {"loss_rel_err": loss_err, "worst_param": per[0],
            "same_bits": same}


def trainer_build(torch, make_model, make_step, batch_dev, batch_cpu):
    """``first_step_vs_cpu``'s build for a ``make_step_fns`` trainer: its
    train step at lr 0 on the batch of the device."""
    def build(d):
        m = make_model(d)
        b = batch_cpu if d.type == "cpu" else batch_dev
        return make_step(m, torch.optim.SGD(m.parameters(), lr=0.0))(b)[
            "loss"], [m]
    return build


def _params(torch, mods):
    """(name, parameter) of the modules, each parameter once."""
    seen, out = set(), []
    for i, m in enumerate(mods):
        for n, p in m.named_parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append((f"{i}.{n}", p))
    return out


def uncapped_pairs(torch, b, cutoff):
    """In-cutoff directed pairs of one graph (as Run3D counts them) and
    the largest in-degree."""
    from dig_tpu_torch.ops.radius import _pairwise_same_graph
    d2, valid = _pairwise_same_graph(b.nodes["pos"], b.node_graph,
                                     b.node_mask)
    adj = valid & (d2 < cutoff * cutoff)
    return int(adj.sum()), int(adj.sum(1).max())


def new_path_steps(torch, cf, ts, sc, what, model, train_step, batches,
                   warmup, pairs):
    """The timed steps of a new path: losses, step ms, edges/s over the
    uncapped pairs ``pairs`` (one per batch), the segment-sum launches a
    step (the same every step) and the calls by shape; no kernel of
    another path launched."""
    reset_all(cf, ts, sc)
    per_step = []
    with SegmentCalls(sc) as calls:
        losses, t_start = [], None
        for s, b in enumerate(batches):
            if s == warmup:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            before = sc.launches
            losses.append(train_step(b)["loss"])
            per_step.append(sc.launches - before)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t_start
    losses = [float(x) for x in losses]
    others_idle(cf, ts, what)
    timed = len(batches) - warmup
    step_ms = dt / timed * 1e3
    edges = sum(pairs[warmup:])
    log(f"  {len(batches)} Adam steps, losses {[round(x, 5) for x in losses]}")
    shapes = calls.per_step(len(batches))
    log(f"  segment-sum launches a step {per_step}: "
        + ", ".join(f"{n:g} x (E {k[0]}, F {k[1]}, rows {k[2]}, {k[3]})"
                    for k, n in sorted(shapes.items())))
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss")
    if min(per_step) == 0 or len(set(per_step)) != 1:
        fail(f"{what}: segment-sum launches a step {per_step}")
    log(f"  step {step_ms:.3f} ms (mean of {timed} steps); "
        f"{edges / dt:.6g} edges/s over {edges / timed:.0f} in-cutoff "
        f"pairs per step")
    return {"launches": sc.launches, "per_step": per_step[0],
            "losses": losses, "step_ms": step_ms, "edges_per_s": edges / dt,
            "pairs_per_step": edges / timed, "calls": calls,
            "by_shape": shapes}


def ce_molecules(n, seed=0):
    from dig_tpu_torch.datasets import synthetic_molecules
    mols = synthetic_molecules(n, seed=seed, min_atoms=12, max_atoms=CE_A,
                               box=6.0, with_forces=True)
    return [dict(m, y=m["y"][:1]) for m in mols]


def ce_model(torch, dev):
    from dig_tpu_torch.models import ComENet
    return ComENet(**CE_KW, generator=torch.Generator().manual_seed(0),
                   device=dev)


def phase_ce_main_path(torch, cf, ts, sc, dev):
    """Path 8a: ComENet energy+force at its published widths on the
    NK-blocked layout (K = 28 keeps every pair of a 29-atom slot)."""
    from dig_tpu_torch.datasets import MoleculeLoader
    from dig_tpu_torch.ops.radius import radius_blocked_dropped
    from dig_tpu_torch.threed import Run3D, ThreeDEvaluator
    from dig_tpu_torch.train import make_step_fns
    mols = ce_molecules(CE_G * CE_STEPS)
    loader = lambda d: MoleculeLoader(mols, CE_G, slot_size=CE_A, device=d)
    batches = list(loader(dev))
    pairs, deg = zip(*(uncapped_pairs(torch, b, CE_KW["cutoff"])
                       for b in batches))
    dropped = [int(radius_blocked_dropped(
        b.nodes["pos"], b.node_graph, b.node_mask, CE_KW["cutoff"], CE_A))
        for b in batches]
    log(f"  largest in-degree {max(deg)} (K = {CE_KW['nk_degree']}); "
        f"radius_blocked_dropped {dropped}")
    if any(dropped) or max(deg) > CE_KW["nk_degree"]:
        fail("path 8a: the NK table drops pairs")
    make_step = lambda m, opt: make_step_fns(m, opt, energy_and_force=True,
                                             p=CE_P, loss="l1")[0]
    first = first_step_vs_cpu(torch, "path 8a", trainer_build(
        torch, lambda d: ce_model(torch, d), make_step, batches[0],
        next(iter(loader("cpu")))), dev)
    model = ce_model(torch, dev)
    opt = torch.optim.Adam(model.parameters(), lr=CE_LR)
    train_step, eval_step = make_step_fns(model, opt, energy_and_force=True,
                                          p=CE_P, loss="l1")
    torch.cuda.reset_peak_memory_stats()
    res = new_path_steps(torch, cf, ts, sc, "path 8a", model, train_step,
                         batches, CE_WARMUP, pairs)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out = eval_step(batches[0])
    if not bool(torch.isfinite(out["force_pred"]).all()):
        fail("path 8a: non-finite forces")
    log(f"  eval: forces finite (largest |F| "
        f"{float(out['force_pred'].abs().max()):.4g}); peak device memory "
        f"{res['peak_gib']:.2f} GiB")
    t = time.perf_counter()
    run = Run3D().run(mols[:2 * CE_G], mols[2 * CE_G:3 * CE_G],
                      mols[3 * CE_G:4 * CE_G], ce_model(torch, dev),
                      ThreeDEvaluator(), epochs=1, batch_size=CE_G,
                      vt_batch_size=CE_G, lr=CE_LR, energy_and_force=True,
                      p=CE_P, slot_size=CE_A, quiet=True, device=dev)
    log(f"  Run3D epoch (2 training batches, one validation, one test): "
        f"valid MAE {run['best_valid']:.5f}, test {run['best_test']:.5f}; "
        f"{time.perf_counter() - t:.1f} s")
    if not math.isfinite(run["best_valid"] + run["best_test"]):
        fail("path 8a: Run3D gave a non-finite MAE")
    res["first_step"] = first
    return res


def ocp_batches(torch, n, dev):
    """Crystals of 20-80 atoms (OC20's S2EF structures hold tens to a
    couple of hundred), the Morse forces of the open-boundary atoms as the
    force target, batches of OCP_G."""
    from dig_tpu_torch.datasets import (MoleculeLoader, morse_energy,
                                        synthetic_crystals)
    cr = synthetic_crystals(OCP_G * n, seed=0, min_atoms=OCP_ATOMS[0],
                            max_atoms=OCP_ATOMS[1])
    cr = [dict(c, force=morse_energy(c["z"], c["pos"])[1]) for c in cr]
    pad = OCP_G * OCP_ATOMS[1]
    return (list(MoleculeLoader(cr, OCP_G, n_node_pad=pad, device=dev)),
            next(iter(MoleculeLoader(cr, OCP_G, n_node_pad=pad,
                                     device="cpu"))))


def phase_ocp_main_path(torch, cf, ts, sc, dev):
    """Path 8b: ComENet-OCP energy+force on periodic crystals, max_edges
    sized by pbc_overflow so that nothing is dropped."""
    from dig_tpu_torch.models import ComENetOCP
    from dig_tpu_torch.ops.pbc import pbc_overflow, radius_graph_pbc_flat
    from dig_tpu_torch.train import make_step_fns
    batches, cpu_b = ocp_batches(torch, OCP_STEPS, dev)
    args = lambda b: (b.nodes["pos"], b.globals["cell"], b.node_graph,
                      b.node_mask, OCP_KW["cutoff"])
    pairs = [int(pbc_overflow(*args(b), 0)) for b in batches]
    max_edges = -(-max(pairs) // 1024) * 1024
    over = [int(pbc_overflow(*args(b), max_edges)) for b in batches]
    b0 = batches[0]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    radius_graph_pbc_flat(*args(b0), max_edges)
    torch.cuda.synchronize()
    build_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"  periodic edges per batch {min(pairs)}-{max(pairs)}; max_edges "
        f"{max_edges}, pbc_overflow {over}; the [N, N, 27] build of N = "
        f"{b0.num_nodes} rows peaks at {build_gib:.3f} GiB above its "
        f"inputs")
    if any(over):
        fail("path 8b: the edge cap drops periodic edges")
    kw = dict(OCP_KW, max_edges=max_edges)
    make_model = lambda d: ComENetOCP(
        **kw, generator=torch.Generator().manual_seed(0), device=d)
    make_step = lambda m, opt: make_step_fns(m, opt, energy_and_force=True,
                                             p=CE_P, loss="l1")[0]
    first = first_step_vs_cpu(torch, "path 8b", trainer_build(
        torch, make_model, make_step, b0, cpu_b), dev)
    model = make_model(dev)
    opt = torch.optim.Adam(model.parameters(), lr=CE_LR)
    train_step, eval_step = make_step_fns(model, opt, energy_and_force=True,
                                          p=CE_P, loss="l1")
    torch.cuda.reset_peak_memory_stats()
    res = new_path_steps(torch, cf, ts, sc, "path 8b", model, train_step,
                         batches, CE_WARMUP, pairs)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out = eval_step(b0)
    if not bool(torch.isfinite(out["force_pred"]).all()):
        fail("path 8b: non-finite forces")
    log(f"  eval: forces finite (largest |F| "
        f"{float(out['force_pred'].abs().max()):.4g}); peak device memory "
        f"{res['peak_gib']:.2f} GiB")
    res.update(first_step=first, build_gib=build_gib, max_edges=max_edges)
    return res


def pn_batches(torch, n, dev):
    from dig_tpu_torch.datasets import ProteinLoader, synthetic_proteins
    prots = synthetic_proteins(PN_G * n, min_res=PN_RES[0],
                               max_res=PN_RES[1], seed=0)
    mk = lambda d: ProteinLoader(prots, PN_G, slot_size=PN_RES[1], device=d)
    return list(mk(dev)), next(iter(mk("cpu")))


def phase_pn_main_path(torch, cf, ts, sc, dev):
    """Path 8c: ProNet (all-atom) energy training at its published widths
    on the NK-blocked layout, K = 32, deterministic."""
    from dig_tpu_torch.models import ProNet
    from dig_tpu_torch.ops.radius import (radius_blocked_dropped,
                                          radius_graph_nk_blocked)
    from dig_tpu_torch.train import make_step_fns
    batches, cpu_b = pn_batches(torch, PN_STEPS, dev)
    cut, K, A = PN_KW["cutoff"], PN_KW["nk_degree"], PN_KW["block_size"]
    pairs, deg = zip(*(uncapped_pairs(torch, b, cut) for b in batches))
    kept = [int(radius_graph_nk_blocked(b.nodes["pos"], b.node_mask, cut, K,
                                        A, node_graph=b.node_graph)
                .edge_mask.sum()) for b in batches]
    dropped = [int(radius_blocked_dropped(b.nodes["pos"], b.node_graph,
                                          b.node_mask, cut, A))
               for b in batches]
    log(f"  in-cutoff pairs per batch {min(pairs)}-{max(pairs)}, largest "
        f"in-degree {max(deg)}; the K = {K} table keeps "
        f"{sum(kept) / sum(pairs):.4f} of them (the reference's "
        f"max_num_neighbors = 32 cap, symmetrised); radius_blocked_dropped "
        f"{dropped}")
    if any(dropped):
        fail("path 8c: the batches are not slot-aligned")
    make_model = lambda d: ProNet(
        **PN_KW, generator=torch.Generator().manual_seed(0), device=d)
    make_step = lambda m, opt: make_step_fns(m, opt, loss="l1")[0]
    first = first_step_vs_cpu(torch, "path 8c", trainer_build(
        torch, make_model, make_step, batches[0], cpu_b), dev)
    model = make_model(dev)
    opt = torch.optim.Adam(model.parameters(), lr=PN_LR)
    train_step, eval_step = make_step_fns(model, opt, loss="l1")
    torch.cuda.reset_peak_memory_stats()
    res = new_path_steps(torch, cf, ts, sc, "path 8c", model, train_step,
                         batches, PN_WARMUP, pairs)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out = eval_step(batches[0])
    if not bool(torch.isfinite(out["y_pred"]).all()):
        fail("path 8c: non-finite outputs")
    res["kept_edges_per_s"] = (sum(kept[PN_WARMUP:]) * res["edges_per_s"]
                               / sum(pairs[PN_WARMUP:]))
    log(f"  {res['kept_edges_per_s']:.6g} edges/s counting the kept NK "
        f"edges; peak device memory {res['peak_gib']:.2f} GiB")
    res["first_step"] = first
    return res


def new_seg_rows(torch, sc, results):
    """Every segment-sum call shape of paths 8a-8c, timed as phase 15's
    (seg_time_row), on the ids and row pointer of its first call and
    seeded rows; each row with its calls a step."""
    gen = torch.Generator(device="cpu").manual_seed(8)
    rows = []
    for path, res in results.items():
        calls = res["calls"]
        for key, n in sorted(res["by_shape"].items()):
            E, F, N, dname, full = key
            seg, rp = calls.ids[key], calls.rowptr[key]
            dt = getattr(torch, dname)
            data = torch.randn(E, F, generator=gen).to(seg.device, dt)
            c = {"name": f"{path}_{'window' if full else 'eb'}", "seg": seg,
                 "rowptr": rp, "N": N, "data": data,
                 "eb": sc.full_window(E) if full else 1024}
            r = seg_time_row(torch, sc, c)
            r.update(path=path, per_step=n)
            seg_log_row(r)
            rows.append(r)
    return rows


def phase_dense_forces(torch, cf, dev, batches):
    """SchNetDense at path 1's model and buckets: F = -dE/dpos through the
    cfconv kernels (pos_grads=True: the backward with need_dist_grad)
    against the einsum branch of the same weights; f32 held to
    DENSE_F_TOL (relative norm), bf16 by direction and size against the
    f32 einsum forces (SF_BF16_COS, SF_BF16_NORM; per bucket in place of
    per parameter). The forward plus the force pass timed."""
    from dig_tpu_torch.models import SchNetDense

    def forces(cd, kernel):
        m = SchNetDense(cutoff=CUTOFF, num_layers=LAYERS,
                        hidden_channels=HIDDEN, num_filters=HIDDEN,
                        num_gaussians=GAUSSIANS, compute_dtype=cd,
                        use_kernel=kernel, pos_grads=True,
                        generator=torch.Generator().manual_seed(0),
                        device=dev)

        def run():
            out = []
            for n, b in sorted(batches.items()):
                pos = b.pos.detach().requires_grad_()
                e = m(b.replace(pos=pos))
                (g,) = torch.autograd.grad(e.sum(), pos)
                out.append(-g)
            return out
        return m, run

    need = []
    orig = cf.cfconv_backward_kernel

    def noted(*a):
        need.append(bool(a[-1]))
        return orig(*a)
    res = {}
    for prec, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        _, run_k = forces(cd, True)
        cf.reset_launch_counts()
        cf.cfconv_backward_kernel = noted
        try:
            fk = run_k()
        finally:
            cf.cfconv_backward_kernel = orig
        counts = (cf.launches_fwd, cf.launches_bwd)
        want = LAYERS * len(batches)
        if counts != (want, want) or not all(need):
            fail(f"SchNetDense forces {prec}: cfconv launches {counts} "
                 f"(want {want} each), need_dist_grad {set(need)}")
        need.clear()
        ms = cuda_ms(torch, run_k, iters=5, warmup=1)
        _, run_e = forces(cd, False)
        fe = run_e()
        if not all(bool(torch.isfinite(f).all()) for f in fk):
            fail(f"SchNetDense forces {prec}: non-finite")
        res[prec] = {"kernel": fk, "einsum": fe, "ms": ms,
                     "einsum_ms": cuda_ms(torch, run_e, iters=5, warmup=1)}
    err = rel_norm(torch, res["f32"]["kernel"], res["f32"]["einsum"])
    log(f"  f32: forces through the kernels against the einsum branch, "
        f"rel-norm err {err:.3e} (held to {DENSE_F_TOL}); "
        f"{LAYERS * len(batches)} forward and backward cfconv launches a "
        f"pass, every backward with need_dist_grad")
    if not err < DENSE_F_TOL:
        fail(f"SchNetDense f32 forces differ: {err}")
    names = [f"bucket {n}" for n in sorted(batches)]
    a = agreement(torch, res["bf16"]["kernel"], res["f32"]["einsum"], names)
    log(f"  bf16: the kernels' forces against the f32 einsum ones: cosine "
        f"{a['cos']:.4f}, median bucket {a['median_cos']:.4f}; norm "
        f"{a['norm']:.4f} x, per bucket {a['least'][0]:.4f} to "
        f"{a['largest'][0]:.4f}")
    if (not a["cos"] >= SF_BF16_COS[0] or not a["median_cos"] >= SF_BF16_COS[1]
            or not SF_BF16_NORM[0] <= a["least"][0]
            or not a["largest"][0] <= SF_BF16_NORM[1]):
        fail(f"SchNetDense bf16 forces: {a}")
    for prec in ("bf16", "f32"):
        log(f"  {prec}: forward + force pass over the 3 buckets "
            f"{res[prec]['ms']:.3f} ms through the kernels, "
            f"{res[prec]['einsum_ms']:.3f} ms through the einsum branch")
    return {"f32_err": err, "bf16": a, "ms": res["bf16"]["ms"],
            "ms_f32": res["f32"]["ms"],
            "launches_bwd": LAYERS * len(batches)}


def remat_step(flag, prec, out, trace=None):
    """``chip_smoke.py --remat-step 0|1 bf16|f32 OUT``: one path-3 force
    step on its 29-atom bucket from the seeded state, ``remat`` off or on;
    the loss, the gradients, the parameters after Adam and the step's peak
    device memory go to OUT. ``trace(torch, model)``: an object set on the
    model before the step, whose ``result()`` goes to OUT too
    (scripts/remat_bits.py)."""
    import torch
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train import make_bucketed_step_fns
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cd = {"bf16": torch.bfloat16, "f32": torch.float32}[prec]
    model = SphereNet(**SN_KW, **SN_SLOT, compute_dtype=cd,
                      remat=flag == "1",
                      generator=torch.Generator().manual_seed(0), device=dev)
    batch = {29: sf_batches(torch, dev, 1)[0][29]}
    step = make_bucketed_step_fns(
        model, torch.optim.Adam(model.parameters(), lr=5e-4), p=SF_P)[0]
    tracer = trace(torch, model) if trace is not None else None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = step(batch)["loss"]
    torch.cuda.synchronize()
    named = list(model.named_parameters())
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.ops import triplet_slot as ts
    torch.save({"loss": loss.detach().cpu(),
                "peak": torch.cuda.max_memory_allocated() - base,
                "launches": (ts.launches_fwd, ts.launches_bwd,
                             ts.launches_bwd_dpt, ts.launches_bwd2,
                             sc.launches),
                "trace": tracer.result() if tracer is not None else None,
                "grad": {n: p.grad.detach().float().cpu() for n, p in named},
                "param": {n: p.detach().cpu() for n, p in named}}, out)


def phase_remat(torch):
    """Path 3's force step on one bucket with remat off and on, each in a
    fresh process (as phase 23: within one process the autograd engine's
    order of the outer backward can differ between two steps), in bf16 (the
    path's type) and f32: the loss, the gradients, the parameters after
    Adam, and the peak memory of each. Held: the loss within REMAT_TOL,
    the f32 gradients within REMAT_TOL per parameter, the bf16 gradient to
    the f32 one by direction and size (path 3's bf16 gate)."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = {(prec, flag): os.path.join(tmp, f"remat_{prec}_{flag}.pt")
                for prec in ("bf16", "f32") for flag in ("0", "1")}
        run_fresh({f"remat {flag} {prec} step process":
                   ["--remat-step", flag, prec, out]
                   for (prec, flag), out in outs.items()})
        runs = {k: torch.load(out) for k, out in outs.items()}
    res = {}
    for prec in ("bf16", "f32"):
        a, b = runs[prec, "0"], runs[prec, "1"]
        names = list(a["param"])
        same_p = sum(torch.equal(a["param"][n], b["param"][n]) for n in names)
        same_g = sum(torch.equal(a["grad"][n], b["grad"][n]) for n in names)
        per = sorted(((rel_norm(torch, [b["grad"][n]], [a["grad"][n]]), n)
                      for n in names), reverse=True)
        moved = max(float((b["param"][n] - a["param"][n]).abs().max())
                    for n in names)
        loss_err = abs(float(b["loss"]) - float(a["loss"])) / abs(
            float(a["loss"]))
        log(f"  {prec}: loss remat off {float(a['loss']):.7f}, on "
            f"{float(b['loss']):.7f} (the same bits: "
            f"{torch.equal(a['loss'], b['loss'])}); gradients the same bits "
            f"in {same_g} of {len(names)} parameters, rel-norm err worst "
            + ", ".join(f"{n} {e:.3e}" for e, n in per[:3])
            + f"; parameters after Adam the same bits in {same_p} of "
            f"{len(names)}, largest difference {moved:.3e} (lr 5e-4)")
        log(f"  {prec}: peak device memory of the step above its inputs: "
            f"remat off {a['peak'] / 2 ** 30:.3f} GiB, on "
            f"{b['peak'] / 2 ** 30:.3f} GiB; launches (slot forward, "
            f"backward, backward with dpt, second order; segment sum) off "
            f"{a['launches']}, on {b['launches']}")
        if not loss_err < REMAT_TOL:
            fail(f"remat changes the {prec} loss: {loss_err}")
        if prec == "f32" and not per[0][0] < REMAT_TOL:
            fail(f"remat changes the f32 gradients: {per[:3]}")
        res[prec] = {"same_loss": torch.equal(a["loss"], b["loss"]),
                     "same_grads": same_g, "same_params": same_p,
                     "params": len(names), "worst_grad": per[0],
                     "peak_gib": (a["peak"] / 2 ** 30, b["peak"] / 2 ** 30)}
    for flag in ("0", "1"):
        g = [runs["bf16", flag]["grad"][n] for n in runs["f32", flag]["grad"]]
        ref = list(runs["f32", flag]["grad"].values())
        ag = agreement(torch, g, ref, list(runs["f32", flag]["grad"]))
        log(f"  remat {'on' if flag == '1' else 'off'}: the bf16 gradient "
            f"against the f32 one: cosine {ag['cos']:.4f}, median parameter "
            f"{ag['median_cos']:.4f}; norm {ag['norm']:.4f} x")
        if (not ag["cos"] >= SF_BF16_COS[0]
                or not ag["median_cos"] >= SF_BF16_COS[1]
                or not SF_BF16_NORM[0] <= ag["least"][0]
                or not ag["largest"][0] <= SF_BF16_NORM[1]):
            fail(f"remat {flag}: the bf16 gradient against the f32 one: {ag}")
    return res


# ---------------------------------------------------------------------------
# Path 9: lsgraph, bench_lsgraph's partitioned GCN training epoch
# ---------------------------------------------------------------------------

def ls_setup(g):
    """Path 9's host side, bench.py bench_lsgraph's (:378-400): the graph
    ``g`` of large_graph() in LS_PARTS parts through the native partitioner
    (which must be available, so the card path never partitions another
    way), LS_BATCH_PARTS a batch, segment_eb from both row pointers of every
    subgraph (block_rows LS_BR); the features and labels in the loader's
    node order."""
    import numpy as np
    from dig_tpu_torch import native
    from dig_tpu_torch.lsgraph import SubgraphLoader, metis_permute
    from dig_tpu_torch.ops.segment_csr import csr_window
    if not native.available():
        fail("path 9: the native partitioner is not available")
    s, r, N = g["senders"], g["receivers"], len(g["y"])
    t = time.perf_counter()
    perm, ptr, part = metis_permute(s, r, N, LS_PARTS, seed=0)
    t_part = time.perf_counter() - t
    t = time.perf_counter()
    subs = list(SubgraphLoader(s, r, N, ptr, perm,
                               batch_parts=LS_BATCH_PARTS))
    t_load = time.perf_counter() - t
    eb = csr_window([rp for b in subs for rp in (b.rowptr, b.rowptr_rev)],
                    LS_BR)
    edges = [int(b.edge_mask.sum()) for b in subs]
    log(f"  native partition into {LS_PARTS} parts {t_part:.1f} s (edge "
        f"cut {int((part[s] != part[r]).sum())} of {len(s)}), loader "
        f"{t_load:.1f} s; segment_eb {eb} (block_rows {LS_BR})")
    for b, e in zip(subs, edges):
        deg = np.diff(b.rowptr)
        log(f"  subgraph: {b.batch_size} in-batch + "
            f"{int(b.node_mask.sum()) - b.batch_size} halo of "
            f"{len(b.n_id)} rows, {e} of {len(b.senders)} edges, "
            f"longest row {int(deg.max())} (senders "
            f"{int(np.diff(b.rowptr_rev).max())}), "
            f"{int((deg == 0).sum())} rows of degree 0")
    return {"N": N, "subs": subs, "eb": eb, "edges": edges,
            "x": g["x"][perm], "y": g["y"][perm]}


def ls_model(torch, dev, N, eb, sell=None):
    from dig_tpu_torch.lsgraph import ScalableGNN
    return ScalableGNN("gcn", N, 16, LS_HIDDEN, LS_OUT, LS_LAYERS,
                       segment_eb=eb, segment_br=LS_BR, sell=sell,
                       generator=torch.Generator().manual_seed(0), device=dev)


def ls_loss(torch, model, hist, x, y, sub):
    """bench_lsgraph's loss: cross-entropy over the real in-batch rows;
    returns it and the new histories."""
    out, new_h = model(hist, x, sub)
    t, B = sub.tensors(x.device), sub.batch_size
    ce = torch.nn.functional.cross_entropy(out[:B], y[t.n_id[:B]],
                                           reduction="none")
    m = t.node_mask[:B]
    return torch.where(m, ce, 0.0).sum() / m.sum().clamp(min=1), new_h


def ls_train_step(torch, model, x, y):
    """One subgraph step (loss, backward, Adam) with the histories threaded
    through the calls; returns the step and its state."""
    opt = torch.optim.Adam(model.parameters(), lr=LS_LR)
    state = {"hist": model.histories}

    def step(sub):
        opt.zero_grad(set_to_none=True)
        loss, state["hist"] = ls_loss(torch, model, state["hist"], x, y, sub)
        loss.backward()
        opt.step()
        return loss.detach()
    return step, state


def ls_first_step(torch, ls, dev):
    """Loss, gradients and pushed histories of one step on the first
    subgraph, on the card (the kernel in both directions) and on the CPU
    (sell=False: every op its plain version), the same seeded weights and
    non-zero histories."""
    res = []
    for d, sell in ((dev, None), (torch.device("cpu"), False)):
        m = ls_model(torch, d, ls["N"], ls["eb"], sell)
        x, y = torch.tensor(ls["x"]).to(d), torch.tensor(ls["y"]).to(d)
        gen = torch.Generator().manual_seed(3)
        hist = [type(h)(torch.rand(h.emb.shape, generator=gen).to(d))
                for h in m.histories]
        t = time.perf_counter()
        loss, new_h = ls_loss(torch, m, hist, x, y, ls["subs"][0])
        loss.backward()
        res.append((float(loss.detach()),
                    [p.grad.detach().cpu() for p in m.parameters()],
                    [h.emb.cpu() for h in new_h],
                    [n for n, _ in m.named_parameters()],
                    time.perf_counter() - t))
        del m
    (lk, gk, hk, names, _), (lp, gp, hp, _, cpu_s) = res
    loss_err = abs(lk - lp) / abs(lp)
    per = sorted(((rel_norm(torch, [a], [b]), n)
                  for a, b, n in zip(gk, gp, names)), reverse=True)
    hist_err = max(rel_norm(torch, [a], [b]) for a, b in zip(hk, hp))
    log(f"  first step, card against CPU: loss {lk:.7f} / {lp:.7f} (rel "
        f"{loss_err:.3e}, held to {LS_STEP_TOL[0]}); gradients worst "
        + ", ".join(f"{n} {e:.3e}" for e, n in per[:2])
        + f"; pushed histories {hist_err:.3e} (each held to "
        f"{LS_STEP_TOL[1]}); the CPU step took {cpu_s:.1f} s")
    if not math.isfinite(lk) or loss_err >= LS_STEP_TOL[0]:
        fail(f"path 9: first-step loss card {lk} vs CPU {lp}")
    if not per[0][0] < LS_STEP_TOL[1] or not hist_err < LS_STEP_TOL[1]:
        fail(f"path 9: first step differs from the CPU's: {per[:2]}, "
             f"histories {hist_err}")
    return {"loss_rel_err": loss_err, "worst_param": per[0],
            "hist_rel_err": hist_err}


def ls_epochs(torch, sc, step, subs, edges):
    """One warm epoch, then LS_EPOCHS timed ones (host clock, synchronised);
    the median epoch's ms, edges/s over the real edges, the segment-sum
    launches an epoch (the same every epoch) and the losses."""
    for b in subs:
        step(b)
    torch.cuda.synchronize()
    times, launches, losses = [], [], []
    for _ in range(LS_EPOCHS):
        before = sc.launches
        t = time.perf_counter()
        total = torch.stack([step(b) for b in subs]).sum()
        torch.cuda.synchronize()
        losses.append(float(total))
        times.append(time.perf_counter() - t)
        launches.append(sc.launches - before)
    dt = sorted(times)[len(times) // 2]
    return {"epoch_ms": dt * 1e3, "epoch_ms_all": [t * 1e3 for t in times],
            "edges_per_s": sum(edges) / dt, "launches": launches,
            "losses": losses}


def phase_ls_main_path(torch, cf, ts, sc, dev, g):
    """Path 9: the first step against the CPU's, then the epochs through
    the kernel (twice LS_LAYERS launches a subgraph step: each layer's
    forward by receiver and adjoint by sender) and the same epochs with
    SELL forced (no launch)."""
    ls = ls_setup(g)
    first = ls_first_step(torch, ls, dev)
    torch.cuda.empty_cache()
    model = ls_model(torch, dev, ls["N"], ls["eb"])
    x, y = torch.tensor(ls["x"]).to(dev), torch.tensor(ls["y"]).to(dev)
    step, _ = ls_train_step(torch, model, x, y)
    reset_all(cf, ts, sc)
    torch.cuda.reset_peak_memory_stats()
    res = ls_epochs(torch, sc, step, ls["subs"], ls["edges"])
    others_idle(cf, ts, "path 9")
    want = 2 * LS_LAYERS * len(ls["subs"])
    if any(n != want for n in res["launches"]):
        fail(f"path 9: segment-sum launches an epoch {res['launches']}, "
             f"expected {want}")
    if not all(math.isfinite(v) for v in res["losses"]):
        fail(f"path 9: non-finite loss {res['losses']}")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["kernel_launches"] = sum(res["launches"])
    log(f"  kernel route: epoch {res['epoch_ms']:.3f} ms (median of "
        f"{LS_EPOCHS}: {[round(v, 3) for v in res['epoch_ms_all']]}), "
        f"{res['epoch_ms'] / len(ls['subs']):.3f} ms a subgraph step, "
        f"{res['edges_per_s']:.6g} edges/s over {sum(ls['edges'])} real "
        f"edges; segment-sum launches an epoch {res['launches']}; epoch "
        f"losses {[round(v, 5) for v in res['losses']]}; peak "
        f"{res['peak_gib']:.2f} GiB")
    model.sell = True
    before = sc.launches
    res["sell"] = ls_epochs(torch, sc, step, ls["subs"], ls["edges"])
    model.sell = None
    if sc.launches != before:
        fail(f"path 9: the SELL epochs launched {sc.launches - before} "
             f"segment sums")
    r = res["sell"]
    log(f"  SELL forced: epoch {r['epoch_ms']:.3f} ms (median of "
        f"{LS_EPOCHS}: {[round(v, 3) for v in r['epoch_ms_all']]}), "
        f"{r['edges_per_s']:.6g} edges/s")
    res.update(first_step=first, ls=ls)
    return res


def phase_ls_seg(torch, sc, dev, ls):
    """The segment sum at every call shape of a path-9 epoch: each
    subgraph's forward (receiver ids, rowptr) and adjoint (sender ids in
    rev_perm order, rowptr_rev) at F = LS_HIDDEN (layers 1-2) and LS_OUT
    (layer 3), seeded rows: the kernel against its plain version
    (SEG_TOL), then timed as phase 15's (seg_time_row). Returns the rows
    and the largest absolute error."""
    gen = torch.Generator(device="cpu").manual_seed(9)
    rows, err = [], 0.0
    for i, b in enumerate(ls["subs"]):
        t = b.tensors(dev)
        for way, seg, rp in (("fwd", t.recv_ids, t.rowptr),
                             ("adj", t.send_ids_sorted, t.rowptr_rev)):
            for F in (LS_HIDDEN, LS_OUT):
                data = torch.randn(len(b.senders), F, generator=gen).to(dev)
                N = len(b.n_id)
                got = sc.segment_sum_sorted_csr(data, seg, rp, N, LS_BR,
                                                ls["eb"])
                want = sc.segment_sum_sorted_csr_reference(data, seg, rp, N)
                e = rel_err(got, want)
                err = max(err, float((got - want).abs().max()))
                if e >= SEG_TOL:
                    fail(f"path 9 sum {i} {way} F={F}: rel err {e}")
                c = {"name": f"9_{way}_sub{i}", "seg": seg, "rowptr": rp,
                     "N": N, "data": data, "eb": ls["eb"]}
                r = seg_time_row(torch, sc, c)
                r.update(path="9", way=way, sub=i, rel_err=e,
                         per_step=LS_LAYERS - 1 if F == LS_HIDDEN else 1)
                seg_log_row(r)
                rows.append(r)
    return rows, err


def phase_ls_small(torch, sc, dev):
    """examples/lsgraph/run_graphfm.py's size (2,000 nodes, 16 parts):
    mini_inference of ScalableGCN(64, 2 layers, momentum) on the card
    (the kernel, segment_eb from the evaluation subgraphs) against the
    CPU (its default route, SELL), and one GraphFM-IB step (sizes [3, 3],
    batch 64, hidden 64) on the card against the CPU: loss, gradients and
    histories."""
    from dig_tpu_torch.lsgraph import (EvalSubgraphLoader, GraphFMIB,
                                       NeighborSampledLoader, ScalableGCN,
                                       metis_permute, synthetic_large_graph)
    from dig_tpu_torch.ops.segment_csr import csr_window
    g = synthetic_large_graph(LS_SMALL_N, seed=0)
    s, r, N = g["senders"], g["receivers"], LS_SMALL_N
    perm, ptr, _ = metis_permute(s, r, N, 16)
    ev = EvalSubgraphLoader(s, r, N, ptr, perm)
    eb = csr_window([rp for b in ev for rp in (b.rowptr, b.rowptr_rev)],
                    LS_BR)
    outs = []
    for d in (dev, torch.device("cpu")):
        m = ScalableGCN(N, 16, 64, 4, 2, use_momentum=True, segment_eb=eb,
                        generator=torch.Generator().manual_seed(0), device=d)
        before = sc.launches
        outs.append((m.mini_inference(torch.tensor(g["x"][perm]).to(d), ev),
                     sc.launches - before))
    e_inf = rel_err(outs[0][0].cpu(), outs[1][0])
    log(f"  mini_inference (2,000 nodes, 16 parts): card against CPU rel "
        f"err {e_inf:.2e} (held to {SEG_TOL}); {outs[0][1]} segment-sum "
        f"launches")
    if e_inf >= SEG_TOL or outs[0][1] != 2 * 2 * len(ev):
        fail(f"path 9 mini_inference: rel err {e_inf}, {outs[0][1]} launches")
    ld = NeighborSampledLoader(s, r, N, g["train_mask"], sizes=[3, 3],
                               batch_size=64, seed=0)
    batch = next(iter(ld))
    res = []
    for d in (dev, torch.device("cpu")):
        m = GraphFMIB(N, 16, 64, 4, 2, alpha=0.1,
                      generator=torch.Generator().manual_seed(1),
                      device=d).bind(ld)
        gen = torch.Generator().manual_seed(2)
        hists = tuple(torch.rand(h.shape, generator=gen).to(d)
                      for h in m.histories)
        out, new_h = m(hists, torch.tensor(g["x"]).to(d), batch)
        y = torch.tensor(g["y"][batch.n_id[:64]]).to(d)
        loss = torch.nn.functional.nll_loss(out, y)
        loss.backward()
        res.append((float(loss.detach()),
                    [p.grad.cpu() for p in m.parameters()],
                    [h.cpu() for h in new_h]))
    (lk, gk, hk), (lp, gp, hp) = res
    loss_err = abs(lk - lp) / abs(lp)
    g_err = max(rel_norm(torch, [a], [b]) for a, b in zip(gk, gp))
    h_err = max(rel_norm(torch, [a], [b]) for a, b in zip(hk, hp))
    log(f"  GraphFM-IB step (sizes [3, 3], batch 64, hidden 64): card "
        f"against CPU loss {lk:.7f} / {lp:.7f} (rel {loss_err:.2e}), "
        f"gradients {g_err:.2e}, histories {h_err:.2e} (held to "
        f"{LS_STEP_TOL})")
    if (loss_err >= LS_STEP_TOL[0] or g_err >= LS_STEP_TOL[1]
            or h_err >= LS_STEP_TOL[1]):
        fail("path 9: the GraphFM-IB step differs from the CPU's")
    return {"mini_inference_rel_err": e_inf, "fm_ib": (loss_err, g_err,
                                                       h_err)}


# ---------------------------------------------------------------------------
# Paths 10, 10b and 11: ssl (GraphCL, InfoGraph, MVGRL, GRACE, pGRACE, the
# finetune step) and auggraph (SMixup, the GraphAug runners)
# ---------------------------------------------------------------------------

def ssl_data(n, seed=0):
    from dig_tpu_torch.datasets import synthetic_graph_dataset
    return synthetic_graph_dataset(n, seed=seed)


def ssl_batch_shape(torch, g):
    """The batch's pads, real nodes and edges, and largest in-degree."""
    rcv = g.receivers.long()[g.edge_mask]
    deg = torch.bincount(rcv, minlength=g.num_nodes)
    return {"N": g.num_nodes, "E": g.num_edges,
            "nodes": int(g.node_mask.sum()), "edges": int(g.edge_mask.sum()),
            "max_in_degree": int(deg.max())}


def contrastive_build(torch, m, make_encoders, g, noise):
    """``first_step_vs_cpu``'s build for a Contrastive method: the encoders of
    ``make_encoders(d)`` (one per view), the heads from the engine's seed,
    the batch and the host-drawn noise."""
    def build(d):
        encs = make_encoders(d)
        heads = m.make_heads(torch.Generator().manual_seed(m.seed), d)
        loss = m.loss_of(encs, heads, g.to(d), noise)
        return loss, encs + [h for h in heads.values() if h is not None]
    return build


def phase_ssl_main_path(torch, cf, ts, sc, dev):
    """Path 10: bench.py bench_ssl (:611-641) on the card. The first step
    against the CPU's (the same weights, batch and host-drawn view noise)
    and repeated; then ``GraphCL.train`` for 1 + SSL_EPOCHS epochs with
    per_epoch_out: graphs/s of each warm epoch (host clock; each epoch
    ends reading its loss), the segment-sum launches a step, the peak
    memory; ``_embed_dataset`` on the card against the CPU's."""
    from dig_tpu_torch.datasets import GraphClsLoader
    from dig_tpu_torch.ssl import Encoder, GraphCL
    from dig_tpu_torch.ssl.evaluation import _embed_dataset
    data = ssl_data(SSL_N)
    g0 = next(iter(GraphClsLoader(data, SSL_BS, shuffle=True)))
    shapes = [ssl_batch_shape(torch, b)
              for b in GraphClsLoader(data, SSL_BS, shuffle=True)]
    log(f"  batches of {SSL_BS}: {shapes[0]['N']} node rows, "
        f"{shapes[0]['E']} edge slots; real nodes "
        f"{min(s['nodes'] for s in shapes)}-{max(s['nodes'] for s in shapes)}"
        f", real edges {min(s['edges'] for s in shapes)}-"
        f"{max(s['edges'] for s in shapes)}, in-degree at most "
        f"{max(s['max_in_degree'] for s in shapes)}")
    m = GraphCL(**SSL_GCL)
    noise = m.draw(torch.Generator().manual_seed(1), g0)
    make = lambda d: [Encoder(**SSL_ENC, generator=torch.Generator()
                              .manual_seed(0), device=d)] * 2
    first = first_step_vs_cpu(torch, "path 10 GraphCL",
                              contrastive_build(torch, m, make, g0, noise),
                              dev, SSL_STEP_TOL, repeat=True)
    torch.cuda.empty_cache()

    enc = make(dev)[0]
    loader = GraphClsLoader(data, SSL_BS, shuffle=True)
    steps = len(loader)
    reset_all(cf, ts, sc)
    torch.cuda.reset_peak_memory_stats()
    it = m.train(enc, loader, lr=SSL_LR, epochs=1 + SSL_EPOCHS,
                 per_epoch_out=True, device=dev)
    with SegmentCalls(sc) as calls:
        t = time.perf_counter()
        warm = next(it)
        warm_s = time.perf_counter() - t
        times, launches, losses = [], [], [warm["loss"]]
        for _ in range(SSL_EPOCHS):
            before = sc.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = next(it)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches.append(sc.launches - before)
            losses.append(res["loss"])
    others_idle(cf, ts, "path 10")
    peak = torch.cuda.max_memory_allocated() / 2**30
    graphs = (SSL_N // SSL_BS) * SSL_BS
    dt = sorted(times)[len(times) // 2]
    per_step = [n / steps for n in launches]
    log(f"  GraphCL.train: warm epoch {warm_s:.3f} s; {SSL_EPOCHS} timed "
        f"epochs {[round(x * 1e3, 3) for x in times]} ms, "
        f"{[round(graphs / x, 2) for x in times]} graphs/s: "
        f"{graphs / dt:.6g} graphs/s (median epoch, {graphs} graphs); "
        f"epoch losses {[round(x, 5) for x in losses]}; segment-sum "
        f"launches a step {per_step}; peak {peak:.3f} GiB")
    if not all(math.isfinite(x) for x in losses):
        fail(f"path 10: non-finite loss {losses}")
    if len(set(launches)) != 1 or launches[0] % steps or launches[0] == 0:
        fail(f"path 10: segment-sum launches an epoch {launches}")
    eval_loader = GraphClsLoader(data, SSL_BS)
    z = _embed_dataset(enc, res["encoder_params"][0], eval_loader, dev)[0]
    enc_cpu = Encoder(**SSL_ENC, device="cpu")
    enc_cpu.load_state_dict({k: v.cpu()
                             for k, v in res["encoder_params"][0].items()})
    zc = _embed_dataset(enc_cpu, None, eval_loader, "cpu")[0]
    e_emb = rel_err(torch.from_numpy(z), torch.from_numpy(zc))
    log(f"  _embed_dataset ({z.shape[0]} graphs x {z.shape[1]}): card "
        f"against CPU rel err {e_emb:.3e} (held to {SSL_EMBED_TOL})")
    if e_emb >= SSL_EMBED_TOL or z.shape != (SSL_N, enc.z_dim):
        fail(f"path 10: _embed_dataset differs from the CPU's: {e_emb}")
    return {"first_step": first, "graphs_per_s": graphs / dt,
            "epoch_ms_all": [x * 1e3 for x in times], "losses": losses,
            "per_step": per_step[0], "launches": sum(launches),
            "steps": steps * SSL_EPOCHS, "peak_gib": peak, "calls": calls,
            "embed_rel_err": e_emb}


def phase_ssl_seg(torch, sc, res, dev):
    """The segment sum at path 10's call shapes, on the first batch's
    tables (its EdgePlan by receiver and by sender, its readout ids) and
    seeded rows: the kernel against its plain version (SEG_TOL), then
    timed as phase 15's, each with its calls a step. The calls a step by
    shape come from the timed epochs: a GraphCL step sums, per view, the
    neighbours of its three GIN layers by receiver (F = 8, then 128), the
    adjoints of layers 2 and 3 by sender (the features of layer 1 carry no
    gradient) and three readouts. Returns the rows and the largest
    absolute error."""
    from dig_tpu_torch.datasets import GraphClsLoader
    from dig_tpu_torch.ssl.encoders import edge_plan
    g = next(iter(GraphClsLoader(ssl_data(SSL_N), SSL_BS,
                                 shuffle=True))).to(dev)
    plan = edge_plan(g)
    E, N, G = g.num_edges, g.num_nodes, g.num_graphs
    by = res["calls"].per_step(res["steps"] + res["steps"] // SSL_EPOCHS)
    H = SSL_ENC["hidden_dim"]
    want = {(E, 8, N, "float32", True): 2, (E, H, N, "float32", True): 8,
            (N, H, G, "float32", True): 6}
    if {k: round(v, 6) for k, v in by.items()} != want:
        fail(f"path 10: segment sums a step by shape {by}, expected {want}")
    ids = torch.where(g.node_mask, g.node_graph.long(), -1)
    rp_g = torch.searchsorted(torch.cummax(ids, 0).values,
                              torch.arange(G + 1, device=dev), out_int32=True)
    cases = (("10_fwd_F8", plan.recv_ids, plan.rowptr, N, 8, 2),
             ("10_fwd_F128", plan.recv_ids, plan.rowptr, N, H, 4),
             ("10_adj_F128", plan.send_ids_sorted, plan.rowptr_rev, N, H, 4),
             ("10_readout_F128", ids.to(torch.int32), rp_g, G, H, 6))
    gen = torch.Generator(device="cpu").manual_seed(10)
    rows, err = [], 0.0
    for name, seg, rp, n_rows, F, per_step in cases:
        data = torch.randn(seg.shape[0], F, generator=gen).to(dev)
        eb = sc.full_window(seg.shape[0])
        got = sc.segment_sum_sorted_csr(data, seg, rp, n_rows, 32, eb)
        ref = sc.segment_sum_sorted_csr_reference(data, seg, rp, n_rows)
        e = rel_err(got, ref)
        err = max(err, float((got - ref).abs().max()))
        if e >= SEG_TOL:
            fail(f"path 10 sum {name}: rel err {e}")
        r = seg_time_row(torch, sc, {"name": name, "seg": seg, "rowptr": rp,
                                     "N": n_rows, "data": data, "eb": eb})
        r.update(path="10", per_step=per_step, rel_err=e)
        seg_log_row(r)
        rows.append(r)
    return rows, err


def phase_ssl_small(torch, sc, dev):
    """Path 10b: one step each on the card against the CPU, at the JAX
    tests' widths (tests/test_ssl.py): InfoGraph (JSE local-global, GIN),
    MVGRL (a GCN and DenseDiffusionEncoder over the PPR diffusion), GRACE
    and pGRACE (node level, one full batch), and GraphSemisupervised's
    finetune step (ResGCN, a linear head, on a split made with numpy);
    then GraphSemisupervised._finetune's loop on the card for two epochs
    over that split."""
    from dig_tpu_torch.datasets import GraphClsLoader
    from dig_tpu_torch.ssl import (GRACE, MVGRL, Encoder, GraphSemisupervised,
                                   InfoGraph, pGRACE)
    from dig_tpu_torch.ssl.evaluation import _lecun_normal_linear, finetune_loss
    data = ssl_data(24, seed=1)
    g = next(iter(GraphClsLoader(data, 12, shuffle=True)))
    host = torch.Generator().manual_seed(2)
    enc = lambda d, **kw: Encoder(8, 16, 2, generator=torch.Generator()
                                  .manual_seed(0), device=d, **kw)
    both = dict(node_level=True, graph_level=True)
    res = {}
    m = InfoGraph(g_dim=32, n_dim=16)
    res["InfoGraph"] = first_step_vs_cpu(
        torch, "InfoGraph", contrastive_build(
            torch, m, lambda d: [enc(d, gnn="gin", **both)], g,
            m.draw(host, g)), dev, SSL_STEP_TOL)
    m = MVGRL(g_dim=32, n_dim=16)
    res["MVGRL"] = first_step_vs_cpu(torch, "MVGRL", contrastive_build(
        torch, m, lambda d: [enc(d, gnn="gcn", **both),
                             m.make_diffusion_encoder(
                                 8, 16, 2, torch.Generator().manual_seed(1),
                                 d)], g, m.draw(host, g)), dev,
        SSL_STEP_TOL)
    full = next(iter(GraphClsLoader(data, 24)))
    nodes = dict(node_level=True, graph_level=False)
    for name, m in (("GRACE", GRACE(16, 0.2, 0.2, 0.2, 0.2)),
                    ("pGRACE", pGRACE(16, "pr"))):
        res[name] = first_step_vs_cpu(torch, name, contrastive_build(
            torch, m, lambda d: [enc(d, gnn="gcn", **nodes)] * 2, full,
            m.draw(host, full)), dev, SSL_STEP_TOL)
    import numpy as np
    idx = np.random.default_rng(3).permutation(len(data))
    train_set = [data[i] for i in idx[:20]]
    ft = next(iter(GraphClsLoader(train_set, 20, shuffle=True,
                                  seed=GraphSemisupervised(data).seed,
                                  drop_last=False)))

    def finetune(d):
        e = enc(d, gnn="resgcn")
        head = _lecun_normal_linear(e.z_dim, 2, torch.Generator()
                                    .manual_seed(0)).to(d)
        return finetune_loss(e, head, ft.to(d)), [e, head]
    res["finetune"] = first_step_vs_cpu(
        torch, "GraphSemisupervised finetune (ResGCN)", finetune, dev,
        SSL_STEP_TOL)
    semi = GraphSemisupervised(data, batch_size=8, device=dev)
    semi.f_epoch = 2
    e = enc(dev, gnn="resgcn")
    acc = semi._finetune(e, {k: v.clone() for k, v in e.state_dict().items()},
                         train_set, [data[i] for i in idx[20:]], 2)
    log(f"  GraphSemisupervised._finetune, 2 epochs on the card: test "
        f"accuracy {acc:.3f}")
    if not 0.0 <= acc <= 1.0:
        fail(f"path 10b: finetune accuracy {acc}")
    res["finetune"]["accuracy"] = acc
    return res


def phase_aug_path(torch, cf, ts, sc, dev):
    """Path 11: auggraph at the JAX tests' widths (tests/test_modules_misc.py:
    hidden 16, batches of 8): the first step of SMixup and of each GraphAug
    runner on the card against the CPU's (the same seeded weights, batches
    and host-drawn noise), then SMixup.train for one epoch and evaluate,
    and RunnerRewardGen, RunnerGenerator and RunnerAugCls for one epoch
    each on the card; the segment-sum launches of those epochs."""
    from dig_tpu_torch.auggraph import (RunnerAugCls, RunnerGenerator,
                                        RunnerRewardGen, SMixup)
    from dig_tpu_torch.auggraph.graphaug import (Augmenter, RewardGMNet, _Cls,
                                                 _made, classifier_loss,
                                                 generator_loss, reward_loss)
    from dig_tpu_torch.datasets import GraphClsLoader
    data = ssl_data(AUG_N, seed=4)
    g1 = next(iter(GraphClsLoader(data, AUG_BS, shuffle=True, seed=0)))
    g2 = next(iter(GraphClsLoader(data, AUG_BS, shuffle=True, seed=99)))
    gen = lambda s: torch.Generator().manual_seed(s)
    res = {}

    def smixup(d):
        sm = SMixup(2, AUG_H)
        sm.build(8, gen(0), d)
        return sm.loss(g1.to(d), g2.to(d), 0.3), [sm.matcher, sm.cls]
    res["SMixup"] = first_step_vs_cpu(torch, "SMixup", smixup, dev,
                                      SSL_STEP_TOL)
    y = torch.tensor([1.0, 0.0] * (AUG_BS // 2))

    def reward(d):
        m = RewardGMNet(8, AUG_H, gen(0), d)
        return reward_loss(m, g1.to(d), g2.to(d), y.to(d)), [m]
    res["RewardGMNet"] = first_step_vs_cpu(torch, "RunnerRewardGen step",
                                           reward, dev, SSL_STEP_TOL)
    noise = Augmenter(8, AUG_H, 1, device="cpu").draw(gen(5), g1)

    def generator(d):
        a = Augmenter(8, AUG_H, 1, generator=gen(1), device=d)
        r = RewardGMNet(8, AUG_H, gen(0), d)
        return generator_loss(a, r, None, g1.to(d), noise), [a]
    res["Augmenter"] = first_step_vs_cpu(torch, "RunnerGenerator step",
                                         generator, dev, SSL_STEP_TOL)

    def aug_cls(d):
        a = Augmenter(8, AUG_H, 1, generator=gen(1), device=d)
        m = _made(_Cls(8, AUG_H, 2), gen(2), d)
        gd = g1.to(d)
        with torch.no_grad():
            g_aug, _ = a(gd, noise)
        return classifier_loss(m, g_aug, gd.globals["y"], gd.graph_mask), [m]
    res["AugCls"] = first_step_vs_cpu(torch, "RunnerAugCls step", aug_cls,
                                      dev, SSL_STEP_TOL)

    reset_all(cf, ts, sc)
    t = time.perf_counter()
    sm = SMixup(2, AUG_H)
    sm.train(data, AUG_BS, epochs=1, device=dev)
    acc_sm = sm.evaluate(data, AUG_BS)
    rr = RunnerRewardGen(hidden=AUG_H)
    rparams = rr.train(data, batch_size=AUG_BS, epochs=1, device=dev)
    rg = RunnerGenerator(hidden=AUG_H, max_steps=1)
    aparams = rg.train(data, rr.model, rparams, batch_size=AUG_BS, epochs=1,
                       device=dev)
    acc_cls = RunnerAugCls(2, AUG_H).train(data, rg.augmenter, aparams,
                                           batch_size=AUG_BS, epochs=1,
                                           device=dev)
    torch.cuda.synchronize()
    others_idle(cf, ts, "path 11")
    log(f"  SMixup 1 epoch + evaluate (accuracy {acc_sm:.3f}), "
        f"RunnerRewardGen, RunnerGenerator, RunnerAugCls 1 epoch each "
        f"(accuracy {acc_cls:.3f}): {time.perf_counter() - t:.2f} s, "
        f"{sc.launches} segment-sum launches")
    for p in (rparams, aparams, *sm.params.values()):
        if not all(torch.isfinite(v).all() for v in p.values()):
            fail("path 11: non-finite weights after training")
    if not (0.0 <= acc_sm <= 1.0 and 0.0 <= acc_cls <= 1.0) or \
            sc.launches == 0:
        fail(f"path 11: accuracies {acc_sm}, {acc_cls}; {sc.launches} "
             f"segment-sum launches")
    res["launches"] = sc.launches
    return res


# ---------------------------------------------------------------------------
# Path 12: ggraph (GraphDF at the published QM9 width); 12b: GraphAF,
# GraphEBM, PPO, JTVAE and JTMPN at the JAX tests' widths
# ---------------------------------------------------------------------------

def gg_loader():
    from dig_tpu_torch.ggraph import DenseMolLoader, synthetic_smiles_dataset
    ds = synthetic_smiles_dataset(max_size=GG_CONF["max_size"],
                                  repeat=GG_REPEAT)
    return ds, DenseMolLoader(ds, GG_BS, shuffle=True)


def st_logit_hooks(model, outs):
    """Forward hooks that append each ST net's logits, in call order."""
    core = model.flow_core
    return [st.lin2.register_forward_hook(
        lambda m, i, o: outs.append(o.detach().float().cpu()))
        for st in list(core.node_st) + list(core.edge_st)]


def flipped_margins(torch, card_logits, cpu_logits):
    """The first ST call whose argmaxes part on the card and the CPU: its
    index, the flipped entries and the smallest top-two logit margin among
    them on the CPU."""
    for k, (a, b) in enumerate(zip(card_logits, cpu_logits)):
        diff = a.argmax(-1) != b.argmax(-1)
        if bool(diff.any()):
            top2 = b[diff].topk(2, dim=-1).values
            return k, int(diff.sum()), float((top2[:, 0] - top2[:, 1]).min())
    return None


def phase_gg_first_step(torch, dev, batch):
    """Path 12's first step on the card and the CPU from the same seeded
    weights: z, loss, gradients, running statistics."""
    from dig_tpu_torch.ggraph.models import GraphFlowModelDF
    runs = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = GraphFlowModelDF(**GG_CONF, generator=torch.Generator()
                             .manual_seed(0)).to(d).train()
        logits = []
        hooks = st_logit_hooks(m, logits)
        x = torch.from_numpy(batch["x"]).to(d)
        adj = torch.from_numpy(batch["adj"]).to(d)
        t = time.perf_counter()
        z = m(x, adj)
        loss = m.dis_log_prob(z)
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        runs[key] = dict(
            z=[a.detach().cpu() for a in z], loss=loss.detach().cpu(),
            names=[n for n, _ in m.named_parameters()],
            grads=[p.grad.detach().cpu() for _, p in m.named_parameters()],
            stats=[m.flow_core.bn.mean.cpu(), m.flow_core.bn.var.cpu()],
            logits=logits, s=time.perf_counter() - t)
    k, c = runs["card"], runs["cpu"]
    same_z = all(torch.equal(a, b) for a, b in zip(k["z"], c["z"]))
    flip = None if same_z else flipped_margins(torch, k["logits"],
                                               c["logits"])
    loss_err = float((k["loss"] - c["loss"]).abs() / c["loss"].abs())
    per = sorted(((rel_norm(torch, [a], [b]), n) for a, b, n in
                  zip(k["grads"], c["grads"], k["names"])), reverse=True)
    stats_err = max(rel_err(a, b) for a, b in zip(k["stats"],
                                                         c["stats"]))
    n_z = sum(a.numel() // a.shape[-1] for a in k["z"])
    log(f"  first step, card against CPU: {n_z} latents a layer, the same "
        f"z on both: {same_z}"
        + ("" if flip is None else f" (ST call {flip[0]}: {flip[1]} "
           f"argmaxes flipped, smallest CPU logit margin {flip[2]:.3e})")
        + f"; loss {float(k['loss']):.8f} / {float(c['loss']):.8f} (rel "
        f"{loss_err:.3e}, held to {GG_LOSS_TOL}); {len(per)} gradients, "
        f"worst rel-norm " + ", ".join(f"{n} {e:.3e}" for e, n in per[:3])
        + f" (held to {GG_GRAD_TOL}); running statistics {stats_err:.3e} "
        f"(held to {GG_STATS_TOL}); card {k['s']:.2f} s, CPU {c['s']:.1f} s")
    if not same_z:
        fail(f"path 12: the card's latents differ from the CPU's: {flip}")
    if not loss_err < GG_LOSS_TOL or not per[0][0] < GG_GRAD_TOL or \
            not stats_err < GG_STATS_TOL:
        fail(f"path 12: first step: loss {loss_err}, gradients {per[:3]}, "
             f"running statistics {stats_err}")
    return {"loss_rel_err": loss_err, "worst_grad": per[0],
            "stats_rel_err": stats_err}


def phase_gg_train(torch, dev, loader):
    """Path 12's epochs through GraphDF.train_rand_gen on the card: one
    warm epoch (a fresh model and optimiser), then the timed epochs, whose
    weights the generation phase samples from."""
    from dig_tpu_torch.ggraph import GraphDF
    gdf = GraphDF()
    t = time.perf_counter()
    gdf.train_rand_gen(loader, lr=GG_LR, wd=0, max_epochs=1,
                       model_conf_dict=GG_CONF, verbose=False, device=dev)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    hist = gdf.train_rand_gen(loader, lr=GG_LR, wd=0, max_epochs=GG_EPOCHS,
                              model_conf_dict=GG_CONF, verbose=False,
                              device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    steps = GG_EPOCHS * len(loader)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    views = len(gdf.model.masks.node_masks)
    log(f"  a warm epoch {warm:.2f} s; then {GG_EPOCHS} epochs ({steps} "
        f"steps of {GG_BS} molecules, {GG_BS * views} masked views a step):"
        f" losses {[round(h, 5) for h in hist[:3]]} ... "
        f"{[round(h, 5) for h in hist[-3:]]}; {dt:.2f} s, "
        f"{dt / steps * 1e3:.3f} ms a step (the losses read once an epoch), "
        f"peak {peak:.3f} GiB")
    if not all(math.isfinite(h) for h in hist) or hist[-1] >= hist[0]:
        fail(f"path 12: epoch losses {hist[:3]} ... {hist[-3:]}")
    return gdf, {"step_ms": dt / steps * 1e3, "peak_gib": peak,
                 "losses": [hist[0], hist[-1]], "warm_epoch_s": warm}


class DualSteps:
    """Reverse steps run on the card and on the CPU at once, the card's
    output going on; each step whose argmaxes part is noted with the
    smallest CPU logit margin of the ST calls it made (path 12's
    diagnosis of a generation mismatch)."""

    def __init__(self, torch, card, cpu, st_margin=True):
        from dig_tpu_torch.ggraph.methods import ReverseSteps
        self.torch, self.card, self.cpu = torch, ReverseSteps(card), \
            ReverseSteps(cpu)
        self.st_margin = st_margin
        self.flips, self.n = [], 0

    def _both(self, name, *args):
        logits = []
        hooks = st_logit_hooks(self.cpu.model, logits)
        b = getattr(self.cpu, name)(*args)
        for h in hooks:
            h.remove()
        a = getattr(self.card, name)(*args)
        diff = a.argmax(1) != b.argmax(1)
        if diff.any():
            # GraphDF's outputs are one-hot: the margin is its ST nets'
            # logits'; GraphAF's are continuous: the output's own
            top2 = [self.torch.from_numpy(b[diff]).topk(2, -1).values]
            if self.st_margin:
                top2 = [t.topk(2, -1).values for t in logits]
            marg = min(float((t[:, 0] - t[:, 1]).min()) for t in top2)
            self.flips.append((name, self.n, int(diff.sum()), marg))
        self.n += 1
        return a

    def node(self, *a):
        return self._both("node", *a)

    def edge(self, *a):
        return self._both("edge", *a)


def gen_vs_cpu(torch, what, gen, cls, conf, kw, st_margin):
    """``gen`` (a trained or loaded generator on the card) and a CPU copy
    of its weights run ``run_rand_gen(**kw)``: the same canonical hashes
    in order and the same first-try flags, or a failure naming the first
    molecule that parts and the steps whose argmaxes part with their
    smallest CPU margin (the lockstep loop rerun through DualSteps).
    Returns (mols, first-try flags, seconds on the card)."""
    import numpy as np
    from dig_tpu_torch.chem import canonical_hash
    from dig_tpu_torch.ggraph.methods import lockstep_generate
    torch.cuda.synchronize()
    t = time.perf_counter()
    mols, pure = gen.run_rand_gen(**kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    cpu = cls()
    cpu.get_model("rand_gen", conf, {k: v.cpu() for k, v in
                                     gen.model.state_dict().items()},
                  device="cpu")
    t = time.perf_counter()
    mols_c, pure_c = cpu.run_rand_gen(**kw)
    cpu_s = time.perf_counter() - t
    hk = [canonical_hash(m) for m in mols]
    hc = [canonical_hash(m) for m in mols_c]
    log(f"  {what}: run_rand_gen({kw}) on the CPU {cpu_s:.2f} s; the same "
        f"canonical hashes in order: {hk == hc}, the same first-try flags: "
        f"{pure == pure_c}")
    if hk != hc or pure != pure_c:
        first = next((i for i, (a, b) in enumerate(zip(hk, hc)) if a != b),
                     None)
        dual = DualSteps(torch, gen.model, cpu.model, st_margin)
        m = gen.model
        temp = kw["temperature"]
        temp = tuple(temp) if isinstance(temp, (tuple, list)) else (temp,
                                                                    temp)
        lockstep_generate(dual.node, dual.edge, gen._latents(m, temp),
                          np.random.default_rng(kw["seed"]), kw["n_mols"],
                          m.max_size, m.edge_unroll, m.node_dim, m.bond_dim,
                          [6, 7, 8, 9])
        fail(f"{what}: generation differs from the CPU's from molecule "
             f"{first}; steps whose argmaxes part (step, index, lanes, "
             f"smallest CPU margin): {dual.flips[:5]}")
    return mols, pure, dt


def phase_gg_generate(torch, dev, gdf, data_atoms):
    """Path 12's generation from the trained weights, card and CPU."""
    import numpy as np
    from dig_tpu_torch.ggraph import GraphDF
    from dig_tpu_torch.ggraph.environment import check_chemical_validity
    gdf.run_rand_gen(**dict(GG_GEN, seed=0))          # warm, as bench.py
    mols, pure, dt = gen_vs_cpu(torch, "path 12", gdf, GraphDF, GG_CONF,
                                GG_GEN, st_margin=True)
    n = GG_GEN["n_mols"]
    valid = sum(1 for m in mols if m is not None
                and check_chemical_validity(m)) / n
    res = {"mols_per_s": n / dt, "validity": valid,
           "validity_no_resample": sum(pure) / n,
           "atoms_mean": float(np.mean([m.num_atoms for m in mols]))}
    log(f"  run_rand_gen({GG_GEN}) on the card: {dt:.3f} s, "
        f"{res['mols_per_s']:.6g} mols/s, validity {valid:.3f}, "
        f"validity_no_resample {res['validity_no_resample']:.3f}, "
        f"{res['atoms_mean']:.2f} atoms a molecule (the training "
        f"molecules {data_atoms:.2f})")
    if not valid > 0.0:
        fail("path 12: no valid molecule generated")
    return res


def phase_gg_af(torch, dev, batch):
    """GraphAF at path 12's widths: the first step on the card against the
    CPU's from the same seeded weights and dequantisation noise, then
    generation from those weights on both."""
    from dig_tpu_torch.ggraph import GraphAF
    from dig_tpu_torch.ggraph.models import GraphFlowModelAF
    gen = lambda s: torch.Generator().manual_seed(s)
    x, adj = torch.from_numpy(batch["x"]), torch.from_numpy(batch["adj"])
    noise = GraphFlowModelAF(**GG_CONF).draw(gen(3), x)

    def af(d):
        m = GraphFlowModelAF(**GG_CONF, generator=gen(0)).to(d).train()
        return m.loss(x.to(d), adj.to(d), tuple(n.to(d) for n in noise)), [m]
    res = first_step_vs_cpu(torch, "path 12, GraphAF step", af, dev,
                            GG_AF_TOL)
    g = GraphAF()
    g.get_model("rand_gen", GG_CONF, GraphFlowModelAF(
        **GG_CONF, generator=gen(0)).state_dict(), device=dev)
    g.run_rand_gen(**dict(GG_AF_GEN, seed=0))          # warm
    mols, _, dt = gen_vs_cpu(torch, "path 12, GraphAF", g, GraphAF, GG_CONF,
                             GG_AF_GEN, st_margin=False)
    res["atoms_mean"] = sum(m.num_atoms for m in mols) / len(mols)
    log(f"  GraphAF run_rand_gen({GG_AF_GEN}) on the card from its seeded "
        f"weights: {dt:.3f} s, {res['atoms_mean']:.2f} atoms a molecule")
    return res


def phase_gg_small(torch, dev):
    """Path 12b: one step each on the card against the CPU at the JAX
    tests' widths, and the generations and runs around them."""
    import numpy as np
    from dig_tpu_torch.chem import canonical_hash, mol_from_smiles
    from dig_tpu_torch.ggraph import (DenseMolLoader, GraphAF, GraphEBM,
                                      synthetic_smiles_dataset)
    from dig_tpu_torch.ggraph import jtmpn, jtvae, rl
    from dig_tpu_torch.ggraph.models import (EnergyFunc, GraphFlowModelAF,
                                             GraphFlowModelDF, langevin_sample)
    gen = lambda s: torch.Generator().manual_seed(s)
    b = next(iter(DenseMolLoader(synthetic_smiles_dataset(repeat=2), 16,
                                 shuffle=True)))
    x, adj = torch.from_numpy(b["x"]), torch.from_numpy(b["adj"])
    res = {}

    af_noise = GraphFlowModelAF(**GG_TINY).draw(gen(3), x)

    def af(d):
        m = GraphFlowModelAF(**GG_TINY, generator=gen(0)).to(d).train()
        return m.loss(x.to(d), adj.to(d), tuple(n.to(d) for n in af_noise)), [m]
    res["GraphAF"] = first_step_vs_cpu(torch, "GraphAF step", af, dev,
                                       GG_SMALL_TOL)
    state = GraphFlowModelAF(**GG_TINY, generator=gen(0)).state_dict()
    hashes = []
    for d in (dev, "cpu"):
        g = GraphAF()
        g.get_model("rand_gen", GG_TINY, state, device=d)
        mols, pure = g.run_rand_gen(n_mols=8, temperature=0.75, seed=2)
        hashes.append(([canonical_hash(m) for m in mols], pure))
    log(f"  GraphAF run_rand_gen(8) card against CPU: the same hashes and "
        f"first-try flags: {hashes[0] == hashes[1]}")
    if hashes[0] != hashes[1]:
        fail("path 12b: GraphAF generation differs from the CPU's")

    ebm_noise = GraphEBM.draw(gen(4), x.shape, adj.shape, 30)

    def ebm(d):
        e = GraphEBM(4, hidden=24, depth=1)
        e.model = EnergyFunc(4, hidden=24, depth=1, generator=gen(0)).to(d)
        u_x, u_adj, ld = ebm_noise
        noise = (u_x.to(d), u_adj.to(d), type(ld)(*(t.to(d) for t in ld)))
        return e.loss_of(x.to(d), adj.to(d), noise, c=0.2), [e.model]
    res["GraphEBM"] = first_step_vs_cpu(torch, "GraphEBM step (30 Langevin "
                                        "steps)", ebm, dev, GG_SMALL_TOL)
    # Langevin dynamics at step size 30 amplify rounding: a step moves x by
    # 30 x a gradient that is a sum with cancellation, so one float32 step
    # from the same state parts by about 5e-5 and a free run of 30 steps
    # by about 2e-3 (printed). The step is held in float64 on both, where
    # only the function can part them, and in float32 its error printed.
    ld = ebm_noise[2]
    LN = type(ld)
    errs = {}
    for dt in (torch.float64, torch.float32):
        ek, ec = (EnergyFunc(4, hidden=24, depth=1, generator=gen(0))
                  .to(d, dt) for d in (dev, torch.device("cpu")))
        state, worst = (ld.x0.to(dt), ld.adj0.to(dt)), 0.0
        for k in range(len(ld.x_steps)):
            one = LN(*state, ld.x_steps[k:k + 1].to(dt),
                     ld.adj_steps[k:k + 1].to(dt))
            want = langevin_sample(ec, one)
            got = langevin_sample(ek, LN(*(t.to(dev) for t in one)))
            worst = max([worst] + [rel_err(a.cpu(), b)
                                   for a, b in zip(got, want)])
            state = want
        errs[dt] = worst
    free = [[t.cpu() for t in langevin_sample(e, LN(*(t.to(d) for t in ld)))]
            for e, d in ((ek, dev), (ec, torch.device("cpu")))]
    drift = max(rel_err(a, b) for a, b in zip(*free))
    log(f"  Langevin, 30 steps, each from the CPU's state, card against CPU:"
        f" float64 {errs[torch.float64]:.3e} at worst (held to "
        f"{GG_LANGEVIN_TOL}), float32 {errs[torch.float32]:.3e}; the float32"
        f" free runs part by {drift:.3e} after 30 steps")
    if not errs[torch.float64] < GG_LANGEVIN_TOL:
        fail(f"path 12b: a Langevin step in float64 {errs}")

    batches = []

    def ppo(d):
        m = GraphFlowModelDF(**GG_TINY, generator=gen(0)).to(d)
        tuner = rl.PPOFineTuner(m, rl.RLConfig(batch_size=4,
                                               temperature=(0.8, 0.8)),
                                lr=1e-3)
        batch = tuner.collect(0, np.random.default_rng(4))[0]
        batches.append((tuner, batch))
        t = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        with torch.no_grad():
            old = rl.rl_lls(tuner.old_model, t)
        return rl.ppo_loss(m, t, *old, 0.2), [m]
    res["PPO"] = first_step_vs_cpu(torch, "PPOFineTuner step (GraphDF)", ppo,
                                   dev, GG_SMALL_TOL)
    same = all(np.array_equal(batches[0][1][k], batches[1][1][k])
               for k in batches[1][1])
    tuner, batch = batches[0]
    loss = tuner.update(batch)
    log(f"  PPO rollouts' collated batch, card against CPU, bit for bit: "
        f"{same} ({len(batch['nx'])} node and {len(batch['ex'])} edge "
        f"records); the card's update: loss "
        f"{loss:.6f}")
    if not same or not math.isfinite(loss):
        fail(f"path 12b: PPO batches the same {same}, loss {loss}")

    mols = [mol_from_smiles(s) for s in GG_SMILES]
    vocab = jtvae.Vocab.build(mols)
    tb = jtvae.batch_trees([jtvae.tree_decomp(m) for m in mols[:8]], vocab)
    jt_noise = jtvae.JTVAEModel(len(vocab), 24, 12).draw(gen(5), 8)

    def jt(d):
        m = jtvae.JTVAEModel(len(vocab), 24, 12, generator=gen(0)).to(d)
        return m({k: v.to(d) for k, v in tb.items()},
                 tuple(n.to(d) for n in jt_noise))[0], [m]
    res["JTVAE"] = first_step_vs_cpu(torch, "JTVAE step", jt, dev,
                                     GG_SMALL_TOL)
    fixtures = jtmpn.build_assembly_fixtures(mols)
    f = max(fixtures, key=lambda f: len(f["cands"]))
    feats = jtmpn.featurize(f["cands"])

    def scorer(d):
        m = jtmpn.JTMPNScorer(generator=gen(0)).to(d)
        return jtmpn.scorer_loss(m, *(t.to(d) for t in feats),
                                 f["label"]), [m]
    # the assembly loss is a softmax over the candidates: the output bias
    # gets a gradient of rounding noise (the candidates' probabilities
    # summed less one: 6e-8 on the CPU, 0 on the card, above 1e-6 of the
    # largest gradient entry)
    res["JTMPN"] = first_step_vs_cpu(torch, "JTMPN assembly-scorer step",
                                     scorer, dev, GG_SMALL_TOL,
                                     noise_floor=1e-4)
    t = time.perf_counter()
    sc_ = jtmpn.train_assembler(fixtures, epochs=1, device=dev)
    acc = jtmpn.assembly_accuracy(sc_, fixtures)
    log(f"  train_assembler on the card, 1 epoch over {len(fixtures)} "
        f"junctions: {time.perf_counter() - t:.2f} s, assembly accuracy "
        f"{acc:.3f} (greedy {jtmpn.greedy_accuracy(fixtures):.3f})")
    if not all(torch.isfinite(p).all() for p in sc_.parameters()):
        fail("path 12b: non-finite assembler weights")
    return res


def xg_loss(torch, model, g):
    """train_gnn's loss: cross-entropy over the real graphs."""
    from torch.nn import functional as F
    y = g.globals["y"].long().reshape(-1)
    ls = F.cross_entropy(model(g), y, reduction="none")
    return torch.sum(torch.where(g.graph_mask, ls, 0.0)) / torch.clamp(
        torch.sum(g.graph_mask), min=1)


def xg_first_step(torch, dev, name, kw, g0, what):
    """A zoo model's first train step from seed 0 on ``g0``, card against
    CPU, repeated on the card."""
    from dig_tpu_torch.xgraph.model_manager import load_model

    def build(d):
        m = load_model(name, **kw).init(g0.to(d), 0)
        return xg_loss(torch, m, g0.to(d)), [m]
    return first_step_vs_cpu(torch, what, build, dev, XG_STEP_TOL,
                             repeat=True)


def xg_cpu_model(torch, params, g):
    """Path 13's GCN on the CPU with the weights ``params``."""
    from dig_tpu_torch.xgraph.model_manager import load_model
    m = load_model("GCN_2l", **XG_MODEL).init(g.to("cpu"), 0)
    m.load_state_dict({k: v.cpu() for k, v in params.items()})
    return m


def xg_train_steps(torch, sc, params, data, dev):
    """ms a step and segment-sum launches a step of train_gnn's step
    (constant lr, from the trained weights), 1 warm + XG_TIMED_STEPS
    timed, on the shuffled batches moved to the card first."""
    from dig_tpu_torch.datasets import GraphClsLoader
    from dig_tpu_torch.xgraph.model_manager import load_model
    loader = GraphClsLoader(data, XG_TRAIN["batch_size"], shuffle=True)
    batches = []
    while len(batches) < XG_TIMED_STEPS + 1:
        batches += [b.to(dev) for b in loader]
    m = load_model("GCN_2l", **XG_MODEL).init(batches[0], 0)
    m.load_state_dict(params)
    opt = torch.optim.Adam(m.parameters(), XG_TRAIN["lr"])
    per_step = []
    for k, b in enumerate(batches[:XG_TIMED_STEPS + 1]):
        if k == 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
        before = sc.launches
        opt.zero_grad(set_to_none=True)
        xg_loss(torch, m, b).backward()
        opt.step()
        per_step.append(sc.launches - before)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / XG_TIMED_STEPS * 1e3
    if set(per_step) != {XG_STEP_LAUNCHES}:
        fail(f"path 13: segment-sum launches a train step {per_step}, "
             f"expected {XG_STEP_LAUNCHES}")
    return step_ms, per_step[0]


def phase_xg_main_path(torch, cf, ts, sc, dev):
    """Path 13 (phase 47): the first steps, train_gnn, the timed steps,
    then GNNExplainer.explain_batch over graphs 1-32 (two warm runs, one
    timed) against the CPU's."""
    from dig_tpu_torch.datasets import GraphClsLoader
    import numpy as np
    from dig_tpu_torch.xgraph import GNNExplainer

    from dig_tpu_torch.xgraph.datasets import ba_2motifs
    from dig_tpu_torch.xgraph.model_manager import load_model, train_gnn
    data = ba_2motifs(**XG_DATA)
    bs = XG_TRAIN["batch_size"]
    g0 = next(iter(GraphClsLoader(data, bs, shuffle=True, seed=0)))
    log(f"  {len(data)} graphs of {data[0]['num_nodes']} nodes, "
        f"{min(len(d['senders']) for d in data)}-"
        f"{max(len(d['senders']) for d in data)} directed edges; batches "
        f"of {bs}: {g0.num_nodes} node rows, {g0.num_edges} edge slots")
    res = {"first": xg_first_step(torch, dev, "GCN_2l", XG_MODEL, g0,
                                  "path 13 GCN_2l"),
           "gin": xg_first_step(torch, dev, "GIN_3l", XG_GIN, g0,
                                "path 13 GIN_3l")}
    reset_all(cf, ts, sc)
    model = load_model("GCN_2l", **XG_MODEL)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, acc = train_gnn(model, data, **XG_TRAIN, device=dev)
    torch.cuda.synchronize()
    res.update(train_s=time.perf_counter() - t, acc=acc,
               train_launches=sc.launches)
    res["step_ms"], res["per_step"] = xg_train_steps(torch, sc, params, data,
                                                     dev)
    log(f"  train_gnn(epochs={XG_TRAIN['epochs']}): {res['train_s']:.3f} s "
        f"(restarts included), training accuracy {acc:.4f}, "
        f"{res['train_launches']} segment-sum launches; a train step "
        f"{res['step_ms']:.3f} ms (mean of {XG_TIMED_STEPS}), "
        f"{res['per_step']} launches a step")
    gs = [g.to(dev) for g in GraphClsLoader(data[:33], 1)]
    labels = [int(d["y"]) for d in data[:33]]
    ex = GNNExplainer(model, **XG_EXPLAIN)
    ex.explain_batch(gs[:1], labels[:1])
    ex.explain_batch(gs[1:], labels[1:])
    reset_all(cf, ts, sc)
    with SegmentCalls(sc) as calls:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = ex.explain_batch(gs[1:], labels[1:], seed=1)
        dt = time.perf_counter() - t          # the masks read: synchronised
    others_idle(cf, ts, "path 13")
    E, launches = XG_EXPLAIN["epochs"], sc.launches
    if launches == 0 or launches % E:
        fail(f"path 13: {launches} segment-sum launches in {E} epochs")
    mc = xg_cpu_model(torch, params, gs[0])
    t = time.perf_counter()
    ref = GNNExplainer(mc, **XG_EXPLAIN).explain_batch(
        [g.to("cpu") for g in gs[1:]], labels[1:], seed=1)
    cpu_s = time.perf_counter() - t
    e_err = f_err = 0.0
    for (ec, fc), (ep, fp) in zip(out, ref):
        fin = np.isfinite(ep)
        if not np.array_equal(np.isfinite(ec), fin):
            fail("path 13: the masks' padding edges differ from the CPU's")
        e_err = max(e_err, float(np.abs(ec[fin] - ep[fin]).max()))
        f_err = max(f_err, float(np.abs(fc - fp).max()))
    log(f"  explain_batch of 32 graphs ({E} epochs): {dt * 1e3:.3f} ms, "
        f"{32 / dt:.6g} explanations/s (host clock; CPU {cpu_s:.3f} s); "
        f"{launches // E} segment-sum launches an epoch; final mask "
        f"logits against the CPU's: edges {e_err:.3e}, features "
        f"{f_err:.3e} (held to {XG_MASK_TOL})")
    if max(e_err, f_err) >= XG_MASK_TOL:
        fail(f"path 13: masks differ from the CPU's: {e_err}, {f_err}")
    res.update(explain_s=dt, explanations_per_s=32 / dt,
               launches=launches, per_epoch=launches // E,
               calls=calls, mask_err=(e_err, f_err), model=model,
               cpu_model=mc, gs=gs, labels=labels, g0=g0)
    return res


def xg_score_err(name, a, b):
    import numpy as np
    fin = np.isfinite(b)
    if not np.array_equal(np.isfinite(a), fin):
        fail(f"path 13b {name}: the padding edges differ from the CPU's")
    d = float(np.abs(a[fin] - b[fin]).max())
    if name == "FlowX":
        return d, d < XG_PROB_TOL, XG_PROB_TOL
    rel = d / max(float(np.abs(b[fin]).max()), 1e-12)
    return rel, rel < XG_SCORE_TOL, XG_SCORE_TOL


def phase_xg_others(torch, sc, dev, res):
    """Path 13b (phase 48): each other explainer on graph 1 from path
    13's weights, card against CPU."""
    from dig_tpu_torch.xgraph import (DeepLIFT, FlowX, GNN_GI, GNN_LRP,
                                      GradCAM, PGExplainer, SubgraphX)
    g, label, mc = res["gs"][1], res["labels"][1], res["cpu_model"]
    gc = g.to("cpu")
    for cls in (GradCAM, GNN_GI, DeepLIFT, FlowX, GNN_LRP):
        before = sc.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        a = cls(res["model"]).explain(g, label)
        dt = time.perf_counter() - t
        n = sc.launches - before
        b = cls(mc).explain(gc, label)
        err, ok, tol = xg_score_err(cls.__name__, a, b)
        log(f"  {cls.__name__}: {dt * 1e3:.3f} ms on the card, {n} "
            f"segment-sum launches; scores against the CPU's {err:.3e} "
            f"(held to {tol})")
        if not ok or n == 0:
            fail(f"path 13b {cls.__name__}: err {err}, {n} launches")
    u = PGExplainer.draw(torch.Generator().manual_seed(0), g.num_edges)
    runs = []
    for m, gg in ((res["model"], g), (mc, gc)):
        pg = PGExplainer(m, epochs=XG_PG_EPOCHS)
        feats = pg._edge_feats(gg)
        pg.mlp = pg.init_mlp(feats.shape[-1], 0)
        opt = torch.optim.Adam(pg.mlp.parameters(), lr=pg.lr)
        before = sc.launches
        loss = float(pg.step(opt, gg, feats, pg.t0, u))
        runs.append((loss, dict(pg.mlp.named_parameters()), pg.explain(gg),
                     sc.launches - before, pg.lr))
    (lc, wc, sc_, n, lr), (lp, wp, sp, _, _) = runs
    l_err = abs(lc - lp) / max(abs(lp), 1e-12)
    w_err = max(float((wc[k].detach().cpu() - wp[k].detach()).abs().max())
                for k in wp) / lr
    s_err, s_ok, _ = xg_score_err("PGExplainer", sc_, sp)
    log(f"  PGExplainer step: {n} segment-sum launches; loss {lc:.7f} / "
        f"{lp:.7f} (rel {l_err:.3e}, held to {XG_PROB_TOL}); weights "
        f"{w_err:.3e} of a step (held to 0.05); edge logits {s_err:.3e} "
        f"(held to {XG_SCORE_TOL})")
    if l_err >= XG_PROB_TOL or w_err >= 0.05 or not s_ok or n == 0:
        fail(f"path 13b PGExplainer: {l_err}, {w_err}, {s_err}, {n}")
    before = sc.launches
    torch.cuda.synchronize()
    t = time.perf_counter()
    bc, rc = SubgraphX(res["model"], **XG_SUBGRAPHX).explain(g, label=label,
                                                             max_nodes=5)
    dt = time.perf_counter() - t
    n = sc.launches - before
    bp, rp = SubgraphX(mc, **XG_SUBGRAPHX).explain(gc, label=label,
                                                   max_nodes=5)
    p_err = abs(bc.P - bp.P)
    log(f"  SubgraphX: {dt:.3f} s on the card, {n} segment-sum launches; "
        f"coalition {list(bc.coalition)} (CPU {list(bp.coalition)}), "
        f"payoff {bc.P:.6f} / {bp.P:.6f}; fidelity items "
        + ", ".join(f"{k} {rc[k]:.5f}" for k in ("origin", "masked",
                                                  "maskout", "sparsity")))
    if bc.coalition != bp.coalition or p_err >= XG_PROB_TOL or n == 0:
        fail(f"path 13b SubgraphX: {bc.coalition} vs {bp.coalition}, "
             f"payoff err {p_err}, {n} launches")


def gs_batch_overflow(torch, dev, pos, ng, nm):
    """Real in-cutoff pairs of a batch of partial molecules (positions,
    graph ids, mask) and those the encoder's 2,048-edge cap drops."""
    from dig_tpu_torch.ops.radius import _pairwise_same_graph, radius_overflow
    pos, ng, nm = pos.to(dev), ng.to(dev), nm.to(dev)
    d2, valid = _pairwise_same_graph(pos, ng, nm)
    pairs = int((valid & (d2 < 25.0)).sum())
    return pairs, int(radius_overflow(pos, ng, nm, 5.0, 2048))


def phase_gs_main_path(torch, cf, ts, sc, dev):
    """Path 14 (phase 49): the radius check, the first step, training,
    generation and a generation batch against the CPU's."""
    import numpy as np
    from dig_tpu_torch.ggraph3d import (GSphereNet, QM93DGEN,
                                        RandGenEvaluator3D, SphGenModel)
    ds = QM93DGEN(num_steps_per_batch=GS_STEPS)
    checks = [gs_batch_overflow(torch, dev, g.nodes["pos"], g.node_graph,
                                g.node_mask)
              for g, _ in ds.loader(shuffle=False)]
    log(f"  {len(ds.steps)} placement steps in batches of {GS_STEPS} "
        f"({ds.n_node_pad} node rows): in-cutoff pairs a batch "
        f"{min(c[0] for c in checks)}-{max(c[0] for c in checks)} of the "
        f"2,048 edge slots, dropped {sum(c[1] for c in checks)}")
    if any(c[1] for c in checks):
        fail("path 14: radius edges dropped")
    g0, st0 = next(iter(ds.loader()))
    gs = GSphereNet(**GS_CONF)
    noise = torch.rand((GS_STEPS, GS_CONF["num_node_types"]),
                       generator=torch.Generator().manual_seed(0))

    def build(d):
        m = gs.init_model(0, d)
        st = {k: torch.as_tensor(v).to(d) for k, v in st0.items()}
        return m.loss(g0.to(d), st, noise.to(d))[0], [m]
    res = {"first": first_step_vs_cpu(torch, "path 14 G-SphereNet", build,
                                      dev, GS_STEP_TOL, repeat=True)}
    loader = ds.loader()
    steps = GS_EPOCHS * len(loader)
    reset_all(cf, ts, sc)
    torch.cuda.reset_peak_memory_stats()
    with SegmentCalls(sc) as calls:
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = gs.train(loader, lr=GS_LR, max_epochs=GS_EPOCHS,
                        verbose=False, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    others_idle(cf, ts, "path 14")
    train_launches = sc.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  GSphereNet.train: {GS_EPOCHS} epochs of {len(loader)} steps in "
        f"{dt:.3f} s: {dt / steps * 1e3:.3f} ms a step (the host's collate "
        f"and the loss read once an epoch included); losses "
        f"{[round(x, 5) for x in hist]}; {train_launches / steps:g} "
        f"segment-sum launches a step; peak {peak:.3f} GiB")
    if train_launches != GS_LAUNCHES * steps:
        fail(f"path 14: {train_launches} segment-sum launches in {steps} "
             f"steps, expected {GS_LAUNCHES} a step")
    if not all(math.isfinite(x) for x in hist):
        fail(f"path 14: non-finite loss {hist}")
    before = sc.launches
    with torch.no_grad():
        gs.model.encoder(g0.to(dev))
    enc = sc.launches - before
    if enc != 3:
        fail(f"path 14: {enc} segment-sum launches an encoder pass")
    gs.generate(GS_TYPES, **GS_GEN, seed=0)
    reset_all(cf, ts, sc)
    torch.cuda.synchronize()
    t = time.perf_counter()
    samples = gs.generate(GS_TYPES, **GS_GEN, seed=1)
    gen_s = time.perf_counter() - t       # each batch read: synchronised
    gen_launches = sc.launches
    n = GS_GEN["num_gen"]
    atoms = float(np.mean([len(s["z"]) for s in samples]))
    valid = RandGenEvaluator3D().eval_validity({"mol_dicts": samples})[
        "valid_ratio"]
    log(f"  generate({n}, max_atoms={GS_GEN['max_atoms']}): {gen_s:.3f} s, "
        f"{n / gen_s:.6g} mols/s (host clock), {atoms:.3f} atoms a "
        f"molecule, validity {valid:.2f}%; {gen_launches} segment-sum "
        f"launches ({enc} an encoder pass, one pass a step)")
    L = GS_GEN["max_atoms"]
    draws = gs.draw_batch(torch.Generator().manual_seed(1), 32,
                          len(GS_TYPES), L, L)
    zc, pc, nc = (t.cpu() for t in gs.run_batch(draws, L, L))
    cpu = GSphereNet(**GS_CONF)
    cpu.model = SphGenModel(**GS_CONF, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               gs.model.state_dict().items()})
    zp, pp, np_ = cpu.run_batch(draws, L, L)
    real = torch.arange(L)[None, :] < np_[:, None]
    same = torch.equal(nc, np_) and torch.equal(torch.where(real, zc, -1),
                                                torch.where(real, zp, -1))
    scale = float(pp[real].abs().max())
    p_err = float((pc - pp)[real].abs().max()) / scale
    seen = torch.clamp(nc, max=L - 1)         # the last step's partial graphs
    pairs, dropped = gs_batch_overflow(
        torch, dev, pc.reshape(-1, 3),
        torch.repeat_interleave(torch.arange(nc.shape[0]), L).int(),
        (torch.arange(L)[None, :] < seen[:, None]).reshape(-1))
    log(f"  a batch of 32 from the trained weights and the same draws, "
        f"card against CPU: the same types and atom counts {same} "
        f"(counts {np.bincount(np_.numpy(), minlength=L + 1)[1:].tolist()} "
        f"for 1-{L} atoms); positions {p_err:.3e} of the largest coordinate"
        f" {scale:.3f} (held to {GS_POS_TOL}); the last step's graph "
        f"{pairs} in-cutoff pairs, dropped {dropped}")
    if not same or p_err >= GS_POS_TOL or dropped:
        fail(f"path 14: generation batch differs from the CPU's "
             f"(same {same}, pos {p_err}) or dropped {dropped} edges")
    res.update(step_ms=dt / steps * 1e3, losses=hist, peak_gib=peak,
               launches=train_launches, per_step=train_launches / steps,
               steps=steps, calls=calls, mols_per_s=n / gen_s, atoms=atoms,
               validity=valid, gen_launches=gen_launches, enc_launches=enc,
               pos_err=p_err, g0=g0)
    return res


def gs_profiles(torch, dev):
    """Busy ms, idle share and launches of one path-14 train step and of
    one generation batch: scripts/profile_torch_step.py's trace of its
    gspherenet and gspherenet_gen cases, in this process, one after the
    other."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "profile_torch_step", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scripts",
            "profile_torch_step.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    out = {}
    for case in ("gspherenet", "gspherenet_gen"):
        wall_ms, busy_ms, kernels, _, _ = prof.trace(case, dev)
        log(f"  profile_torch_step.py "
            f"{prof.summary_line(case, wall_ms, busy_ms, kernels)}")
        out[case] = {"busy_ms": busy_ms / prof.TRACED,
                     "idle": 1 - busy_ms / wall_ms,
                     "launches": len(kernels) / prof.TRACED}
    return out


def phase_new_seg(torch, sc, dev, cases):
    """The segment sum at each case's tables (name, ids, row pointer, rows,
    F, calls a step) with seeded rows: the kernel against its plain
    version (SEG_TOL), then timed as phase 15's. Returns the rows and the
    largest absolute error."""
    gen = torch.Generator(device="cpu").manual_seed(13)
    rows, err = [], 0.0
    for name, seg, rp, n_rows, F, per_step in cases:
        seg, rp = seg.to(dev).to(torch.int32), rp.to(dev).to(torch.int32)
        data = torch.randn(seg.shape[0], F, generator=gen).to(dev)
        eb = sc.full_window(seg.shape[0])
        got = sc.segment_sum_sorted_csr(data, seg, rp, n_rows, 32, eb)
        ref = sc.segment_sum_sorted_csr_reference(data, seg, rp, n_rows)
        e = rel_err(got, ref)
        err = max(err, float((got - ref).abs().max()))
        if e >= SEG_TOL:
            fail(f"segment sum {name}: rel err {e}")
        r = seg_time_row(torch, sc, {"name": name, "seg": seg, "rowptr": rp,
                                     "N": n_rows, "data": data, "eb": eb})
        r.update(path=name.split("_")[0], per_step=per_step, rel_err=e)
        seg_log_row(r)
        rows.append(r)
    return rows, err


def xg_gs_seg_cases(torch, sc, dev, xg, gs):
    """Phase 50's cases: path 13's explanation epoch on the union of the
    32 graphs (the neighbour sums by receiver and the sender gathers'
    adjoints at F = 32, the mean readout, the feature mask's gather
    adjoint), its GIN step (F = 64) and path 14's train step (the edge
    sums and sender adjoints at F = 64, the type embedding's adjoint),
    each checked against the calls counted on the path."""
    from dig_tpu_torch.ops.radius import radius_graph_flat
    from dig_tpu_torch.ops.segment import gather_plan
    from dig_tpu_torch.xgraph.base import disjoint_union
    from dig_tpu_torch.xgraph.models import xplan

    def readout_tables(g):
        ids = torch.where(g.node_mask, g.node_graph.long(), -1)
        rp = torch.searchsorted(torch.cummax(ids, 0).values,
                                torch.arange(g.num_graphs + 1,
                                             device=ids.device),
                                out_int32=True)
        return ids, rp

    u = disjoint_union(xg["gs"][1:])
    p = xplan(u)
    N, E, B = u.num_nodes, u.num_edges, len(xg["gs"]) - 1
    H, Fx = XG_MODEL["dim_hidden"], u.nodes["x"].shape[1]
    want = {(E, H, N, "float32", True): 4, (N, H, B, "float32", True): 1,
            (N, Fx, B, "float32", True): 1}
    by = {k: round(v, 6) for k, v in xg["calls"].per_step(
        XG_EXPLAIN["epochs"]).items()}
    if by != want:
        fail(f"path 13: segment sums an epoch by shape {by}, expected {want}")
    node_b = gather_plan(torch.repeat_interleave(
        torch.arange(B, device=dev), N // B), B)
    ids_u, rp_u = readout_tables(u)
    g0 = xg["g0"].to(dev)
    p0 = xplan(g0)
    ids_0, rp_0 = readout_tables(g0)
    G_in = XG_GIN["dim_hidden"]
    e, e0 = p.edges, p0.edges
    cases = [("13_fwd_F32", e.recv_ids, e.rowptr, N, H, 2),
             ("13_adj_F32", p.send_plan.ids, p.send_plan.rowptr, N, H, 2),
             ("13_readout_F32", ids_u, rp_u, B, H, 1),
             ("13_featmask_F10", node_b.ids, node_b.rowptr, B, Fx, 1),
             ("13gin_fwd_F64", e0.recv_ids, e0.rowptr, g0.num_nodes, G_in,
              2),
             ("13gin_adj_F64", p0.send_plan.ids, p0.send_plan.rowptr,
              g0.num_nodes, G_in, 2),
             ("13gin_readout_F64", ids_0, rp_0, g0.num_graphs, G_in, 1)]
    g = gs["g0"].to(dev)
    snd, rcv, em = radius_graph_flat(g.nodes["pos"], g.node_graph,
                                     g.node_mask, 5.0, 2048)
    Ng, H3 = g.num_nodes, GS_CONF["hidden"]
    recv = torch.where(em, rcv.long(), -1).to(torch.int32)
    rp_r = torch.searchsorted(torch.where(em, rcv.long(), Ng),
                              torch.arange(Ng + 1, device=dev),
                              out_int32=True)
    sp = gather_plan(snd, Ng)
    tp = gather_plan(g.node_graph, g.num_graphs)
    want = {(2048, H3, Ng, "float32", True): 6,
            (Ng, H3, g.num_graphs, "float32", True): 1}
    by = {k: round(v, 6) for k, v in gs["calls"].per_step(gs["steps"])
          .items()}
    if by != want:
        fail(f"path 14: segment sums a step by shape {by}, expected {want}")
    cases += [("14_fwd_F64", recv, rp_r, Ng, H3, 3),
              ("14_adj_F64", sp.ids, sp.rowptr, Ng, H3, 3),
              ("14_temb_adj_F64", tp.ids, tp.rowptr, g.num_graphs, H3, 1)]
    return cases


# ---------------------------------------------------------------------------
# Paths 15-17: fairgraph, the parallel engines, the train utilities
# ---------------------------------------------------------------------------

def fg_data():
    """Path 15's graph (host numpy, its generator's edge loop timed), built
    once a process."""
    from dig_tpu_torch.fairgraph import synthetic_fair_graph
    if "fg" in _MEMO:
        return _MEMO["fg"]
    t = time.perf_counter()
    data = synthetic_fair_graph(FG_N, avg_deg=FG_DEG, seed=0)
    log(f"  synthetic_fair_graph({FG_N}, avg_deg={FG_DEG}): "
        f"{int(data['adj'].sum())} directed edges, {data['x'].shape[1]} "
        f"features, in {time.perf_counter() - t:.1f} s (host)")
    _MEMO["fg"] = data
    return data


def fg_model(torch, data, d):
    """A Graphair at run()'s widths on device ``d``, weights from seed 0,
    the graph moved there."""
    from dig_tpu_torch.fairgraph import Graphair
    m = Graphair(data["x"].shape[1], device=d, **FG_KW)
    m.init(0)
    m.prepare(data["adj"], data["x"], data["sens"], data["idx_sens_train"])
    return m


def fg_first_steps(torch, dev, data):
    """The first warm, adversary and main steps (in fit_whole's order) on
    the card against the CPU, from the same weights and the same uniforms
    drawn on the host: each step's loss and its gradients (CPU_STEP_TOL,
    per parameter); the edge samples' flips at 0.5 counted."""
    from dig_tpu_torch.fairgraph import Graphair
    n, f = data["x"].shape
    gen = torch.Generator().manual_seed(0)
    noise = [Graphair.draw(gen, n, f) for _ in range(3)]
    kinds = (("warm", "aug"), ("adv", "adv"), ("main", "aug enc proj"))

    def run(d):
        t = time.perf_counter()
        m = fg_model(torch, data, d)
        with torch.no_grad():
            a, _, _ = m.aug(m.adj_norm, m.x, tuple(u.to(d) for u in noise[0]),
                            adj_orig=m.adj)
            sample = (a > 0).cpu()
        out = []
        for (kind, parts), nz in zip(kinds, noise):
            loss = getattr(m, f"{kind}_step")(tuple(u.to(d) for u in nz))
            loss = loss[0] if isinstance(loss, tuple) else loss
            grads = [(f"{p}.{k}", q.grad.detach().cpu().clone())
                     for p in parts.split()
                     for k, q in getattr(m, p).named_parameters()]
            out.append((loss.detach().cpu(), grads))
        if d.type == "cuda":
            torch.cuda.synchronize()
        return out, sample, time.perf_counter() - t

    card, s_card, card_s = run(dev)
    cpu, s_cpu, cpu_s = run(torch.device("cpu"))
    flips = int((s_card != s_cpu).sum())
    res = {"flips": flips, "edges": int(s_cpu.sum())}
    for (kind, _), (lk, gk), (lp, gp) in zip(kinds, card, cpu):
        le = float((lk - lp).abs() / lp.abs().clamp_min(1e-12))
        per = sorted(((rel_norm(torch, [a], [b]), name)
                      for (name, a), (_, b) in zip(gk, gp)), reverse=True)
        log(f"  path 15 {kind} step, card against CPU: loss {float(lk):.7f} "
            f"/ {float(lp):.7f} (rel {le:.3e}, held to {CPU_STEP_TOL[0]}); "
            f"{len(gk)} gradients, worst {per[0][1]} {per[0][0]:.3e} (held "
            f"to {CPU_STEP_TOL[1]})")
        if not math.isfinite(float(lk)) or le >= CPU_STEP_TOL[0]:
            fail(f"path 15 {kind} step: loss {float(lk)} vs {float(lp)}")
        if not per[0][0] < CPU_STEP_TOL[1]:
            fail(f"path 15 {kind} step: gradients differ {per[:3]}")
        res[kind] = {"loss_rel_err": le, "worst_param": per[0]}
    log(f"  the first step's edge sample: {res['edges']} edges on the CPU, "
        f"{flips} of {s_cpu.numel()} entries flipped on the card; card "
        f"{card_s:.2f} s, CPU {cpu_s:.1f} s for the three steps")
    return res


def phase_fg_path(torch, cf, ts, sc, dev):
    """Path 15 (phase 51): the first steps against the CPU, then fit_whole
    for about FG_SECONDS and test(); ms an epoch, peak memory, accuracy,
    DP, EO; no kernel of the port's launched (dense products)."""
    data = fg_data()
    res = {"first": fg_first_steps(torch, dev, data)}
    from dig_tpu_torch.fairgraph import Graphair
    m = Graphair(data["x"].shape[1], device=dev, **FG_KW)
    args = (data["adj"], data["x"], data["sens"], data["idx_sens_train"])
    reset_all(cf, ts, sc)
    torch.cuda.synchronize()
    t = time.perf_counter()
    m.fit_whole(FG_CAL, *args, seed=0)
    torch.cuda.synchronize()
    cal = (time.perf_counter() - t) / FG_CAL
    epochs = int(max(FG_CAL, min(500, FG_SECONDS / cal)))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    m.fit_whole(epochs, *args, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    m.embed()
    embed_s = time.perf_counter() - t
    t = time.perf_counter()
    metrics = m.test(data["y"], data["sens"], data["idx_train"],
                     data["idx_test"])
    test_s = time.perf_counter() - t
    others_idle(cf, ts, "path 15")
    if sc.launches:
        fail(f"path 15: {sc.launches} segment-sum launches (none expected)")
    with torch.no_grad():
        emb = m.enc(m.adj_norm, m.x)
    log(f"  fit_whole({epochs} epochs, 10 adversary steps at epoch 0): "
        f"{dt:.3f} s, {dt / epochs * 1e3:.3f} ms an epoch (one adversary "
        f"and one main step, the uniforms drawn on the card; {FG_CAL} "
        f"epochs of calibration took {cal * 1e3:.3f} ms each); peak "
        f"{peak:.3f} GiB; test() (500 classifier epochs) {test_s:.2f} s "
        f"(an embedding alone {embed_s:.3f} s): "
        f"accuracy {metrics['accuracy']:.4f}, DP {metrics['dp']:.3f}, EO "
        f"{metrics['eo']:.3f}")
    if not (bool(torch.isfinite(emb).all()) and 0.0 <= metrics["accuracy"]
            <= 1.0 and all(math.isfinite(v) for v in metrics.values())):
        fail(f"path 15: embeddings or metrics not finite: {metrics}")
    res.update(epochs=epochs, epoch_ms=dt / epochs * 1e3, peak_gib=peak,
               metrics=metrics)
    return res


def gp_cloud(torch, dev):
    """GPSchNet's atoms: [z, pos] rows and the directed pairs within the
    cutoff (receivers, senders), found on the card."""
    import numpy as np
    rng = np.random.default_rng(0)
    side = (GPS_ATOMS / GPS_DENSITY) ** (1 / 3)
    pos = rng.uniform(0, side, (GPS_ATOMS, 3)).astype(np.float32)
    z = rng.choice([1, 6, 7, 8], GPS_ATOMS).astype(np.float32)
    p = torch.from_numpy(pos).to(dev)
    adj = torch.cdist(p, p) < GPS_KW["cutoff"]
    adj.fill_diagonal_(False)
    r, s = (t.cpu().numpy() for t in torch.nonzero(adj, as_tuple=True))
    x = np.concatenate([z[:, None], pos], axis=1)
    return x, s, r, (0.1 * z).astype(np.float32)


def gp_case(torch, name, s, r, x, y, mask, loss):
    """One GP case on one part: the host tables and slabs."""
    from dig_tpu_torch.parallel import prepare_gp_graph, slab_layout
    t = time.perf_counter()
    gp, perm, H, C = prepare_gp_graph(s, r, x.shape[0], 1)
    log(f"  {name}: {x.shape[0]} nodes, {len(s)} edges, one part "
        f"(prepare_gp_graph {time.perf_counter() - t:.1f} s, host)")
    return {"name": name, "g": gp, "H": H, "C": C, "loss": loss,
            "x": slab_layout(x, perm, 1, C), "y": slab_layout(y, perm, 1, C),
            "mask": slab_layout(mask, perm, 1, C)}


def gp_first_step(torch, dev, mesh, case, make_module):
    """The engine's first step on the card (SGD at lr 0: the gradients
    stay) against the module's forward and backward on the CPU with an
    empty halo (one rank: the halo buffer's rows are all masked)."""
    from dig_tpu_torch.parallel import make_gp_engine
    from dig_tpu_torch.parallel.gp import local_graph

    def build(d):
        mod = make_module(d)
        if d.type == "cuda":
            _, step, _ = make_gp_engine(
                mesh, mod, torch.optim.SGD(mod.parameters(), lr=0.0),
                case["H"], case["C"], loss_fn=case["loss"], axis="data")
            loss, _ = step(case["g"], case["x"], case["y"], case["mask"])
            return loss, [mod]
        gl = local_graph(case["g"], 0, case["C"], d)
        H = case["H"]
        halo = lambda h: torch.zeros((H,) + h.shape[1:], dtype=h.dtype)
        out = mod(torch.as_tensor(case["x"][0]).float(), gl, halo)
        loc, cnt = case["loss"](out, torch.as_tensor(case["y"][0]),
                                torch.as_tensor(case["mask"][0])
                                & gl.node_mask)
        return loc / cnt.clamp(min=1), [mod]
    return first_step_vs_cpu(torch, f"path 16 {case['name']}", build, dev)


def gp_timed(torch, sc, dev, mesh, case, make_module, want):
    """GP_STEPS Adam(1e-3) engine steps on the card, the last
    GP_STEPS - GP_WARMUP timed: losses, ms a step, segment-sum launches a
    step (``want``) and the calls by shape."""
    from dig_tpu_torch.parallel import make_gp_engine
    mod = make_module(dev)
    init_fn, step, _ = make_gp_engine(
        mesh, mod, torch.optim.Adam(mod.parameters(), lr=1e-3), case["H"],
        case["C"], loss_fn=case["loss"], axis="data")
    init_fn()
    per, losses = [], []
    with SegmentCalls(sc) as calls:
        for i in range(GP_STEPS):
            if i == GP_WARMUP:
                torch.cuda.synchronize()
                t = time.perf_counter()
            before = sc.launches
            losses.append(step(case["g"], case["x"], case["y"],
                               case["mask"])[0])
            per.append(sc.launches - before)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t) / (GP_STEPS - GP_WARMUP)
    losses = [float(v) for v in losses]
    log(f"  {case['name']}: {GP_STEPS} Adam steps, losses "
        f"{[round(v, 5) for v in losses]}; {dt * 1e3:.3f} ms a step (mean "
        f"of {GP_STEPS - GP_WARMUP}); segment-sum launches a step {per}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"path 16 {case['name']}: non-finite loss")
    if per != [want] * GP_STEPS:
        fail(f"path 16 {case['name']}: segment-sum launches {per}, "
             f"expected {want} a step")
    return {"step_ms": dt * 1e3, "losses": losses, "per_step": want,
            "launches": sum(per), "calls": calls, "steps": GP_STEPS}


def par_plain_checks(torch, dev):
    """TP on a (1, 1) mesh, PP with one stage, EP with every expert on the
    rank, each against its plain single-process result on the card."""
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SchNet
    from dig_tpu_torch.parallel import (ep_shard_params, init_moe_params,
                                        make_ep_moe, make_mesh,
                                        make_pp_train_step,
                                        make_tp_train_step,
                                        moe_dense_reference, pipeline_apply,
                                        pp_shard_params, tp_shard)
    from dig_tpu_torch.train import make_step_fns
    mols = synthetic_molecules(4, seed=0, max_atoms=10, with_forces=True)
    g = next(iter(MoleculeLoader(mols, 4, n_node_pad=48, device=dev)))
    build = lambda: SchNet(**PAR_DP_KW, generator=torch.Generator()
                           .manual_seed(0), device=dev)
    mesh = make_mesh((1, 1), ("data", "model"))
    tp = tp_shard(build(), mesh)
    step_tp = make_tp_train_step(tp, torch.optim.Adam(tp.parameters(), 1e-3),
                                 mesh, energy_and_force=True, p=1.0)
    plain = build()
    step_pl, _ = make_step_fns(plain, torch.optim.Adam(plain.parameters(),
                                                       1e-3),
                               energy_and_force=True, p=1.0)
    l_tp = [float(step_tp(g)["loss"]) for _ in range(2)]
    l_pl = [float(step_pl(g)["loss"]) for _ in range(2)]
    with torch.no_grad():
        full = {**dict(tp.module.named_parameters()),
                **tp.full_parameters()}
        w_err = max(rel_err(full[k], v) for k, v in
                    plain.named_parameters())
    l_err = max(abs(a - b) / abs(b) for a, b in zip(l_tp, l_pl))
    log(f"  TP (1 x 1 mesh, {len(tp.shards)} column-sharded parameters) "
        f"against make_step_fns, two energy+force steps: losses {l_tp} / "
        f"{l_pl} (rel {l_err:.3e}), weights {w_err:.3e} (held to {PAR_TOL})")
    if l_err >= PAR_TOL or w_err >= PAR_TOL:
        fail("path 16: TP step differs from the plain step")

    mesh = make_mesh((1,), ("pipe",))
    gen = torch.Generator().manual_seed(2)
    stack = {"w": 0.1 * torch.randn(8, 16, 16, generator=gen),
             "b": 0.01 * torch.randn(8, 16, generator=gen)}
    x = torch.randn(6, 5, 16, generator=gen).to(dev)
    y = torch.randn(6, 5, 16, generator=gen).to(dev)
    layer = lambda pl, h: h + torch.tanh(h @ pl["w"] + pl["b"])
    params = pp_shard_params({k: v.to(dev) for k, v in stack.items()}, mesh)
    ref = {k: v.to(dev).clone().requires_grad_() for k, v in stack.items()}

    def seq(p):
        h = x
        for l in range(8):
            h = layer({k: v[l] for k, v in p.items()}, h)
        return h
    with torch.no_grad():
        o_err = rel_err(pipeline_apply(layer, mesh)(params, x), seq(ref))
    lossf = lambda o, t: torch.mean((o - t) ** 2)
    step = make_pp_train_step(layer, torch.optim.SGD(list(params.values()),
                                                     1e-2), mesh, lossf)
    l_pp = float(step(params, x, y))
    opt = torch.optim.SGD(list(ref.values()), 1e-2)
    l_seq = lossf(seq(ref), y)
    l_seq.backward()
    opt.step()
    p_err = max(rel_err(params[k], ref[k]) for k in ref)
    log(f"  PP (1 stage, 6 microbatches, 8 layers) against the sequential "
        f"stack: outputs {o_err:.3e}, loss {l_pp:.7f} / "
        f"{float(l_seq.detach()):.7f},"
        f" weights after an SGD step {p_err:.3e} (held to {PAR_TOL})")
    l_seq = float(l_seq.detach())
    if o_err >= PAR_TOL or p_err >= PAR_TOL or abs(
            l_pp - l_seq) >= PAR_TOL * abs(l_seq):
        fail("path 16: PP differs from the sequential stack")

    mesh = make_mesh((1,), ("expert",))
    ep = init_moe_params(2, 16, 12, 24, 8, device=dev)
    xe = torch.randn(64, 12, generator=gen).to(dev)
    dense = moe_dense_reference(ep, xe)
    for cap in (64, 2):
        local = ep_shard_params(ep, mesh)
        yv, dropped = make_ep_moe(mesh, 16, cap)(local, xe)
        kept = yv.abs().sum(1) > 0
        e = rel_err(yv[kept], dense[kept])
        grads = torch.autograd.grad(torch.sum(yv ** 2), list(local.values()))
        finite = all(bool(torch.isfinite(q).all()) for q in grads)
        log(f"  EP (16 experts on the rank, 64 tokens, capacity {cap}): "
            f"{int(dropped)} dropped (rows 0: {int((~kept).sum())}), the "
            f"others against moe_dense_reference {e:.3e}; gradients finite "
            f"{finite}, the gate's largest {float(grads[-1].abs().max()):.3e}")
        if (e >= PAR_TOL or int(dropped) != int((~kept).sum()) or not finite
                or (cap == 64 and int(dropped))):
            fail(f"path 16: EP at capacity {cap}")


def phase_par_path(torch, cf, ts, sc, dev, g60k):
    """Path 16 (phase 52), in a world-size-1 NCCL group: the mesh
    self-check, a DP step, the GP engine with GPGCN2, GPPNA and GPSchNet
    (first steps against the CPU, timed steps), TP / PP / EP, and
    scripts/profile_torch_step.py's gp trace."""
    import numpy as np
    import torch.distributed as dist
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SchNet
    from dig_tpu_torch.parallel import (concat_local_shards, init_local,
                                        make_dp_train_step, make_mesh,
                                        shard_graph_batch)
    from dig_tpu_torch.parallel import gp_models as gpm
    from dig_tpu_torch.parallel.gp import node_class_loss, node_reg_loss
    from dig_tpu_torch.train import collective_selfcheck, make_step_fns
    init_local(0, 1, os.path.join(tempfile.mkdtemp(), "store"), "nccl")
    res = {}
    try:
        sizes = collective_selfcheck(make_mesh((1, 1), ("data", "graph")))
        log(f"  NCCL group of 1 ({dist.get_backend()}): "
            f"collective_selfcheck on a (1, 1) mesh: {sizes}")
        if sizes != {"data": 1, "graph": 1}:
            fail(f"path 16: collective_selfcheck {sizes}")
        mesh = make_mesh((1,), ("data",))
        mols = synthetic_molecules(2, seed=0, max_atoms=12)
        shard = next(iter(MoleculeLoader(mols, 2, n_node_pad=32,
                                         device="cpu")))

        def dp_build(d):
            m = SchNet(**PAR_DP_KW, generator=torch.Generator()
                       .manual_seed(0), device=d)
            opt = torch.optim.SGD(m.parameters(), lr=0.0)
            if d.type == "cuda":
                g = shard_graph_batch(concat_local_shards([shard]), mesh)
                return make_dp_train_step(m, opt, mesh)(g)["loss"], [m]
            return make_step_fns(m, opt)[0](shard)["loss"], [m]
        reset_all(cf, ts, sc)
        res["dp"] = first_step_vs_cpu(torch, "path 16 DP step (flat SchNet "
                                      "2 x 32) against make_step_fns",
                                      dp_build, dev)
        res["dp_launches"] = sc.launches
        L, Hd, y = GP_LAYERS, GP_HIDDEN, g60k["y"]
        big = gp_case(torch, "GPGCN2", g60k["senders"], g60k["receivers"],
                      g60k["x"], y, g60k["train_mask"], node_class_loss)
        x, s, r, yv = gp_cloud(torch, dev)
        seed = lambda: torch.Generator().manual_seed(0)
        dims = (g60k["x"].shape[1], Hd, int(y.max()) + 1, L)
        cases = [
            (big, lambda d: gpm.GPGCN2(*dims, generator=seed()).to(d),
             2 * L),
            (dict(big, name="GPPNA"),
             lambda d: gpm.GPPNA(*dims, generator=seed()).to(d), 3 * L - 1),
            (gp_case(torch, "GPSchNet", s, r, x, yv, np.ones(len(yv), bool),
                     node_reg_loss),
             lambda d: gpm.GPSchNet(**GPS_KW, generator=seed()).to(d),
             2 * GPS_KW["num_layers"])]
        res["gp"] = {}
        for case, make, want in cases:
            first = gp_first_step(torch, dev, mesh, case, make)
            reset_all(cf, ts, sc)
            timed = gp_timed(torch, sc, dev, mesh, case, make, want)
            others_idle(cf, ts, f"path 16 {case['name']}")
            timed["first"] = first
            res["gp"][case["name"]] = timed
        par_plain_checks(torch, dev)
        res["profile"] = par_profile(torch, dev)
    finally:
        dist.destroy_process_group()
    return res


def par_profile(torch, dev):
    """Busy ms, idle share and launches of one path-16 GPGCN2 step and of
    one path-15 epoch: scripts/profile_torch_step.py's gp and graphair
    traces, in this process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "profile_torch_step", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scripts",
            "profile_torch_step.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    # this process's chip_smoke, whose graphs are built already
    prof._chip_smoke = lambda: sys.modules[__name__]
    out = {}
    for case in ("gp", "graphair"):
        wall_ms, busy_ms, kernels, _, _ = prof.trace(case, dev)
        log(f"  profile_torch_step.py "
            f"{prof.summary_line(case, wall_ms, busy_ms, kernels)}")
        out[case] = {"busy_ms": busy_ms / prof.TRACED,
                     "idle": 1 - busy_ms / wall_ms,
                     "launches": len(kernels) / prof.TRACED}
    return out


def trace_idle(path):
    """Device busy ms and idle share inside the ``train`` spans of a
    StepProfiler Chrome trace (the union of its kernel events)."""
    ev = json.load(open(path))["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("name") == "train" and e.get("cat") == "user_annotation"
             and "dur" in e]
    lo, hi = min(s for s, _ in spans), max(t for _, t in spans)
    ks = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in ev
                if e.get("cat") == "kernel" and "dur" in e
                and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, cur = 0.0, None
    for s, t in ks:
        if cur is None or s > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    busy += 0 if cur is None else cur[1] - cur[0]
    names = {e["name"] for e in ev if e.get("cat") == "kernel"}
    return busy / 1e3, 1 - busy / (hi - lo), (hi - lo) / 1e3, names, len(
        spans)


def phase_tu_path(torch, cf, ts, sc, dev):
    """Path 17 (phase 53): the train utilities on the card with the flat
    SchNet through the sorted-CSR kernel."""
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SchNet
    from dig_tpu_torch.threed import Run3D, ThreeDEvaluator
    from dig_tpu_torch.train import (StepProfiler, TrainState,
                                     assert_donation_discipline, debug_mode,
                                     make_step_fns)
    mols = synthetic_molecules(8, seed=0, max_atoms=12, num_targets=1)
    g = next(iter(MoleculeLoader(mols, 8, n_node_pad=96, device=dev)))
    model = SchNet(**PAR_DP_KW, generator=torch.Generator().manual_seed(0),
                   device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step, _ = make_step_fns(model, opt)
    root = tempfile.mkdtemp()
    reset_all(cf, ts, sc)
    prof = StepProfiler(os.path.join(root, "prof"), start_step=1,
                        num_steps=2)
    for _ in range(3):
        with prof.step():
            step(g)
    prof.stop()
    launches = sc.launches          # the 3 steps', read before the checks
    busy, idle, window, names, n_spans = trace_idle(prof.path)
    row = "segment_csr_row_kernel" in " ".join(names)
    log(f"  StepProfiler(start_step=1, num_steps=2) over 3 flat-SchNet "
        f"steps: {os.path.basename(prof.path)}, {n_spans} train spans, "
        f"{window / 2:.3f} ms a step inside them, device busy "
        f"{busy / 2:.3f} ms a step, idle {idle:.3f}; kernels named "
        f"segment_csr_row_kernel {row}; {launches / 3:g} segment-sum "
        f"launches a step")
    if n_spans != 2 or not row:
        fail(f"path 17: the trace holds {n_spans} train spans, the row "
             f"kernel named {row}")
    seg = torch.arange(8, device=dev).repeat_interleave(4).int()
    rp = torch.arange(0, 33, 4, device=dev).int()
    bad = torch.randn(32, 16, device=dev)
    bad[5, 3] = float("nan")
    before = sc.launches
    try:
        with debug_mode():
            sc.segment_sum_sorted_csr(bad, seg, rp, 8, 32, 1024).sum()
        fail("path 17: debug_mode let a NaN through the segment-sum kernel")
    except FloatingPointError as exc:
        raised = str(exc)
    launched = sc.launches - before
    with debug_mode():
        loss = float(step(g)["loss"])
    log(f"  debug_mode: a NaN in the kernel's input raised at the first read "
        f"of its output ({launched} launch): {raised!r}; a clean step under "
        f"debug_mode: loss {loss:.6f}, silent")
    if launched != 1 or not math.isfinite(loss):
        fail("path 17: debug_mode")
    assert_donation_discipline(step, TrainState(model, opt), g)
    log("  assert_donation_discipline: the step updates every weight and "
        "Adam moment in place")
    pdir = os.path.join(root, "run3d")
    r3 = Run3D().run(mols[:6], mols[6:7], mols[7:], SchNet(
        **PAR_DP_KW, generator=torch.Generator().manual_seed(1), device=dev),
        ThreeDEvaluator(), epochs=1, batch_size=3, vt_batch_size=1,
        n_node_pad=36, quiet=True, debug=True, profile_dir=pdir, device=dev)
    traces = [f for f in os.listdir(pdir) if f.endswith(".json")]
    log(f"  Run3D(debug=True, profile_dir=...): one epoch, best valid "
        f"{r3['best_valid']:.6f}, traces {traces}")
    if not math.isfinite(r3["best_valid"]) or len(traces) != 1:
        fail("path 17: Run3D with debug and profile_dir")
    others_idle(cf, ts, "path 17")
    return {"step_busy_ms": busy / 2, "idle": idle,
            "step_ms": window / 2, "launches": launches}


def par_seg_cases(res):
    """Phase 54's cases: every segment-sum call shape of path 16's timed GP
    steps, from the calls noted there (the first call's ids and row
    pointer of each shape)."""
    cases = []
    for name, r in res["gp"].items():
        calls = r["calls"]
        for key, per in sorted(calls.per_step(r["steps"]).items()):
            E, F, N = key[:3]
            cases.append((f"16{name}_E{E}_F{F}_N{N}", calls.ids[key],
                          calls.rowptr[key], N, F, per))
    return cases


def build_all(_build, builds):
    """Build every CUDA source at once (one nvcc each): ``builds`` maps a
    label to (source name, generated headers or None); the seconds each
    took and the whole."""
    from concurrent.futures import ThreadPoolExecutor

    def one(spec):
        t = time.perf_counter()
        _build.build(*spec)
        return time.perf_counter() - t
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(one, builds.values())))
    return secs, time.perf_counter() - t0


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if sys.argv[1:2] == ["--repeat-step"]:
        repeat_step(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--remat-step"]:
        remat_step(*sys.argv[2:5])
        return
    from dig_tpu_torch.ops import _build
    from dig_tpu_torch.ops import cfconv as cf
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.ops import triplet_product as tp
    from dig_tpu_torch.ops import triplet_pt as tpt
    from dig_tpu_torch.ops import triplet_slot as ts

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version = oracle
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    log("== 1. card")
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = sms * SFU_PER_SM_CLK * clock_mhz * 1e6
    log(f"  {device_name} x{count}; nvidia-smi: {card}; {sms} SMs, max SM "
        f"clock {clock_mhz:.0f} MHz; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")

    log("== 2. build")
    builds = {n: (n, None) for n in ("cfconv", "triplet_slot", "segment_csr",
                                     "triplet_product", "triplet_pt")}
    for has_t in (True, False):
        cfg = (SN_KW["num_spherical"], SN_KW["num_radial"], has_t)
        builds[f"triplet_slot_geom {ts.geom_library_spec(cfg)[0]}"] = (
            "triplet_slot_geom", ts.geom_library_spec(cfg))
    secs, whole = build_all(_build, builds)
    log(f"  nvcc sm_90a builds, one process per source, all at once: "
        + ", ".join(f"{n} {secs[n]:.1f} s" for n in builds)
        + f"; {whole:.1f} s in all")
    for label, spec in builds.items():
        log(f"  {label}:")
        for line in _build.build_report(*spec).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("    " + line.strip())

    batches = cf_batches(torch, dev, STEPS + 1)

    log("== 3. kernel vs plain: cfconv (bench shapes)")
    inputs = bucket_inputs(torch, batches[-1], dev)
    errs = phase_kernel_vs_plain(torch, cf, inputs)

    log("== 4. main path 1: SchNetDense 4x128 bf16, fused cfconv, "
        "Adam(5e-4)")
    main_res = phase_main_path(torch, cf, dev, batches[:STEPS])

    log("== 5. times: cfconv")
    rows = phase_times(torch, cf, inputs, sfu_rate)
    del inputs, batches

    sn_b = sn_batches(torch, dev, SN_STEPS + 1)
    log("== 6. kernel vs plain: triplet_slot (flagship shapes, pt of a "
        "real batch)")
    sn_inp = sn_kernel_inputs(torch, dev, sn_b[-1])
    sn_errs = phase_sn_kernel_vs_plain(torch, ts, sn_inp)

    log("== 7. main path 2: SphereNet 4x128 bf16, slot kernel, Adam(5e-4)")
    sn_res = phase_sn_main_path(torch, cf, ts, sc, dev, sn_b[:SN_STEPS])

    log("== 8. times: triplet_slot")
    sn_rows = phase_sn_times(torch, ts, sn_inp)
    del sn_b, sn_inp
    torch.cuda.empty_cache()

    sf_b = sf_batches(torch, dev, SF_STEPS + 1)
    log("== 9. kernel vs plain: triplet_slot second order (force bench "
        "buckets, pt of a real batch)")
    sf_inp, bwd2_err = phase_sf_kernel_vs_plain(torch, ts, dev, sf_b[-1])

    log("== 10. main path 3: SphereNet energy+force 4x128 bf16, slot "
        "kernel, buckets {16: 27, 24: 43, 29: 26}, Adam(5e-4)")
    sf_res = phase_sf_main_path(torch, cf, ts, sc, dev, sf_b[:SF_STEPS])
    phase_sf_run3d(torch, ts, dev)

    log("== 11. times: triplet_slot second order")
    sf_rows = phase_sf_times(torch, ts, sf_inp)
    del sf_b, sf_inp
    torch.cuda.empty_cache()
    ga_splits = geom_bwd2_split(torch, ts, dev)
    torch.cuda.empty_cache()

    fs_b = fs_batches(torch, dev, FS_STEPS + 1)
    sp_b = sp_batches(torch, dev, SP_STEPS + 1)
    log("== 12. kernel vs plain: segment_sum_sorted_csr (flat paths' "
        "receivers, skewed random CSR)")
    seg_inputs = seg_cases(torch, dev, fs_b[-1], sp_b[-1])
    seg_err = phase_seg_kernel_vs_plain(torch, sc, seg_inputs)

    log("== 13. main path 4a: flat SchNet energy+force 4x128 f32, "
        "segment_eb=1024, batches of 24 in slots of 29, Adam(1e-3)")
    fs_res = phase_fs_main_path(torch, cf, ts, sc, dev, fs_b[:FS_STEPS])
    phase_fs_run3d(torch, sc, dev)
    del fs_b
    torch.cuda.empty_cache()

    log("== 14. main path 4b: flat SphereNet energy 4x128 f32 (tutorial "
        "widths), segment_eb=1024, batches of 32, Adam(5e-4)")
    sp_res = phase_sp_main_path(torch, cf, ts, sc, dev, sp_b[:SP_STEPS])
    del sp_b
    torch.cuda.empty_cache()

    log("== 15. times: segment_sum_sorted_csr; the flat steps")
    seg_rows, seg_steps = phase_seg_times(
        torch, sc, seg_inputs, {"4a": fs_res["by_shape"],
                                "4b": sp_res["by_shape"]})
    log(f"  path 4a: force step {fs_res['step_ms']:.3f} ms, "
        f"{fs_res['edges_per_s']:.6g} edges/s; path 4b: step "
        f"{sp_res['step_ms']:.3f} ms, {sp_res['edges_per_s']:.6g} edges/s")

    del seg_inputs
    torch.cuda.empty_cache()
    nk_b = nk_batches(torch, dev, NK_STEPS + 1)
    log("== 16. kernel vs plain: fused_triplet_product (path 5a) and "
        "fused_angle_product (path 5b), the bases and mask of a real batch")
    nk_inp = {"5a": nk_kernel_inputs(torch, dev, nk_b[-1], "5a"),
              "5b": nk_kernel_inputs(torch, dev, nk_b[-1], "5b")}
    nk_errs = phase_nk_kernel_vs_plain(torch, tp, nk_inp)

    log("== 17. main path 5a: SphereNet energy+force 4x128 bf16 on the "
        "unblocked NK layout (K=16), fused_triplet_product, batches of 96, "
        "Adam(5e-4)")
    nk_res = {"5a": phase_nk_main_path(torch, cf, ts, sc, tp, tpt, dev,
                                       nk_b[:NK_STEPS], "5a")}
    torch.cuda.empty_cache()

    log("== 18. main path 5b: DimeNet++ energy 4x128 bf16 (n=7, k=6) on the "
        "unblocked NK layout (K=16), fused_angle_product without basis "
        "gradients, batches of 96, Adam(5e-4)")
    nk_res["5b"] = phase_nk_main_path(torch, cf, ts, sc, tp, tpt, dev,
                                      nk_b[:NK_STEPS], "5b")
    torch.cuda.empty_cache()

    log("== 19. times: fused_triplet_product / fused_angle_product; paths "
        "5a and 5b")
    nk_rows = phase_nk_times(torch, tp, nk_inp)
    for path, r in nk_res.items():
        log(f"  path {path}: step {r['step_ms']:.3f} ms, "
            f"{r['edges_per_s']:.6g} edges/s (uncapped pairs), "
            f"{r['kept_edges_per_s']:.6g} (kept NK edges)")
    del nk_inp
    torch.cuda.empty_cache()

    log("== 20. kernel vs plain: fused_triplet_pt (paths 6a and 6b), the "
        "packed basis and mask of a real batch")
    pt_inp = {p: pt_kernel_inputs(torch, dev, nk_b[-1], p) for p in PT_PATHS}
    pt_errs = phase_pt_kernel_vs_plain(torch, tpt, pt_inp)

    log("== 21. main path 6a: SphereNet energy+force 4x128 bf16 on the "
        "unblocked NK layout (K=16), the packed basis (fused_triplet_pt), "
        "batches of 96, Adam(5e-4)")
    pt_res = {"6a": phase_nk_main_path(torch, cf, ts, sc, tp, tpt, dev,
                                       nk_b[:NK_STEPS], "6a")}
    torch.cuda.empty_cache()

    log("== 22. main path 6b: DimeNet++ energy+force 4x128 bf16 (n=7, k=6, "
        "its published widths) on the same layout, the packed basis without "
        "torsion, batches of 96, Adam(5e-4)")
    pt_res["6b"] = phase_nk_main_path(torch, cf, ts, sc, tp, tpt, dev,
                                      nk_b[:NK_STEPS], "6b")
    torch.cuda.empty_cache()

    del nk_b
    torch.cuda.empty_cache()
    log("== 23. repeatability: paths 3, 4a and 6a, one step each in two "
        "fresh processes from the same seeded state")
    phase_repeat(torch)
    torch.cuda.empty_cache()

    log("== 24. times: fused_triplet_pt; paths 6a and 6b")
    pt_rows = phase_pt_times(torch, tpt, pt_inp)
    for path, r in pt_res.items():
        log(f"  path {path}: step {r['step_ms']:.3f} ms, "
            f"{r['edges_per_s']:.6g} edges/s (uncapped pairs), "
            f"{r['kept_edges_per_s']:.6g} (kept NK edges)")
    del pt_inp
    torch.cuda.empty_cache()

    ga_b = ga_batches(torch, dev, GA_STEPS)
    log("== 25. kernel vs plain: fused_triplet_slot_geom (path 7a's shape, "
        "the geometry of a real batch)")
    ga_inp = ga_kernel_inputs(torch, dev, ga_b[-1])
    ga_errs = phase_ga_kernel_vs_plain(torch, ts, ga_inp)
    torch.cuda.empty_cache()

    log("== 26. main path 7a: the geometry op in energy+force training, 4 "
        "layers at the flagship slot width (K=16, C=64, n=3, k=6, torsion), "
        "batches of 96 in slots of 29, Adam(5e-4), bf16")
    ga_res = phase_ga_main_path(torch, ts, sc, dev, ga_b)
    del ga_b
    torch.cuda.empty_cache()

    log("== 27. main path 7b: the chunked sorted-CSR segment sum on "
        "bench_spmm_roofline's graph (N=60000, avg_deg 16, F=128); "
        "spmm_csr; kernel vs plain")
    g60k = large_graph()
    cs_g = cs_graph(torch, dev, g60k)
    log(f"  E={cs_g['E']} edges, largest in-degree {cs_g['max_degree']}")
    sc.reset_launch_counts()
    cs_errs = phase_cs_path(torch, sc, cs_g, cs_skewed(torch, dev))
    cs_launches = sc.launches_chunked
    torch.cuda.empty_cache()

    log("== 28. times: fused_triplet_slot_geom beside the pt chain; path 7a; "
        "the chunked segment sum")
    ga_rows = phase_ga_times(torch, ts, ga_inp, ga_splits)
    log(f"  path 7a: step {ga_res['step_ms']:.3f} ms")
    for r in sf_rows:
        if r["kernel"] == "triplet_slot_bwd2":
            log(f"  (phase 11) triplet_slot_bwd2 A={r['A']} {r['precision']}: "
                f"{r['ms']:.4f} ms; {split_text(r['split'])}")
    cs_rows = phase_cs_times(torch, sc, cs_g)
    del ga_inp, cs_g
    torch.cuda.empty_cache()

    log("== 29. main path 8a: ComENet energy+force 4x256 f32 (published "
        "widths), NK-blocked (K=28), batches of 32 in slots of 29, "
        "Adam(5e-4)")
    new_res = {"8a": phase_ce_main_path(torch, cf, ts, sc, dev)}
    torch.cuda.empty_cache()

    log("== 30. main path 8b: ComENet-OCP energy+force 4x256 f32 on periodic"
        " crystals of 20-80 atoms (cutoff 6, one shell of images), batches "
        "of 8, Adam(5e-4)")
    new_res["8b"] = phase_ocp_main_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()

    log("== 31. main path 8c: ProNet all-atom energy 4x128 f32 (published "
        "widths), NK-blocked (K=32), proteins of 64-192 residues, batches of"
        " 16 in slots of 192, Adam(5e-4)")
    new_res["8c"] = phase_pn_main_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()

    log("== 32. times: the segment sum at every call shape of paths 8a-8c")
    new_rows = new_seg_rows(torch, sc, new_res)
    for path, res in new_res.items():
        tot = {f: sum(r["per_step"] * r[f] for r in new_rows
                      if r["path"] == path)
               for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
        log(f"  path {path} step, every segment sum ({res['per_step']} "
            f"calls): kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f}"
            f" ms, plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms")
        res.pop("calls")
    torch.cuda.empty_cache()

    log("== 33. SchNetDense forces: path 1's model and buckets, F = -dE/dpos"
        " through the cfconv kernels (pos_grads=True) against the einsum "
        "branch")
    df_res = phase_dense_forces(torch, cf, dev, cf_batches(torch, dev, 1)[0])
    for prec in ("bf16", "f32"):
        nd = [r for r in rows if r["kernel"] == "cfconv_bwd"
              and r["precision"] == prec and r["need_dist_grad"]]
        log(f"  (phase 5) cfconv_bwd with need_dist_grad, {prec}, one layer "
            f"(3 buckets): {sum(r['ms'] for r in nd):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in nd):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in nd):.3f} ms; "
            f"{df_res['launches_bwd']} launches a force pass")
    torch.cuda.empty_cache()

    log("== 34. remat: path 3's force step on its 29-atom bucket, remat off"
        " and on, each in a fresh process from the same seeded state")
    phase_remat(torch)
    torch.cuda.empty_cache()

    log("== 35. main path 9: lsgraph, bench_lsgraph's partitioned GCN "
        "training (60,000 nodes, 16 parts, 4 a subgraph, GCN 128 x 3, f32, "
        "Adam(1e-3)) through the sorted-CSR kernel in both directions; "
        "then SELL forced")
    ls_res = phase_ls_main_path(torch, cf, ts, sc, dev, g60k)
    torch.cuda.empty_cache()

    log("== 36. the segment sum at path 9's shapes: kernel vs plain, times")
    ls_rows, ls_err = phase_ls_seg(torch, sc, dev, ls_res.pop("ls"))
    tot = {f: sum(r["per_step"] * r[f] for r in ls_rows)
           for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
    log(f"  path 9 epoch, every segment sum ({ls_res['launches'][0]} "
        f"calls): kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
        f"ms, plain {tot['plain_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms; largest abs err {ls_err:.3e}")
    torch.cuda.empty_cache()

    log("== 37. lsgraph at examples/lsgraph/run_graphfm.py's size: "
        "mini_inference and a GraphFM-IB step, card against CPU")
    phase_ls_small(torch, sc, dev)
    torch.cuda.empty_cache()

    log("== 38. main path 10: ssl, bench_ssl's GraphCL pretraining (GIN 128 "
        "x 3, dim 384, dropN / maskN, 512 graphs in batches of 64, f32, "
        "Adam(1e-3)) through the sorted-CSR kernel")
    ssl_res = phase_ssl_main_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()

    log("== 39. the segment sum at path 10's shapes: kernel vs plain, times")
    ssl_rows, ssl_err = phase_ssl_seg(torch, sc, ssl_res, dev)
    ssl_res.pop("calls")
    tot = {f: sum(r["per_step"] * r[f] for r in ssl_rows)
           for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
    log(f"  path 10 step, every segment sum ({ssl_res['per_step']:g} "
        f"calls): kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
        f"ms, plain {tot['plain_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms; largest abs err {ssl_err:.3e}")
    torch.cuda.empty_cache()

    log("== 40. path 10b: InfoGraph, MVGRL, GRACE, pGRACE and the "
        "GraphSemisupervised finetune step, one step each, card against CPU")
    phase_ssl_small(torch, sc, dev)
    torch.cuda.empty_cache()

    log("== 41. path 11: auggraph (SMixup, RunnerRewardGen, RunnerGenerator, "
        "RunnerAugCls): first steps against the CPU, one epoch each")
    phase_aug_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()

    gg_ds, gg_ld = gg_loader()
    reset_all(cf, ts, sc)
    log("== 42. main path 12: GraphDF at the published QM9 width (max_size "
        "20, edge_unroll 12, 12 flow layers, RGCN 128 x 3, batch 32, f32, "
        f"Adam(1e-3)) on {len(gg_ds)} synthetic molecules: the first step, "
        "card against CPU")
    gg_res = phase_gg_first_step(torch, dev, next(iter(gg_ld)))
    log(f"== 43. path 12: GraphDF.train_rand_gen, {GG_EPOCHS} epochs on the "
        "card")
    gg_model, gg_train = phase_gg_train(torch, dev, gg_ld)
    gg_res.update(gg_train)
    log("== 44. path 12: run_rand_gen(48 molecules) on the card and the CPU")
    gg_atoms = sum(float(a.sum()) for a in gg_ds.x) / len(gg_ds.x)
    gg_res.update(phase_gg_generate(torch, dev, gg_model, gg_atoms))
    del gg_model
    torch.cuda.empty_cache()
    log("== 45. path 12: GraphAF at the same widths: the first step, card "
        "against CPU, and run_rand_gen(8 molecules) from its seeded weights")
    af_res = phase_gg_af(torch, dev, next(iter(gg_ld)))
    others_idle(cf, ts, "path 12")
    if sc.launches:
        fail(f"path 12: {sc.launches} segment-sum launches (none expected)")
    torch.cuda.empty_cache()
    log("== 46. path 12b: GraphAF, GraphEBM, PPO, JTVAE and JTMPN at the JAX "
        "tests' widths, card against CPU")
    phase_gg_small(torch, dev)
    torch.cuda.empty_cache()
    log("== 47. main path 13: xgraph, bench_xgraph's GCN_2l (hidden 32) on "
        "ba_2motifs(120), train_gnn(epochs=25), GNNExplainer(epochs=60) "
        "explain_batch over 32 graphs; GIN_3l (hidden 64) step")
    xg_res = phase_xg_main_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()
    log("== 48. path 13b: GradCAM, GNN-GI, DeepLIFT, FlowX, GNN-LRP, a "
        "PGExplainer step and SubgraphX from path 13's weights, card "
        "against CPU")
    phase_xg_others(torch, sc, dev, xg_res)
    torch.cuda.empty_cache()
    log("== 49. main path 14: G-SphereNet (hidden 64, 4 flow layers) on "
        "QM93DGEN(16 steps a batch), 4 epochs, generate(256, max_atoms=9)")
    gs_res = phase_gs_main_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()
    gs_res["profiles"] = gs_profiles(torch, dev)
    log("== 50. the segment sum at the call shapes of paths 13 and 14: "
        "kernel vs plain, times")
    xs_rows, xs_err = phase_new_seg(
        torch, sc, dev, xg_gs_seg_cases(torch, sc, dev, xg_res, gs_res))
    for path, per in (("13", "an explanation epoch"), ("14", "a train step")):
        tot = {f: sum(r["per_step"] * r[f] for r in xs_rows
                      if r["path"] == path)
               for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
        log(f"  path {path}, {per}, every segment sum: kernel "
            f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    log("== 51. main path 15: fairgraph's Graphair at run()'s widths "
        "(hidden 64, alpha 20, beta 0.9, gamma 0.7, lam 1) on "
        f"synthetic_fair_graph({FG_N}, avg_deg={FG_DEG}): the first warm, "
        "adversary and main steps against the CPU, fit_whole for about "
        f"{FG_SECONDS:g} s, test()")
    fg_res = phase_fg_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()
    log("== 52. main path 16: the parallel engines at world size 1 in an "
        "NCCL group: collective_selfcheck, a DP step, the GP engine "
        f"(GPGCN2 and GPPNA {GP_HIDDEN} x {GP_LAYERS} on the 60,000-node "
        f"graph, GPSchNet 3 x 64 on {GPS_ATOMS} atoms) through the "
        "sorted-CSR kernel, TP / PP / EP")
    reset_all(cf, ts, sc)
    par_res = phase_par_path(torch, cf, ts, sc, dev, g60k)
    del g60k
    torch.cuda.empty_cache()
    log("== 53. path 17: the train utilities on the card (StepProfiler, "
        "debug_mode, assert_donation_discipline, Run3D(debug=True, "
        "profile_dir=...)) with the flat SchNet through the kernel")
    tu_res = phase_tu_path(torch, cf, ts, sc, dev)
    torch.cuda.empty_cache()
    log("== 54. the segment sum at path 16's call shapes: kernel vs plain, "
        "times")
    par_rows, par_err = phase_new_seg(torch, sc, dev,
                                      par_seg_cases(par_res))
    for model_name, r in par_res["gp"].items():
        tot = {f: sum(row["per_step"] * row[f] for row in par_rows
                      if row["path"] == f"16{model_name}")
               for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
        log(f"  path 16 {model_name} step, every segment sum "
            f"({r['per_step']} "
            f"calls): kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f}"
            f" ms, plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms")
        r.pop("calls")
    torch.cuda.empty_cache()
    fgm = fg_res["metrics"]
    log(f"  path 15: {fg_res['epoch_ms']:.3f} ms an epoch over "
        f"{fg_res['epochs']} epochs, peak {fg_res['peak_gib']:.3f} GiB, "
        f"accuracy {fgm['accuracy']:.4f}, DP {fgm['dp']:.3f}, EO "
        f"{fgm['eo']:.3f}; idle {par_res['profile']['graphair']['idle']:.3f}"
        f" ({card})")
    log("  path 16: " + "; ".join(
        f"{n} {r['step_ms']:.3f} ms a step, {r['per_step']} segment-sum "
        f"launches" for n, r in par_res["gp"].items())
        + f"; GPGCN2 idle {par_res['profile']['gp']['idle']:.3f}; path 17: "
        f"a traced flat-SchNet step {tu_res['step_ms']:.3f} ms, idle "
        f"{tu_res['idle']:.3f} ({card})")
    log(f"  path 13: train step {xg_res['step_ms']:.3f} ms, training "
        f"accuracy {xg_res['acc']:.4f}; {xg_res['explanations_per_s']:.6g} "
        f"explanations/s, {xg_res['per_epoch']} launches an epoch; path 14: "
        f"step {gs_res['step_ms']:.3f} ms, {gs_res['mols_per_s']:.6g} "
        f"mols/s, {gs_res['atoms']:.3f} atoms a molecule, validity "
        f"{gs_res['validity']:.2f}% ({card})")
    log(f"  path 12: step {gg_res['step_ms']:.3f} ms, peak "
        f"{gg_res['peak_gib']:.3f} GiB; generation "
        f"{gg_res['mols_per_s']:.6g} mols/s, validity "
        f"{gg_res['validity']:.3f}, validity_no_resample "
        f"{gg_res['validity_no_resample']:.3f}, "
        f"{gg_res['atoms_mean']:.2f} atoms a molecule (training molecules "
        f"{gg_atoms:.2f}); GraphAF first step loss rel "
        f"{af_res['loss_rel_err']:.3e}, worst gradient "
        f"{af_res['worst_param'][0]:.3e} ({card})")
    log(f"  path 10: {ssl_res['graphs_per_s']:.6g} graphs/s (median of "
        f"{SSL_EPOCHS} epochs: {[round(v, 3) for v in ssl_res['epoch_ms_all']]}"
        f" ms), {ssl_res['per_step']:g} segment-sum launches a step, peak "
        f"{ssl_res['peak_gib']:.3f} GiB ({card})")
    for path, r in new_res.items():
        log(f"  path {path}: step {r['step_ms']:.3f} ms, "
            f"{r['edges_per_s']:.6g} edges/s, peak {r['peak_gib']:.2f} GiB "
            f"({card})")
    log(f"  path 9: epoch {ls_res['epoch_ms']:.3f} ms, "
        f"{ls_res['edges_per_s']:.6g} edges/s through the kernel; SELL "
        f"{ls_res['sell']['epoch_ms']:.3f} ms, "
        f"{ls_res['sell']['edges_per_s']:.6g} edges/s; peak "
        f"{ls_res['peak_gib']:.2f} GiB ({card})")

    def total(kernel, key):
        return sum(r[key] for r in rows if r["kernel"] == kernel
                   and r["precision"] == "bf16"
                   and r["need_dist_grad"] in (None, False))

    kernels = []
    for kname, launches, replaces, err in (
            ("cfconv_fwd", main_res["launches_fwd"],
             "dig_tpu/ops/pallas_cfconv.py:273", errs["fwd"]),
            ("cfconv_bwd", main_res["launches_bwd"],
             "dig_tpu/ops/pallas_cfconv.py:320", errs["bwd"])):
        b_rows = [r for r in rows if r["kernel"] == kname
                  and r["precision"] == "bf16"
                  and r["need_dist_grad"] in (None, False)]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "dig_tpu_torch/csrc/cfconv.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": total(kname, "ms"), "plain_ms": total(kname, "plain_ms"),
            "bound_ms": total(kname, "bound_ms"),
            "bound_by": max(b_rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None})
    for kname, launches, replaces, err in (
            ("triplet_slot_fwd", sn_res["launches_fwd"],
             "dig_tpu/ops/pallas_triplet_slot.py:429", sn_errs["fwd"]),
            ("triplet_slot_bwd", sn_res["launches_bwd"],
             "dig_tpu/ops/pallas_triplet_slot.py:458", sn_errs["bwd"])):
        r = next(r for r in sn_rows if r["kernel"] == kname
                 and r["precision"] == "bf16" and not r["need_dpt"])
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "dig_tpu_torch/csrc/triplet_slot.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    b_rows = [r for r in sf_rows if r["precision"] == "bf16"
              and r["kernel"] == "triplet_slot_bwd2"]
    kernels.append({
        "name": "triplet_slot_bwd2", "route": "cuda",
        "source": "dig_tpu_torch/csrc/triplet_slot.cu",
        "replaces": "dig_tpu/ops/pallas_triplet_slot.py:501",
        "launches": sf_res["launches_bwd2"], "max_abs_err": bwd2_err,
        "ms": sum(r["ms"] for r in b_rows),
        "plain_ms": sum(r["plain_ms"] for r in b_rows),
        "bound_ms": sum(r["bound_ms"] for r in b_rows),
        "bound_by": max(b_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None})
    r = seg_steps["4a"]
    kernels.append({
        "name": "segment_sum_sorted_csr", "route": "cuda",
        "source": "dig_tpu_torch/csrc/segment_csr.cu",
        "replaces": "dig_tpu/ops/pallas_segment.py:156",
        "launches": (fs_res["launches"] + ls_res["kernel_launches"]
                     + ssl_res["launches"] + xg_res["launches"]
                     + gs_res["launches"] + par_res["dp_launches"]
                     + sum(r["launches"] for r in par_res["gp"].values())
                     + tu_res["launches"]),
        "max_abs_err": max(seg_err, ls_err, ssl_err, xs_err, par_err),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for kind, i in (("fwd", 0), ("bwd", 1), ("bwd2", 2)):
        r = next(r for r in nk_rows if r["kernel"] == f"triplet_product_{kind}"
                 and r["path"] == "5a" and r["precision"] == "bf16")
        kernels.append({
            "name": f"triplet_product_{kind}", "route": "cuda",
            "source": "dig_tpu_torch/csrc/triplet_product.cu",
            "replaces": "dig_tpu/ops/pallas_triplet.py:"
                        + {"fwd": "263", "bwd": "312", "bwd2": "386"}[kind],
            "launches": sum(res["launches"][i] for res in nk_res.values()),
            "max_abs_err": nk_errs[kind], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for kind in ("fwd", "bwd", "bwd2"):
        r = next(r for r in pt_rows if r["kernel"] == f"triplet_pt_{kind}"
                 and r["path"] == "6a" and r["precision"] == "bf16")
        kernels.append({
            "name": f"triplet_pt_{kind}", "route": "cuda",
            "source": "dig_tpu_torch/csrc/triplet_pt.cu",
            "replaces": "dig_tpu/ops/pallas_triplet_pt.py:"
                        + {"fwd": "236", "bwd": "263", "bwd2": "294"}[kind],
            "launches": sum(res["launches"][("fwd", "bwd", "bwd2").index(
                kind)] for res in pt_res.values()),
            "max_abs_err": pt_errs[kind], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for kind in ("fwd", "bwd", "bwd2"):
        r = next(r for r in ga_rows if r["kernel"] == f"triplet_slot_geom_"
                 f"{kind}" and r["precision"] == "bf16")
        kernels.append({
            "name": f"triplet_slot_geom_{kind}", "route": "cuda",
            "source": "dig_tpu_torch/csrc/triplet_slot_geom.cu",
            "replaces": "dig_tpu/ops/pallas_triplet_slot.py:"
                        + {"fwd": "565", "bwd": "588", "bwd2": "626"}[kind],
            "launches": ga_res["launches"][("fwd", "bwd", "bwd2").index(
                kind)],
            "max_abs_err": ga_errs[kind], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    r = next(r for r in cs_rows if r["dtype"] == "float32")
    kernels.append({
        "name": "segment_sum_sorted_csr_chunked", "route": "cuda",
        "source": "dig_tpu_torch/csrc/segment_csr.cu",
        "replaces": "dig_tpu/ops/pallas_segment.py:325",
        "launches": cs_launches, "max_abs_err": cs_errs["fwd"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log("  (triplet_slot_geom_*: one bare launch = one layer of one path-7a "
        "step, bf16, dgeo asked for, u1 = u4 = u5 absent; launches from path "
        "7a's timed steps; the forward's library_ms is the einsum over the "
        "gathered x rows and sbf, tbf assembled outside the timed call; no "
        "PyTorch call returns the backward's or the second order's "
        "cotangents, so theirs is null. segment_sum_sorted_csr_chunked: one "
        "bare launch at path 7b's shape, f32; launches from path 7b's run; "
        "library_ms the faster of index_add_ and segment_reduce)")
    log("  (triplet_pt_*: one bare launch = one layer of one path-6a step, "
        "bf16, dpt asked for, u4 = u5 absent; launches summed over the timed "
        "runs of paths 6a and 6b; the forward's library_ms is the einsum over "
        "sbf and tbf assembled outside the timed call; no PyTorch call "
        "returns the backward's or the second order's cotangents, so theirs "
        "is null)")
    log("  (triplet_product_*: one bare launch = one layer of one path-5a "
        "step, bf16, basis gradients on, u4 = u5 absent; launches summed "
        "over the timed runs of paths 5a and 5b; the forward's library_ms "
        "is the einsum that computes it; no PyTorch call returns the "
        "backward's or the second order's cotangents, so theirs is null)")
    log("  (segment_sum_sorted_csr: every call of one path-4a step summed "
        "(its calls a step by shape from phase 13, each shape's bare launch "
        "timed in phase 15, f32), device time with the host ahead, as are "
        "plain_ms and library_ms (per shape the faster of index_add_ and "
        "segment_reduce); launches from path 4a's timed steps, the timed "
        "epochs of paths 9 and 10, path 13's timed explain_batch, path "
        "14's training, path 16's DP step and timed GP steps and path 17's "
        "3 profiled steps; max_abs_err the largest of phases 12, 36, 39, "
        "50 and 54)")
    log("  (cfconv ms, plain_ms and bound_ms: one call per bucket, summed "
        "over the 3 buckets = one layer of one step; triplet_slot fwd/bwd: "
        "one call = one layer of one energy step (main path 2), no "
        "geometry gradient; triplet_slot_bwd2: one call per bucket, summed "
        "over the 3 buckets = one layer of one force step (main path 3), "
        "u4 = u5 absent; all bf16 as on the main paths; the slot forward's "
        "library_ms is the einsum over the gathered x rows and sbf, tbf "
        "assembled outside the timed call; no PyTorch call computes cfconv "
        "or returns the slot cotangents, so theirs is null)")
    log(f"  force path: step {sf_res['step_ms']:.3f} ms, "
        f"{sf_res['edges_per_s']:.6g} edges/s (uncapped pairs), "
        f"{sf_res['kept_edges_per_s']:.6g} (kept NK edges)")
    log(f"  total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
