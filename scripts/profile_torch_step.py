"""Where the time of one of the port's train steps goes, on one card.

    python scripts/profile_torch_step.py [schnet_dense|spherenet|spherenet_force|schnet_force|spherenet_flat|spherenet_nk_force|dimenetpp_nk|spherenet_pt_force|comenet_force|comenet_ocp_force|pronet|lsgraph|ssl|ggraph|ggraph_gen|gspherenet|gspherenet_gen|graphair|gp] [--root DIR]

``--root`` names the checkout whose ``dig_tpu_torch`` runs (default: this
one), e.g. the parent unpacked with ``git archive``, so that two versions
can be profiled in one call.

``schnet_dense`` (the default) runs main path 1 of chip_smoke.py
(SchNetDense 4 x 128, bf16, fused cfconv, buckets {16: 252, 24: 380,
32: 236}, Adam); ``spherenet`` runs main path 2 (SphereNet 4 x 128, n=3,
k=6, K=16, slots of 29 atoms, 96 molecules a batch, bf16, slot kernel,
Adam); ``spherenet_force`` runs main path 3 (the same model trained on
energies and forces through make_bucketed_step_fns, buckets {16: 27,
24: 43, 29: 26}, bench.py bench_spherenet_force); ``schnet_force`` runs
main path 4a (flat SchNet 4 x 128, f32, energy+force through
make_step_fns, segment_eb=1024: the sorted-CSR segment-sum kernel, batches
of 24 Morse molecules in slots of 29, Adam(1e-3), p = 100, as
examples/threedgraph/run_morse_surrogate.py --model schnet --forces);
``spherenet_flat`` runs main path 4b (flat SphereNet at the tutorial's
widths, tutorials/threedgraph.md: 4 x 128, int_emb 64, basis 8/8/8,
out_emb 256, n=3, k=6, f32, max_edges 16384, max_in_degree 32,
segment_eb=1024, energy through make_step_fns, batches of 32, Adam(5e-4));
``spherenet_nk_force`` runs main path 5a (SphereNet 4 x 128, n=3, k=6,
bf16, on the unblocked [N, K] table with K=16, fused_triplet_product with
basis gradients, energy+force through make_step_fns, MoleculeLoader
batches of 96, Adam(5e-4), p = 100); ``dimenetpp_nk`` runs main path
5b (DimeNetPP's defaults, 4 x 128, n=7, k=6, bf16, on the same table and
batches, fused_angle_product without basis gradients, energy through
make_step_fns, Adam(5e-4)); ``spherenet_pt_force`` runs main path 6a (the same model, batches and step with ``pallas_fuse_basis``: the
packed basis table built once per forward and fused_triplet_pt in every
layer); ``comenet_force``, ``comenet_ocp_force`` and ``pronet`` run main
paths 8a-8c (ComENet 4 x 256 energy+force on the NK-blocked table, K = 28,
32 molecules in slots of 29; ComENet-OCP at the same widths, cutoff 6, on
8 synthetic crystals of 20-80 atoms, max_edges from pbc_overflow; ProNet
all-atom 4 x 128, K = 32, 16 proteins of 64-192 residues in slots of 192,
energy; all f32, Adam(5e-4), p = 100); ``lsgraph`` runs main path 9
(bench.py bench_lsgraph: ScalableGNN GCN 128 x 3 on
synthetic_large_graph(60000, avg_deg=16) in 16 parts, 4 a subgraph, f32,
Adam(1e-3); a step is one subgraph's, the sorted-CSR kernel forward and in
the adjoint in every layer); ``ssl`` runs main path 10 (bench.py bench_ssl:
GraphCL, dim 384, dropN / maskN views, over a GIN 128 x 3 on
synthetic_graph_dataset(512, seed=0) in shuffled batches of 64, f32,
Adam(1e-3); a step is one batch's, the views drawn on the card, the
sorted-CSR kernel in every neighbour sum, adjoint and readout);
``ggraph`` runs main path 12 (GraphDF at the published QM9 width:
max_size 20, edge_unroll 12, 12 flow layers, RGCN 128 x 3, batches of 32
of synthetic_smiles_dataset(max_size=20, repeat=8), f32, Adam(1e-3); a
step is one NLL step over the 182 masked views of each molecule);
``ggraph_gen`` runs path 12's generation (a step is one lockstep batch of
48 molecules, run_rand_gen(n_mols=48, temperature=(0.35, 0.23)) from the
seeded weights: one reverse step on the card a node or edge decision,
its output read on the host); ``gspherenet`` runs main path 14
(G-SphereNet at bench.py bench_ggraph3d_gen's config: QM93DGEN(16 steps a
batch) on its synthetic molecules, hidden 64, 4 flow layers, f32,
Adam(1e-3); a step is one NLL step over a batch of 16 placement steps, the
batches collated and moved to the card before timing, the dequantisation
noise drawn on the host) and ``gspherenet_gen`` its generation (a step is
one lockstep batch of 32 molecules, max_atoms 9, from the seeded weights:
eight atom steps on the card, read once at the end); ``graphair`` runs
main path 15 (Graphair at fairgraph.run()'s widths on
synthetic_fair_graph(8192, avg_deg=16): a step is one epoch after the
first, one adversary and one main step, the uniforms drawn on the card);
``gp`` runs main path 16's GPGCN2 (hidden 128, 3 layers, Adam(1e-3),
node_class_loss) on bench_lsgraph's 60,000-node graph in one part through
the GP engine, in a process group of one rank (NCCL, made here unless
one exists), its neighbour sums and their adjoints through the sorted-CSR
kernel.
Traces a few steady
steps with torch.profiler and prints the
step's host time, the device's busy and idle share, device time by
kernel, the segment-sum kernels' time by call shape, and the host
operators that took the most time.

The segment sums are told apart by their calls: during the traced steps
chip_smoke.py's SegmentCalls wraps ``ops.segment_csr.segment_csr_kernel``
(the call each sum of the card's autograd pair makes) to note each call's
shape (edges E, width F, rows N, type, whether its window holds every
edge: the gathers' adjoints and the readouts; the longest row range is
read after the window). The segment-sum kernels' device events, in stream order, are
matched to the calls in order: each call's events are one kernel, or a
piece pass and the row pass after it.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import time

import torch

SLOT_COUNTS = {16: 252, 24: 380, 32: 236}
WARMUP, TRACED = 3, 5


def _busy_us(events):
    """Union of the device kernels' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def schnet_dense(dev, steps):
    from dig_tpu_torch.datasets import (BucketedDenseMoleculeLoader,
                                        synthetic_molecules)
    from dig_tpu_torch.models import SchNetDense
    from dig_tpu_torch.train import make_dense_step_fns

    mols = synthetic_molecules(sum(SLOT_COUNTS.values()) * (steps + 3),
                               seed=0, min_atoms=12, max_atoms=29, box=6.0)
    it = iter(BucketedDenseMoleculeLoader(mols, SLOT_COUNTS, max_per_slot=2,
                                          shuffle=True, seed=0, device=dev))
    model = SchNetDense(cutoff=5.0, num_layers=4, hidden_channels=128,
                        num_filters=128, num_gaussians=50,
                        compute_dtype=torch.bfloat16, use_kernel=True,
                        pos_grads=False, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    return make_dense_step_fns(model, opt)[0], [next(it) for _ in range(steps)]


def spherenet(dev, steps):
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train import make_step_fns

    mols = synthetic_molecules(96 * (steps + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    it = iter(MoleculeLoader(mols, 96, slot_size=29, shuffle=True, seed=0,
                             device=dev))
    batches = [b.replace_globals(energy=b.globals["y"][:, :1])
               for b in (next(it) for _ in range(steps))]
    model = SphereNet(cutoff=5.0, num_layers=4, hidden_channels=128,
                      num_spherical=3, num_radial=6, nk_degree=16,
                      block_size=29, compute_dtype=torch.bfloat16,
                      pallas_triplet=True, pallas_fuse_basis=True,
                      pallas_slot=True, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, loss="l1", target_key="energy")
    return step, batches


def spherenet_force(dev, steps):
    import numpy as np

    from dig_tpu_torch.datasets import (BucketedMoleculeLoader,
                                        synthetic_molecules)
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train import make_bucketed_step_fns

    slots = {16: 27, 24: 43, 29: 26}
    mols = synthetic_molecules(96 * (steps + 4), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    rng = np.random.default_rng(0)
    for m in mols:
        m["force"] = rng.normal(size=m["pos"].shape).astype(np.float32)
    it = iter(BucketedMoleculeLoader(mols, slots, shuffle=True, seed=0,
                                     device=dev))
    model = SphereNet(cutoff=5.0, num_layers=4, hidden_channels=128,
                      num_spherical=3, num_radial=6, nk_degree=16,
                      block_size=29, compute_dtype=torch.bfloat16,
                      pallas_triplet=True, pallas_fuse_basis=True,
                      pallas_slot=True, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_bucketed_step_fns(model, opt, p=100.0)
    return step, [next(it) for _ in range(steps)]


def schnet_force(dev, steps):
    import numpy as np

    from dig_tpu_torch.datasets import (MoleculeLoader,
                                        synthetic_morse_molecules)
    from dig_tpu_torch.models import SchNet
    from dig_tpu_torch.train import make_step_fns

    mols = synthetic_morse_molecules(24 * (steps + 1), seed=0, min_atoms=12,
                                     max_atoms=29)
    ys = np.array([m["y"][0] for m in mols])
    for m in mols:           # run_morse_surrogate.py's standardisation
        m["y"] = ((m["y"][:1] - ys.mean()) / ys.std()).astype(np.float32)
        m["force"] = (m["force"] / ys.std()).astype(np.float32)
    it = iter(MoleculeLoader(mols, 24, slot_size=29, shuffle=True, seed=0,
                             device=dev))
    model = SchNet(cutoff=5.0, num_layers=4, hidden_channels=128,
                   num_filters=128, num_gaussians=50, max_edges=16384,
                   segment_eb=1024, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step, _ = make_step_fns(model, opt, energy_and_force=True, p=100.0)
    return step, [next(it) for _ in range(steps)]


def spherenet_flat(dev, steps):
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train import make_step_fns

    mols = synthetic_molecules(32 * (steps + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0)
    it = iter(MoleculeLoader(mols, 32, shuffle=True, seed=0, device=dev))
    batches = [b.replace_globals(energy=b.globals["y"][:, :1])
               for b in (next(it) for _ in range(steps))]
    model = SphereNet(cutoff=5.0, num_layers=4, hidden_channels=128,
                      int_emb_size=64, basis_emb_size_dist=8,
                      basis_emb_size_angle=8, basis_emb_size_torsion=8,
                      out_emb_channels=256, num_spherical=3, num_radial=6,
                      max_edges=16384, max_in_degree=32, segment_eb=1024,
                      generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, loss="l1", target_key="energy")
    return step, batches


def comenet_force(dev, steps):
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import ComENet
    from dig_tpu_torch.train import make_step_fns

    mols = synthetic_molecules(32 * steps, seed=0, min_atoms=12,
                               max_atoms=29, box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    batches = list(MoleculeLoader(mols, 32, slot_size=29, device=dev))
    model = ComENet(nk_degree=28, block_size=29,
                    generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, energy_and_force=True, p=100.0)
    return step, batches


def comenet_ocp_force(dev, steps):
    from dig_tpu_torch.datasets import (MoleculeLoader, morse_energy,
                                        synthetic_crystals)
    from dig_tpu_torch.models import ComENetOCP
    from dig_tpu_torch.ops.pbc import pbc_overflow
    from dig_tpu_torch.train import make_step_fns

    cr = synthetic_crystals(8 * steps, seed=0, min_atoms=20, max_atoms=80)
    cr = [dict(c, force=morse_energy(c["z"], c["pos"])[1]) for c in cr]
    batches = list(MoleculeLoader(cr, 8, n_node_pad=640, device=dev))
    edges = max(int(pbc_overflow(b.nodes["pos"], b.globals["cell"],
                                 b.node_graph, b.node_mask, 6.0, 0))
                for b in batches)
    model = ComENetOCP(cutoff=6.0, max_edges=-(-edges // 1024) * 1024,
                       generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, energy_and_force=True, p=100.0)
    return step, batches


def pronet(dev, steps):
    from dig_tpu_torch.datasets import ProteinLoader, synthetic_proteins
    from dig_tpu_torch.models import ProNet
    from dig_tpu_torch.train import make_step_fns

    prots = synthetic_proteins(16 * steps, min_res=64, max_res=192, seed=0)
    batches = list(ProteinLoader(prots, 16, slot_size=192, device=dev))
    model = ProNet(level="allatom", nk_degree=32, block_size=192,
                   generator=torch.Generator().manual_seed(0), device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, loss="l1")
    return step, batches


def _chip_smoke():
    """chip_smoke.py of this checkout, as a module (its path helpers)."""
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def lsgraph(dev, steps):
    """Path 9: one subgraph step of bench_lsgraph's epoch a step, the
    subgraphs in turn, the histories threaded through."""
    smoke = _chip_smoke()
    ls = smoke.ls_setup(smoke.large_graph())
    model = smoke.ls_model(torch, dev, ls["N"], ls["eb"])
    x = torch.tensor(ls["x"]).to(dev)
    y = torch.tensor(ls["y"]).to(dev)
    step, _ = smoke.ls_train_step(torch, model, x, y)
    subs = ls["subs"]
    for b in subs:              # the index tables on the card before timing
        b.tensors(dev)
    return step, [subs[i % len(subs)] for i in range(steps)]


def ssl(dev, steps):
    """Path 10: GraphCL's training step (Contrastive.make_step, as
    Contrastive.train runs it) on the epoch's batches in turn, moved to the
    card before timing."""
    smoke = _chip_smoke()
    from dig_tpu_torch.datasets import GraphClsLoader
    from dig_tpu_torch.ssl import Encoder, GraphCL
    loader = GraphClsLoader(smoke.ssl_data(smoke.SSL_N), smoke.SSL_BS,
                            shuffle=True)
    batches = []
    while len(batches) < steps:
        batches += [b.to(dev) for b in loader]
    enc = Encoder(**smoke.SSL_ENC, generator=torch.Generator().manual_seed(0),
                  device=dev)
    m = GraphCL(**smoke.SSL_GCL)
    heads = m.make_heads(torch.Generator().manual_seed(m.seed), dev)
    params = list(enc.parameters()) + list(heads["pg"].parameters())
    step = m.make_step([enc, enc], heads,
                       torch.optim.Adam(params, lr=smoke.SSL_LR),
                       torch.Generator(device=dev).manual_seed(m.seed))
    return step, batches[:steps]


def ggraph(dev, steps):
    """Path 12: GraphDF's NLL step (methods.flow_train_step, as
    train_rand_gen runs it) on the epoch's batches in turn, moved to the
    card before timing."""
    smoke = _chip_smoke()
    from dig_tpu_torch.ggraph.methods import flow_train_step
    from dig_tpu_torch.ggraph.models import GraphFlowModelDF
    _, loader = smoke.gg_loader()
    batches = []
    while len(batches) < steps:
        batches += [(torch.from_numpy(b["x"]).to(dev),
                     torch.from_numpy(b["adj"]).to(dev)) for b in loader]
    model = GraphFlowModelDF(**smoke.GG_CONF, generator=torch.Generator()
                             .manual_seed(0)).to(dev)
    step = flow_train_step(model, torch.optim.Adam(model.parameters(),
                                                   smoke.GG_LR))
    return (lambda b: step(*b)), batches[:steps]


def ggraph_gen(dev, steps):
    """Path 12's generation: one lockstep batch of 48 molecules a step,
    from the seeded weights, a seed a step."""
    smoke = _chip_smoke()
    from dig_tpu_torch.ggraph import GraphDF
    gdf = GraphDF()
    gdf.get_model("rand_gen", smoke.GG_CONF, device=dev)
    gdf.params = gdf.model.state_dict()
    gen = dict(smoke.GG_GEN)
    return (lambda seed: gdf.run_rand_gen(**dict(gen, seed=seed))), \
        list(range(steps))


def gspherenet(dev, steps):
    """Path 14: G-SphereNet's training step (model.loss, backward, Adam, as
    GSphereNet.train runs it) on the loader's batches in turn."""
    smoke = _chip_smoke()
    from dig_tpu_torch.ggraph3d import GSphereNet, QM93DGEN
    ds = QM93DGEN(num_steps_per_batch=smoke.GS_STEPS)
    batches = []
    while len(batches) < steps:
        batches += [(g.to(dev), {k: torch.as_tensor(v).to(dev)
                                 for k, v in st.items()})
                    for g, st in ds.loader()]
    model = GSphereNet(**smoke.GS_CONF).init_model(0, dev)
    opt = torch.optim.Adam(model.parameters(), smoke.GS_LR)
    gen = torch.Generator().manual_seed(0)

    def step(b):
        opt.zero_grad(set_to_none=True)
        loss, _ = model.loss(*b, model.draw(gen, smoke.GS_STEPS))
        loss.backward()
        opt.step()
    return step, batches[:steps]


def gspherenet_gen(dev, steps):
    """Path 14's generation: one lockstep batch of 32 molecules a step
    (max_atoms 9) from the seeded weights, a seed a step."""
    smoke = _chip_smoke()
    from dig_tpu_torch.ggraph3d import GSphereNet
    gs = GSphereNet(**smoke.GS_CONF)
    gs.model = gs.init_model(0, dev)
    L = smoke.GS_GEN["max_atoms"]

    def step(seed):
        draws = gs.draw_batch(torch.Generator().manual_seed(seed), 32,
                              len(smoke.GS_TYPES), L, L)
        z, _, n = gs.run_batch(draws, L, L)
        n.cpu()                                 # the batch read once
    return step, list(range(steps))


def graphair(dev, steps):
    """Path 15: one fit_whole epoch after the first a step (an adversary
    and a main step, uniforms drawn on the card)."""
    smoke = _chip_smoke()
    from dig_tpu_torch.fairgraph import Graphair
    data = smoke.fg_data()
    m = smoke.fg_model(torch, data, dev)
    n, f = data["x"].shape
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(_):
        m.adv_step(Graphair.draw(gen, n, f))
        m.main_step(Graphair.draw(gen, n, f))
    return step, list(range(steps))


def gp(dev, steps):
    """Path 16: GPGCN2's GP engine step on the 60,000-node graph in one
    part, in a one-rank process group."""
    import tempfile

    import torch.distributed as dist
    smoke = _chip_smoke()
    from dig_tpu_torch.parallel import init_local, make_gp_engine, make_mesh
    from dig_tpu_torch.parallel.gp import node_class_loss
    from dig_tpu_torch.parallel.gp_models import GPGCN2
    if not dist.is_initialized():
        init_local(0, 1, os.path.join(tempfile.mkdtemp(), "store"), "nccl")
    g = smoke.large_graph()
    case = smoke.gp_case(torch, "GPGCN2", g["senders"], g["receivers"],
                         g["x"], g["y"], g["train_mask"], node_class_loss)
    mod = GPGCN2(g["x"].shape[1], smoke.GP_HIDDEN, int(g["y"].max()) + 1,
                 smoke.GP_LAYERS,
                 generator=torch.Generator().manual_seed(0)).to(dev)
    _, step, _ = make_gp_engine(make_mesh((1,), ("data",)), mod,
                                torch.optim.Adam(mod.parameters(), 1e-3),
                                case["H"], case["C"],
                                loss_fn=node_class_loss, axis="data")
    return (lambda _: step(case["g"], case["x"], case["y"],
                           case["mask"])), list(range(steps))


def segment_report(calls, kernels, steps, busy_ms):
    """Device ms a step of each segment-sum kernel by call shape, from the
    calls chip_smoke.SegmentCalls noted."""
    evs = sorted((e for e in kernels if "segment_csr" in e.name),
                 key=lambda e: e.time_range.start)
    groups = []
    for e in evs:
        if "row_kernel" in e.name and groups and \
                "piece_kernel" in groups[-1][-1].name:
            groups[-1].append(e)
        else:
            groups.append([e])
    if len(groups) != len(calls.calls):
        print(f"  {len(evs)} segment-sum kernels in {len(groups)} calls "
              f"for {len(calls.calls)} noted calls; not attributed")
        return
    by = {}
    for key, group in zip(calls.calls, groups):
        t = by.setdefault(key, {})
        for e in group:
            name = re.search(r"segment_csr\w*(<[^>]*>)?", e.name)[0]
            t[name] = t.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    print("segment-sum kernels by call shape (E, F, N, type, full window; "
          "longest row range):")
    total = 0.0
    for key in sorted(by, key=lambda k: -sum(by[k].values())):
        rp = calls.rowptr[key].long()
        longest = int((rp[1:].clamp(max=key[0]) - rp[:-1].clamp(min=0)).max())
        ms = sum(by[key].values()) / steps
        total += ms
        split = ", ".join(f"{n} {v / steps:.4f}"
                          for n, v in sorted(by[key].items()))
        print(f"  {key} longest {longest}: "
              f"{calls.calls.count(key) / steps:g} calls/step, "
              f"{ms:.4f} ms/step ({split})")
    print(f"  all: {total:.4f} ms/step = {total / busy_ms:.3f} of the "
          f"device's busy time")


def spherenet_nk_force(dev, steps, pallas_fuse_basis=False):
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train import make_step_fns

    mols = synthetic_molecules(96 * (steps + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    it = iter(MoleculeLoader(mols, 96, shuffle=True, seed=0, device=dev))
    model = SphereNet(cutoff=5.0, num_layers=4, hidden_channels=128,
                      num_spherical=3, num_radial=6, nk_degree=16,
                      block_size=0, compute_dtype=torch.bfloat16,
                      pallas_triplet=True,
                      pallas_fuse_basis=pallas_fuse_basis, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, energy_and_force=True, p=100.0)
    return step, [next(it) for _ in range(steps)]


def dimenetpp_nk(dev, steps):
    from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
    from dig_tpu_torch.models import DimeNetPP
    from dig_tpu_torch.train import make_step_fns

    mols = synthetic_molecules(96 * (steps + 1), seed=0, min_atoms=12,
                               max_atoms=29, box=6.0, with_forces=True)
    mols = [dict(m, y=m["y"][:1]) for m in mols]
    it = iter(MoleculeLoader(mols, 96, shuffle=True, seed=0, device=dev))
    model = DimeNetPP(nk_degree=16, block_size=0, pallas_basis_grads=False,
                      pallas_triplet=True, compute_dtype=torch.bfloat16,
                      device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step, _ = make_step_fns(model, opt, p=100.0, loss="l1")
    return step, [next(it) for _ in range(steps)]


def spherenet_pt_force(dev, steps):
    return spherenet_nk_force(dev, steps, pallas_fuse_basis=True)


def trace(which, dev):
    """Warm up, then trace ``TRACED`` steps of path ``which`` on ``dev``:
    ``(wall_ms, busy_ms, kernels, prof, seg_calls)`` over the traced
    window (the profiler on)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from dig_tpu_torch.ops import segment_csr as sc
    smoke = _chip_smoke()
    train_step, batches = PATHS[which](dev, WARMUP + TRACED)
    for b in batches[:WARMUP]:
        train_step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            smoke.SegmentCalls(sc) as seg_calls:
        t0 = time.perf_counter()
        for b in batches[WARMUP:]:
            train_step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events without the user annotations (Optimizer.step spans
    # the optimizer's kernels and the gaps between them)
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return wall_ms, _busy_us(kernels) / 1e3, kernels, prof, seg_calls


def summary_line(which, wall_ms, busy_ms, kernels):
    return (f"{which}: {TRACED} traced steps: host {wall_ms / TRACED:.3f} "
            f"ms/step (profiler on), device busy {busy_ms / TRACED:.3f} "
            f"ms/step = {busy_ms / wall_ms:.3f} of the window, idle "
            f"{1 - busy_ms / wall_ms:.3f}; {len(kernels) / TRACED:.0f} "
            f"kernel launches/step")


PATHS = {"schnet_dense": schnet_dense, "spherenet": spherenet,
         "spherenet_force": spherenet_force, "schnet_force": schnet_force,
         "spherenet_flat": spherenet_flat,
         "spherenet_nk_force": spherenet_nk_force,
         "dimenetpp_nk": dimenetpp_nk,
         "spherenet_pt_force": spherenet_pt_force,
         "comenet_force": comenet_force,
         "comenet_ocp_force": comenet_ocp_force, "pronet": pronet,
         "lsgraph": lsgraph, "ssl": ssl, "ggraph": ggraph,
         "ggraph_gen": ggraph_gen, "gspherenet": gspherenet,
         "gspherenet_gen": gspherenet_gen, "graphair": graphair, "gp": gp}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="schnet_dense")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    which = a.path
    if which not in PATHS:
        sys.exit(f"unknown path {which!r}; one of {sorted(PATHS)}")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    wall_ms, busy_ms, kernels, prof, seg_calls = trace(which, dev)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total_kernel_ms = sum(t for t, _ in by_name.values())
    print(f"card: {card}")
    print(summary_line(which, wall_ms, busy_ms, kernels))
    print("device time by kernel:")
    for name, (t, c) in top[:25]:
        print(f"  {t / TRACED:8.3f} ms/step {t / total_kernel_ms:6.3f} "
              f"{c // TRACED:5d}x  {name[:90]}")
    print("the port's own kernels:")
    for name, (t, c) in top:
        if any(k in name for k in ("cfconv", "slot_", "segment_csr",
                                   "triplet_product", "triplet_pt",
                                   "sum_partials")):
            print(f"  {t / TRACED:8.3f} ms/step {t / total_kernel_ms:6.3f} "
                  f"{c // TRACED:5d}x  {name[:90]}")
    if seg_calls.calls:
        segment_report(seg_calls, kernels, TRACED, busy_ms / TRACED)
    print("host operators by self CPU time:")
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in ops[:20]:
        print(f"  {a.self_cpu_time_total / 1e3 / TRACED:8.3f} ms/step "
              f"{a.count // TRACED:5d}x  {a.key[:90]}")


if __name__ == "__main__":
    main()
