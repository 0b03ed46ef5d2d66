"""The FLOP counts, the frozen kernel bounds and the work the benchmark
counts, against a hand count at one tiny shape and the port's own
geometry."""
import math

import pytest
import torch

from portbench.bounds import cfconv, triplet_slot
from portbench.core import spec, traffic
from portbench.core.peaks import PEAK_BYTES, PEAK_FLOPS, SFU_OPS
from portbench.flops import schnet_dense_qm9 as fl_schnet
from portbench.flops import spherenet_qm9 as fl_sphere
from portbench.tests._tiny import shrink

CPU = torch.device("cpu")


def test_cfconv_bound_by_hand():
    # G=1, n=4, F=32, R=8, 6 pairs: forward FLOPs 2*6*32*40 + 3*6*32,
    # special functions 6*(8 + 64 + 1), bytes 64 + 512 + 5376 + 512
    flops = 2 * 6 * 32 * 40 + 3 * 6 * 32
    mufu = 6 * (8 + 64 + 1)
    nbytes = 4 * 4 * 4 + 4 * 32 * 4 + (8 * 32 + 32 + 32 * 32 + 32) * 4 \
        + 4 * 32 * 4
    want = max(flops / PEAK_FLOPS["f32"], mufu / SFU_OPS,
               nbytes / PEAK_BYTES) * 1e3
    assert cfconv.bound_ms(1, 4, 32, 8, 6, "f32", "fwd") == \
        pytest.approx(want, rel=1e-12)


def test_triplet_slot_bounds_by_hand():
    work = {"triplets": 10, "x_rows": 4, "tri_edges": 3}
    E, K, R, C, nk, ntk = 8, 2, 30, 64, 18, 54
    NB = nk + ntk
    inputs = 4 * C * 4 + 10 * R * 4 + K * E * 4 + E * 4 + NB * C * 4
    fwd = max(10 * (2 * C * NB + 3 * C + NB) / PEAK_FLOPS["f32"],
              (inputs + E * C * 4) / PEAK_BYTES) * 1e3
    assert triplet_slot.fwd_bwd_ms(E, K, R, C, nk, ntk, work, 4, "f32",
                                   "fwd") == pytest.approx(fwd, rel=1e-12)
    b2 = max(10 * (12 * C * NB + 18 * C + 8 * NB) / PEAK_FLOPS["f32"],
             (2 * 4 * C * 4 + 2 * 10 * R * 4 + 3 * C * 4 + K * E * 4
              + E * 4 + 2 * NB * C * 4 + 2 * E * C * 4 + K * R * E * 4)
             / PEAK_BYTES) * 1e3
    assert triplet_slot.bwd2_ms(E, K, R, C, nk, ntk, work, 4, "f32") == \
        pytest.approx(b2, rel=1e-12)


def _mol(pos):
    pos = torch.tensor(pos, dtype=torch.float32).numpy()
    return {"z": torch.ones(len(pos), dtype=torch.int32).numpy(), "pos": pos}


def test_schnet_flops_by_hand():
    # three atoms on a line 1 A apart, inside the cutoff: 6 directed pairs
    cfg = spec.config("schnet_dense_qm9")
    t = {"slots": {"16": 1}}
    w = fl_schnet.work(cfg, t, [_mol([[0, 0, 0], [1, 0, 0], [2, 0, 0]])],
                       CPU)
    assert w == {16: {"G": 1, "atoms": 3, "pairs": 6}}
    H, F, R, L = 128, 128, 50, 6
    fwd = L * (6 * (2 * F * (R + F) + 3 * F) + 3 * (4 * H * F + 2 * H * H)) \
        + 3 * (2 * H * 64 + 2 * 64)
    assert fl_schnet.step_flops(cfg, t, w) == 3 * fwd
    launches, ms = fl_schnet.kernel_calls(cfg, t, w)["cfconv"]
    assert launches == 12
    assert ms == pytest.approx(6 * (cfconv.bound_ms(1, 16, F, R, 6, "f32",
                                                    "fwd")
                                    + cfconv.bound_ms(1, 16, F, R, 6, "f32",
                                                      "bwd")))


def test_spherenet_work_by_hand():
    # an equilateral triangle of side 1: 6 edges, each j -> i with the one
    # k -> j, k != i: 6 triplets
    cfg = spec.config("spherenet_qm9")
    h = math.sqrt(3) / 2
    w = fl_sphere.work(cfg, {"slots": {"16": 1}},
                       [_mol([[0, 0, 0], [1, 0, 0], [0.5, h, 0]])], CPU)
    assert w == {16: {"G": 1, "atoms": 3, "edges": 6, "triplets": 6,
                      "x_rows": 6, "tri_edges": 6}}
    H, I, O, k, n = 128, 64, 256, 6, 3
    edge = (4 * H * H + 2 * k * 8 + 2 * 8 * H + H + 4 * H * I + 2 * H * H
            + 3 * 4 * H * H + 2 * k * H + 2 * H)
    trip = 2 * n * k * 8 + 2 * 8 * I + 2 * n * n * k * 8 + 2 * 8 * I + 3 * I
    fwd = (6 * (4 * k * H + 6 * H * H + H) + 4 * (6 * edge + 6 * trip)
           + 5 * (6 * H + 3 * (2 * H * O + 3 * 2 * O * O + 2 * O)))
    assert fl_sphere.step_flops(cfg, {"kind": "energy"}, w) == 3 * fwd
    assert fl_sphere.step_flops(cfg, {"kind": "energy_force"}, w) == 9 * fwd


@pytest.mark.parametrize("cell", ["spherenet_qm9.force_b384",
                                  "spherenet_qm9.energy_b384"])
def test_spherenet_work_matches_the_port(cell):
    from dig_tpu_torch.models import SphereNet

    from portbench.models import spherenet_qm9 as prog
    cfg = spec.config("spherenet_qm9")
    t = shrink(spec.traffic(spec.cell(cell)["traffic"]), 2)
    groups = traffic.groups(t, 11)
    pool = prog.pool(cfg, t, groups, CPU)
    model = SphereNet(**{k: cfg[k] for k in prog.MODEL_KEYS},
                      block_size=29, pallas_triplet=True,
                      pallas_fuse_basis=True, pallas_slot=True, device=CPU)
    w = fl_sphere.work(cfg, t, groups[0], CPU)
    batches = pool[0] if isinstance(pool[0], dict) else {29: pool[0]}
    K = cfg["nk_degree"]
    for s, g in batches.items():
        geo = model.geometry(g.nodes["pos"], g, s)
        _, m2t, lj = model.slot_operands(geo, s)
        real = m2t != 0
        e = torch.arange(m2t.shape[1])
        rows = ((e // (s * K)) * s + lj[0].long()) * K \
            + torch.arange(K)[:, None]
        assert w[s]["edges"] == int(geo.nkg.edge_mask.sum())
        assert w[s]["triplets"] == int(real.sum())
        assert w[s]["x_rows"] == int(torch.unique(rows[real]).numel())
        assert w[s]["tri_edges"] == int(real.any(0).sum())
