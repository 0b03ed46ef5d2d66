"""GraphDF on the card at the published QM9 width (BASELINE.md row 13:
max_size 20, edge_unroll 12, 12 flow layers, RGCN 128 x 3, batch 32)
against the same calls on the CPU: the first training step from the same
seeded weights (the discrete latents z exactly, the loss 1e-6 relative:
its sums run in another order; every gradient 1e-4 relative norm, the
straight-through softmax at temperature 0.1 through 12 layers; the running
statistics 1e-5), and ``run_rand_gen`` of 48 molecules from the same
weights and seed (the same canonical hashes in order, the same first-try
flags). Path 12 of chip_smoke.py runs the same checks after training.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test). Run on a machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_ggraph_gpu.py
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

CONF = dict(max_size=20, edge_unroll=12, node_dim=4, bond_dim=4,
            num_flow_layer=12, num_rgcn_layer=3, nhid=128, nout=128)
LOSS_TOL, GRAD_TOL, STATS_TOL = 1e-6, 1e-4, 1e-5


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch():
    from dig_tpu_torch.ggraph import DenseMolLoader, synthetic_smiles_dataset
    ds = synthetic_smiles_dataset(max_size=20, repeat=8)
    return next(iter(DenseMolLoader(ds, 32, shuffle=True)))


def _model(d):
    from dig_tpu_torch.ggraph.models import GraphFlowModelDF
    return GraphFlowModelDF(**CONF, generator=torch.Generator()
                            .manual_seed(0)).to(d)


def _rel_norm(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-12))


def test_first_step_against_the_cpu():
    dev = _device()
    b = _batch()
    runs = []
    for d in (dev, torch.device("cpu")):
        m = _model(d).train()
        z = m(torch.from_numpy(b["x"]).to(d), torch.from_numpy(b["adj"]).to(d))
        loss = m.dis_log_prob(z)
        loss.backward()
        runs.append((z, loss, dict(m.named_parameters()), m.flow_core.bn))
    (zk, lk, pk, bk), (zc, lc, pc, bc) = runs
    for a, c in zip(zk, zc):
        assert torch.equal(a.detach().cpu(), c.detach())
    lk, lc = lk.detach().cpu(), lc.detach()
    assert float((lk - lc).abs() / lc.abs()) < LOSS_TOL
    for n, p in pc.items():
        assert _rel_norm(pk[n].grad, p.grad) < GRAD_TOL, n
    for name in ("mean", "var"):
        assert _rel_norm(getattr(bk, name), getattr(bc, name)) < STATS_TOL


def test_generation_against_the_cpu():
    from dig_tpu_torch.chem import canonical_hash
    from dig_tpu_torch.ggraph import GraphDF
    dev = _device()
    state = _model("cpu").state_dict()
    out = []
    for d in (dev, "cpu"):
        g = GraphDF()
        g.get_model("rand_gen", CONF, state, device=d)
        mols, pure = g.run_rand_gen(n_mols=48, temperature=(0.35, 0.23),
                                    seed=1)
        out.append(([canonical_hash(m) for m in mols], pure))
    assert out[0] == out[1]
