"""The parallel package on the card: the GP models' neighbour sums through
the sorted-CSR kernel against their plain versions, forward and backward
(the gradient reaching the per-edge factors: a GCN norm per edge, SchNet's
filters per edge and channel), and the engines at world size 1 in an NCCL
group against the CPU.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test). Run on a machine with the card, without the JAX
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py

Tolerances: float32, 1e-5 of the largest value for the sums and 1e-4 for
gradients and first steps (the same values summed in another order).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL, GRAD_TOL = 1e-5, 1e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def _graph(P, seed=0, N=600, E=6000):
    from dig_tpu_torch.parallel import prepare_gp_graph
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    x = rng.normal(size=(N, 8)).astype(np.float32)
    return prepare_gp_graph(s, r, N, P), x


@pytest.mark.parametrize("factor", ["none", "edge", "edge_channel"])
def test_gp_sums_kernel_vs_plain(factor):
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.parallel.gp import local_graph
    from dig_tpu_torch.parallel.gp_models import edge_sum
    dev = _device()
    (g, perm, H, C), _ = _graph(2)
    gen = torch.Generator().manual_seed(1)
    out = {}
    for d in (dev, torch.device("cpu")):
        gl = local_graph(g, 0, C, d)
        for name, es, rows in (("local", gl.plans.local, C),
                               ("halo", gl.plans.halo, H)):
            src = torch.randn(rows, 16, generator=gen.manual_seed(2)).to(d)
            src.requires_grad_()
            n = es.senders.shape[0]
            shape = {"none": None, "edge": (n,), "edge_channel": (n, 16)}
            scale = (None if shape[factor] is None else
                     torch.rand(shape[factor], generator=gen.manual_seed(3))
                     .to(d).requires_grad_())
            before = sc.launches
            y = edge_sum(src, es, scale)
            ct = torch.randn(y.shape, generator=gen.manual_seed(4)).to(d)
            grads = torch.autograd.grad(
                y, [src] + ([scale] if scale is not None else []), ct)
            out.setdefault(name, []).append(
                (y, grads, sc.launches - before))
    for name, ((yk, gk, nk), (yp, gp, _)) in out.items():
        assert nk == 2, (name, nk)   # the sum and the gather's adjoint
        assert _rel(yk, yp) < TOL, name
        for a, b in zip(gk, gp):
            assert _rel(a, b) < GRAD_TOL, name
        if factor != "none":
            assert float(gk[1].abs().max()) > 0     # reaches the factor


def test_engines_world_size_one_nccl(tmp_path):
    import torch.distributed as dist

    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.parallel import (init_local, make_gp_engine,
                                        make_mesh, slab_layout)
    from dig_tpu_torch.parallel.gp import local_graph, node_reg_loss
    from dig_tpu_torch.parallel.gp_models import GPGCN2, GPSchNet
    from dig_tpu_torch.train import collective_selfcheck
    dev = _device()
    init_local(0, 1, str(tmp_path / "store"), "nccl")
    try:
        assert collective_selfcheck(make_mesh((1, 1), ("data", "graph"))) \
            == {"data": 1, "graph": 1}
        mesh = make_mesh((1,), ("data",))
        (g, perm, H, C), x = _graph(1)
        N = x.shape[0]
        xs = slab_layout(x, perm, 1, C)
        ys = slab_layout(x[:, 0].copy(), perm, 1, C)
        ms = slab_layout(np.ones(N, bool), perm, 1, C)
        mk = lambda: GPGCN2(8, 32, 2, 2, generator=torch.Generator()
                            .manual_seed(0))
        card, cpu = mk().to(dev), mk()
        _, step, predict = make_gp_engine(
            mesh, card, torch.optim.SGD(card.parameters(), lr=0.0), H, C,
            loss_fn=node_reg_loss)
        before = sc.launches
        loss, out = step(g, xs, ys, ms)
        assert sc.launches - before == 4      # 2 a layer
        gl = local_graph(g, 0, C, torch.device("cpu"))
        o = cpu(torch.tensor(xs[0]), gl,
                lambda h: torch.zeros((H,) + h.shape[1:]))
        loc, cnt = node_reg_loss(o, torch.tensor(ys[0]),
                                 torch.tensor(ms[0]) & gl.node_mask)
        ref = loc / cnt
        ref.backward()
        ref = float(ref.detach())
        assert abs(float(loss) - ref) < GRAD_TOL * abs(ref)
        assert _rel(out, o) < GRAD_TOL
        for (n, a), b in zip(card.named_parameters(), cpu.parameters()):
            assert _rel(a.grad, b.grad) < GRAD_TOL, n
        assert _rel(predict(g, xs), o) < GRAD_TOL
        sch = GPSchNet(num_layers=2, generator=torch.Generator()
                       .manual_seed(0)).to(dev)
        z = np.random.default_rng(0).choice([1, 6, 8], N).astype(np.float32)
        xz = slab_layout(np.concatenate([z[:, None], x[:, :3] * 3], 1),
                         perm, 1, C)
        _, step, _ = make_gp_engine(
            mesh, sch, torch.optim.Adam(sch.parameters(), 1e-3), H, C,
            loss_fn=node_reg_loss)
        losses = [float(step(g, xz, ys, ms)[0]) for _ in range(4)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    finally:
        dist.destroy_process_group()
