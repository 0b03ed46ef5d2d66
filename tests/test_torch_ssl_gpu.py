"""ssl and auggraph on the card: the encoders' kernel routes (the neighbour
sums through ``spmm_bidir_csr``, the poolings through ``readout_sum``:
the sorted-CSR kernel) against the same calls on the CPU (the plain
versions), and the bitwise repeat of a GraphCL training step.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_ssl_gpu.py

Batches of ``synthetic_graph_dataset`` (4 of 16 graphs padded) after a
view that drops nodes and adds edges into free slots, so the receivers
are unsorted and the masks ragged. Tolerances: float32, outputs 1e-5 of
the largest value and gradients 1e-4 (relative norm per parameter): the
same values summed in another order.
"""
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


def _batch():
    from dig_tpu_torch.datasets import GraphClsLoader, synthetic_graph_dataset
    from dig_tpu_torch.ssl import EdgePerturbation, SequentialView, UniformSample
    data = synthetic_graph_dataset(12, seed=0)
    g = next(iter(GraphClsLoader(data, 16)))
    view = SequentialView([EdgePerturbation(add=True, drop=True, ratio=0.3),
                           UniformSample(0.2)])
    return view(torch.Generator().manual_seed(0), g)


@pytest.mark.parametrize("kw", [dict(gnn="gin", bn=True, act="prelu"),
                                dict(gnn="gcn", pool="mean"),
                                dict(gnn="resgcn")])
def test_encoder_routes_against_the_cpu(kw):
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.ssl import Encoder
    dev = _device()
    g = _batch()
    outs = []
    for d in (dev, torch.device("cpu")):
        enc = Encoder(8, 64, 3, node_level=True, generator=torch.Generator()
                      .manual_seed(0), device=d, **kw)
        before = sc.launches
        zg, zn = enc(g.to(d))
        gen = torch.Generator().manual_seed(1)
        ctg = torch.randn(zg.shape, generator=gen).to(d)
        ctn = torch.randn(zn.shape, generator=gen).to(d)
        ((zg * ctg).sum() + (zn * ctn).sum()).backward()
        outs.append((zg, zn, [p.grad for p in enc.parameters()],
                     sc.launches - before))
    (zg, zn, gk, launches), (zg_c, zn_c, gc, _) = outs
    assert launches > 0
    assert _rel(zg, zg_c) < TOL and _rel(zn, zn_c) < TOL
    for a, b in zip(gk, gc):
        assert float((a.cpu() - b).norm() / b.norm().clamp(min=1e-12)) \
            < GRAD_TOL


def _graphcl_step(dev):
    from dig_tpu_torch.datasets import GraphClsLoader, synthetic_graph_dataset
    from dig_tpu_torch.ssl import Encoder, GraphCL
    data = synthetic_graph_dataset(64, seed=0)
    g = next(iter(GraphClsLoader(data, 32, shuffle=True))).to(dev)
    enc = Encoder(8, 64, 3, generator=torch.Generator().manual_seed(0),
                  device=dev)
    m = GraphCL(192, "dropN", "permE", 0.2)
    heads = m.make_heads(torch.Generator().manual_seed(m.seed), dev)
    opt = torch.optim.Adam(list(enc.parameters())
                           + list(heads["pg"].parameters()), lr=1e-3)
    step = m.make_step([enc, enc], heads, opt,
                       torch.Generator(device=dev).manual_seed(3))
    loss = step(g)
    return loss, [p.detach().clone() for p in enc.parameters()]


def test_graphcl_step_repeats_bit_for_bit():
    dev = _device()
    (la, pa), (lb, pb) = _graphcl_step(dev), _graphcl_step(dev)
    assert torch.isfinite(la)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
