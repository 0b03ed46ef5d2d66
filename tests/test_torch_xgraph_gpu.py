"""xgraph on the card: the explainers' differentiable neighbour sums (a
closed pair of row gathers and sorted-CSR sums: the kernel of
``csrc/segment_csr.cu``) against the same calls on the CPU (the plain
versions) to third order in the edge weights, and GNNExplainer's masks
repeated bit for bit.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_xgraph_gpu.py

Batches of ``synthetic_graph_dataset`` (6 graphs in 8 slots, so padding
rows, edges and graphs). Tolerances: float32, logits 1e-5 of the largest
value, derivatives 1e-4 and explainer masks 2e-4 (the JAX test's bound):
the same values summed in another order.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL, GRAD_TOL, MASK_TOL = 1e-5, 1e-4, 2e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def _batch(n=6, slots=8):
    from dig_tpu_torch.datasets import GraphClsLoader, synthetic_graph_dataset
    return next(iter(GraphClsLoader(synthetic_graph_dataset(n, seed=1),
                                    slots)))


def _derivs(model, g, u, v):
    """logits, d f / dw, its product with u (second order) and the third
    directional derivative along (u, v) of f = logits[1, 1] at w = 1."""
    w = torch.ones(g.num_edges, device=g.edge_mask.device,
                   requires_grad=True)
    logits = model(g, w)
    (g1,) = torch.autograd.grad(logits[1, 1], w, create_graph=True)
    (g2,) = torch.autograd.grad(g1 @ u, w, create_graph=True)
    (g3,) = torch.autograd.grad(g2 @ v, w)
    return logits, g1, g2, g3


@pytest.mark.parametrize("gnn", ["gcn", "gin"])
def test_conv_derivatives_against_the_cpu(gnn):
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.xgraph.models import GNNModel
    dev = _device()
    g = _batch()
    gen = torch.Generator().manual_seed(0)
    u = torch.randn(g.num_edges, generator=gen)
    v = torch.randn(g.num_edges, generator=gen)
    outs = []
    for d in (dev, torch.device("cpu")):
        m = GNNModel(gnn, 3, 32, 2, readout="sum").build(8, 0, d)
        sc.reset_launch_counts()
        outs.append(_derivs(m, g.to(d), u.to(d), v.to(d)))
        if d.type == "cuda":
            assert sc.launches > 0
    for k, (a, b) in enumerate(zip(*outs)):
        assert float(b.abs().max()) > 0, k
        assert _rel(a, b) < (TOL if k == 0 else GRAD_TOL), k


def test_gnnexplainer_masks_repeat_bit_for_bit():
    from dig_tpu_torch.datasets import GraphClsLoader, synthetic_graph_dataset
    from dig_tpu_torch.xgraph import GCN_2l, GNNExplainer
    dev = _device()
    data = synthetic_graph_dataset(4, seed=7)
    gs = list(GraphClsLoader(data, 1))         # one loader: the same pads
    labels = [int(d["y"]) for d in data]
    runs = []
    for d in (dev, dev, torch.device("cpu")):
        m = GCN_2l(dim_hidden=16).build(8, 0, d)
        ex = GNNExplainer(m, epochs=15, lr=0.05)
        runs.append(ex.explain_batch(gs, labels, seed=0))
    for (e1, f1), (e2, f2), (e3, f3) in zip(*runs):
        assert (e1 == e2).all() and (f1 == f2).all()
        fin = e3 > -1e30
        assert abs(e1[fin] - e3[fin]).max() <= MASK_TOL
        assert abs(f1 - f3).max() <= MASK_TOL
