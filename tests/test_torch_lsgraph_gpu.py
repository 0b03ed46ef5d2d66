"""lsgraph on the card: ``spmm_bidir_csr`` (the sorted-CSR kernel by
receiver forward and by sender in the adjoint) at a partitioned
subgraph's shape, the SELL ops on CUDA, and a ScalableGCN step through
the kernel, each against the same call on the CPU (the plain versions).

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_lsgraph_gpu.py

The subgraph: ``synthetic_large_graph(3000, avg_deg=16)`` in 8 parts, 2 a
batch: rows of Poisson-like degree, then a long run of degree-0 halo and
padding rows, padding edges last, F = 128. Tolerance: float32, 1e-5 of the
largest value (the same values summed in another order); the step's
gradients and pushed histories 1e-4 (relative norm per tensor: three
layers of such sums, forward and adjoint).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL, STEP_TOL = 1e-5, 1e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def _subgraphs():
    from dig_tpu_torch.lsgraph import (SubgraphLoader, metis_permute,
                                       synthetic_large_graph)
    g = synthetic_large_graph(3000, seed=0, avg_deg=16)
    s, r = g["senders"], g["receivers"]
    perm, ptr, _ = metis_permute(s, r, 3000, 8)
    return g, perm, list(SubgraphLoader(s, r, 3000, ptr, perm,
                                        batch_parts=2))


def test_spmm_bidir_csr_at_a_subgraph_shape():
    from dig_tpu_torch.ops import segment_csr as sc
    from dig_tpu_torch.ops.segment import spmm_bidir_csr
    dev = _device()
    _, _, subs = _subgraphs()
    sub = max(subs, key=lambda b: int(b.edge_mask.sum()))
    eb = sc.csr_window([sub.rowptr, sub.rowptr_rev], 64)
    N, E = len(sub.n_id), len(sub.senders)
    assert int(sub.edge_mask.sum()) < E and sub.batch_size < N / 2
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(N, 128, generator=gen)
    coef = torch.where(torch.tensor(sub.edge_mask),
                       torch.rand(E, generator=gen), 0.0)
    ct = torch.randn(N, 128, generator=gen)
    res = []
    for d in (dev, torch.device("cpu")):
        t = sub.tensors(d)
        hd = h.to(d).requires_grad_()
        before = sc.launches
        out = spmm_bidir_csr(hd, coef.to(d), t.senders, t.recv_ids, t.rowptr,
                             t.rev_perm, t.send_ids_sorted, t.rowptr_rev, N,
                             eb, 64)
        (g,) = torch.autograd.grad(out, hd, ct.to(d))
        res.append((out, g, sc.launches - before))
    (out, g, n_card), (want, want_g, n_cpu) = res
    assert (n_card, n_cpu) == (2, 0)
    assert _rel(out, want) < TOL
    assert _rel(g, want_g) < TOL
    # halo and padding rows receive nothing forward; the adjoint reaches
    # every sender, halo rows included
    assert float(out.detach()[sub.batch_size:].abs().max()) == 0.0
    senders = torch.tensor(np.unique(sub.senders[sub.edge_mask]))
    assert int(senders.max()) >= sub.batch_size
    assert float(g[senders.to(g.device)].abs().sum(1).min()) > 0


def test_sell_ops_on_cuda_match_cpu():
    from dig_tpu_torch.ops.segment import spmm_bidir_sell
    from dig_tpu_torch.ops.sell import (build_sell_plan, segment_sum_sell,
                                        spmm_sell)
    dev = _device()
    _, _, subs = _subgraphs()
    sub = subs[0]
    N, E = len(sub.n_id), len(sub.senders)
    n = int(sub.edge_mask.sum())
    gen = torch.Generator().manual_seed(1)
    data = torch.randn(n, 64, generator=gen)
    h = torch.randn(N, 64, generator=gen)
    coef = torch.where(torch.tensor(sub.edge_mask),
                       torch.rand(E, generator=gen), 0.0)
    ct = torch.randn(N, 64, generator=gen)
    res = []
    for d in (dev, torch.device("cpu")):
        plan = build_sell_plan(sub.rowptr, device=d)
        dd, hd = data.to(d).requires_grad_(), h.to(d).requires_grad_()
        a = segment_sum_sell(dd, plan, original_order=True)
        (ga,) = torch.autograd.grad(a, dd, ct.to(d))
        b = spmm_sell(torch.tensor(sub.senders[:n]).to(d), None, hd, plan)
        (gb,) = torch.autograd.grad(b, hd, ct.to(d))
        plans = sub.sell_plans(d)
        c = spmm_bidir_sell(hd, coef.to(d), sub.tensors(d).senders,
                            sub.tensors(d).recv_ids, *plans)
        (gc,) = torch.autograd.grad(c, hd, ct.to(d))
        res.append((a, ga, b, gb, c, gc))
    for x, y in zip(*res):
        assert x.is_cuda and not y.is_cuda
        assert _rel(x, y) < TOL


def test_scalable_gcn_step_through_the_kernel():
    """One GCN step (3 layers, hidden 128) on the card through the kernel
    (two launches a layer) against the same step on the CPU."""
    from dig_tpu_torch.lsgraph import ScalableGNN
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    g, perm, subs = _subgraphs()
    eb = sc.csr_window([rp for b in subs for rp in (b.rowptr, b.rowptr_rev)],
                       64)
    x, y = g["x"][perm], g["y"][perm]
    res = []
    for d in (dev, torch.device("cpu")):
        m = ScalableGNN("gcn", 3000, x.shape[1], 128, 8, 3, segment_eb=eb,
                        sell=False, device=d)
        xg, yg = torch.tensor(x).to(d), torch.tensor(y).to(d)
        hist = [type(h)(h.emb + 0.5) for h in m.histories]
        before = sc.launches
        out, new_h = m(hist, xg, subs[1])
        B = subs[1].batch_size
        t = subs[1].tensors(d)
        loss = torch.nn.functional.cross_entropy(out[:B], yg[t.n_id[:B]])
        loss.backward()
        res.append((float(loss.detach()), [p.grad for p in m.parameters()],
                    [h.emb for h in new_h], sc.launches - before))
    card, cpu = res
    assert (card[3], cpu[3]) == (6, 0)
    assert abs(card[0] - cpu[0]) < TOL * abs(cpu[0])
    for key in (1, 2):
        assert len(card[key]) == len(cpu[key]) > 0
        for a, b in zip(card[key], cpu[key]):
            a, b = a.double().cpu(), b.double().cpu()
            assert float((a - b).norm() / b.norm()) < STEP_TOL
