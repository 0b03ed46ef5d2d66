"""The chunked sorted-CSR segment-sum CUDA kernel vs its plain version, on
the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_segment_chunked_gpu.py

Inputs: sorted ids with empty rows, a skewed row (a third of the edges)
and a -1 padding tail, and path 7b's graph (synthetic_large_graph(60000,
seed=0, avg_deg=16), F = 128), each with the planner's own chunk table.
Against segment_sum_sorted_csr over a full window the sum is the same
bits: both add each row's edges in edge order. Against the plain version,
whose index_add_ adds with atomics in another order, the largest error
over the largest value is held to 1e-6 on path 7b's graph (at most 38
edges a row) and to 1e-5 on the small problem, whose skewed row sums
2,666 edges (the bound tests/test_torch_segment_csr_gpu.py holds the
segment sum to on the same problem), float32 and bf16 data
alike (both sides sum the same values in float32).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {"small": 1e-5, "path7b": 1e-6}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(seed=0, N=700, E_real=8000, E_pad=600):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(0, N, (E_real,), generator=g)
    rows = rows[(rows % 50) != 3]                  # empty rows 3, 53, ...
    rows[: E_real // 3] = 11                       # a skewed row
    seg = torch.sort(rows).values.to(torch.int32)
    rowptr = torch.searchsorted(seg, torch.arange(N + 1, dtype=torch.int32),
                                out_int32=True)
    seg = torch.cat([seg, torch.full((E_pad,), -1, dtype=torch.int32)])
    return seg, rowptr, N


def _path7b():
    from dig_tpu_torch.lsgraph import synthetic_large_graph
    N = 60000
    r = synthetic_large_graph(N, seed=0, avg_deg=16)["receivers"]
    seg = np.sort(r).astype(np.int32)
    rowptr = np.zeros(N + 1, np.int32)
    np.add.at(rowptr, seg + 1, 1)
    return torch.from_numpy(seg), torch.from_numpy(np.cumsum(rowptr)
                                                   .astype(np.int32)), N


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,F", [("small", 24), ("small", 128),
                                    ("path7b", 128)])
def test_chunked_kernel_matches_plain(case, F, dtype):
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    seg, rowptr, N = _small() if case == "small" else _path7b()
    BN, EB, meta, _ = sc.choose_chunk_plan(rowptr.numpy(), N, F, dtype)
    g = torch.Generator(device="cpu").manual_seed(1)
    data = torch.randn(seg.shape[0], F, generator=g).to(dev, dtype)
    seg, rowptr = seg.to(dev), rowptr.to(dev)
    meta = torch.from_numpy(meta).to(dev)
    before = sc.launches_chunked
    out = sc.segment_sum_sorted_csr_chunked(data, seg, meta, N, BN, EB)
    torch.cuda.synchronize()
    assert sc.launches_chunked == before + 1
    assert out.dtype == torch.float32 and out.shape == (N, F)
    want = sc.segment_sum_sorted_csr_chunked_reference(data, seg, meta, N,
                                                       BN, EB)
    assert _rel(out, want) < TOL[case]
    assert torch.equal(out, sc.segment_csr_launch(data, seg, rowptr, N))
    assert torch.equal(sc.segment_sum_sorted_csr_chunked(data, seg, meta, N,
                                                         BN, EB), out)


def test_chunked_vjp_and_spmm():
    """The VJP (a row gather, no kernel) against the plain one, and
    spmm_csr on path 7b's graph against x[col] * val summed by the plain
    segment sum."""
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    seg, rowptr, N = _small()
    BN, EB, meta, _ = sc.choose_chunk_plan(rowptr.numpy(), N, 32)
    g = torch.Generator(device="cpu").manual_seed(2)
    data = torch.randn(seg.shape[0], 32, generator=g).to(dev)
    cw = torch.randn(N, 32, generator=g).to(dev)
    seg, meta = seg.to(dev), torch.from_numpy(meta).to(dev)
    res = []
    for fn in (sc.segment_sum_sorted_csr_chunked,
               sc.segment_sum_sorted_csr_chunked_reference):
        d = data.clone().requires_grad_()
        (gd,) = torch.autograd.grad((fn(d, seg, meta, N, BN, EB) * cw).sum(),
                                    d)
        res.append(gd)
    assert _rel(res[0], res[1]) < TOL["path7b"]
    seg7, rowptr7, N7 = _path7b()
    E = seg7.shape[0]
    col = torch.randint(0, N7, (E,), generator=g, dtype=torch.int32).to(dev)
    val = torch.randn(E, generator=g).to(dev)
    x = torch.randn(N7, 64, generator=g).to(dev)
    seg7, rowptr7 = seg7.to(dev), rowptr7.to(dev)
    before = sc.launches
    got = sc.spmm_csr(rowptr7, col, val, x, N7,
                      max_edges_per_block=sc.full_window(E))
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    want = sc.segment_sum_sorted_csr_reference(x[col.long()] * val[:, None],
                                               seg7, rowptr7, N7)
    assert _rel(got, want) < 1e-5


def _structured(case, seed=3):
    """Sorted ids with a random in-degree of 0-8 per row and a tail of
    padding, shaped by ``case``: (seg, rowptr, N, BN, EB)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    N, BN, EB = {"ragged": (1000, 64, 128), "long_row": (700, 64, 128),
                 "holes": (900, 128, 256), "many_blocks": (20000, 64, 256),
                 "few_blocks": (1000, 256, 512)}[case]
    deg = torch.randint(0, 9, (N,), generator=g)
    if case == "long_row":
        deg[300] = 600                    # one row over five windows
    seg = torch.repeat_interleave(torch.arange(N), deg).to(torch.int32)
    rowptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.cumsum(deg, 0)]).to(torch.int32)
    tail = torch.full((300,), -1, dtype=torch.int32)
    if case == "holes":
        # -1 holes among the real ids (rowptr unchanged) and padding ids
        # at and past N in the tail: none of them adds
        seg[torch.rand(seg.shape[0], generator=g) < 0.1] = -1
        tail[::3] = N
        tail[1::3] = N + 17
    return torch.cat([seg, tail]), rowptr, N, BN, EB


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "long_row", "holes",
                                  "many_blocks", "few_blocks"])
def test_chunked_windows_and_ids(case, dtype):
    """Row blocks whose first window starts in the previous block's edges
    (128-aligned starts), a row over several windows, -1 holes and ids at
    or past N, N not a multiple of BN, more row blocks than SMs (313) and
    fewer (4): integer-valued data sums exactly in any order, so the kernel
    must give the plain version's bits and the segment sum's."""
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    seg, rowptr, N, BN, EB = _structured(case)
    meta = torch.from_numpy(sc.plan_chunks(rowptr.numpy(), N, BN, EB)).to(dev)
    g = torch.Generator(device="cpu").manual_seed(4)
    data = torch.randint(-8, 9, (seg.shape[0], 48), generator=g).to(dev, dtype)
    seg, rowptr = seg.to(dev), rowptr.to(dev)
    before = sc.launches_chunked
    out = sc.segment_sum_sorted_csr_chunked(data, seg, meta, N, BN, EB)
    torch.cuda.synchronize()
    assert sc.launches_chunked == before + 1
    want = sc.segment_sum_sorted_csr_chunked_reference(data, seg, meta, N,
                                                       BN, EB)
    assert float(want.abs().max()) > 0
    assert torch.equal(out, want)
    assert torch.equal(out, sc.segment_csr_launch(data, seg, rowptr, N))
    assert torch.equal(sc.segment_sum_sorted_csr_chunked(data, seg, meta, N,
                                                         BN, EB), out)
