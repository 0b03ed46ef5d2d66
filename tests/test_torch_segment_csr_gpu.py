"""The sorted-CSR segment-sum CUDA kernel vs its plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_segment_csr_gpu.py

Inputs: sorted ids with empty rows, a skewed degree (one row holds a third
of the edges) and a -1 padding tail. Tolerance: the largest error over the
largest reference value, 1e-5 in float32 and in bf16 (both sides sum the
same values in float32; only the order differs, the plain version's
``index_add_`` adding with atomics).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = 1e-5


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, dtype, F, N=700, E_real=8000, E_pad=600, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(0, N, (E_real,), generator=g)
    rows = rows[(rows % 50) != 3]                  # empty rows 3, 53, ...
    rows[: E_real // 3] = 11                       # a skewed row
    seg = torch.sort(rows).values.to(torch.int32)
    rowptr = torch.searchsorted(seg, torch.arange(N + 1, dtype=torch.int32),
                                out_int32=True)
    seg = torch.cat([seg, torch.full((E_pad,), -1, dtype=torch.int32)])
    data = torch.randn(seg.shape[0], F, generator=g)
    return data.to(dev, dtype), seg.to(dev), rowptr.to(dev), N


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


# the whole skewed row (2,666 edges) must fit one block's window
EB = 4096


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [24, 128])
def test_kernel_matches_plain_and_repeats_bitwise(F, dtype):
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    data, seg, rowptr, N = _problem(dev, dtype, F)
    before = sc.launches
    out = sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, EB)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    want = sc.segment_sum_sorted_csr_reference(data, seg, rowptr, N)
    assert out.dtype == torch.float32 and out.shape == (N, F)
    assert _rel(out, want) < TOL
    assert torch.all(out[3::50] == 0)               # empty rows: zeros
    again = sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, EB)
    assert torch.equal(again, out)


def test_unaligned_rows_take_the_scalar_path():
    """Rows that do not start on a 16-byte boundary (a view one float
    into its storage) give the same sums through the one-value loads."""
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    data, seg, rowptr, N = _problem(dev, torch.float32, 128, seed=1)
    buf = torch.empty(data.numel() + 1, device=dev)
    shifted = buf[1:].view_as(data)
    shifted.copy_(data)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    a = sc.segment_sum_sorted_csr(shifted, seg, rowptr, N, 32, EB)
    b = sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, EB)
    assert torch.equal(a, b)


def test_double_backward_on_the_card():
    """The closed pair to second order against autograd of a plain
    index_add_; the kernel runs in the forward and in the second pass."""
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    data, seg, rowptr, N = _problem(dev, torch.float32, 128, seed=2)
    g = torch.Generator(device="cpu").manual_seed(3)
    c = torch.randn(N, 128, generator=g).to(dev)
    v = torch.randn(*data.shape, generator=g).to(dev)

    def plain(d):
        keep = seg >= 0
        out = torch.zeros(N, d.shape[1], device=dev)
        return out.index_add_(0, torch.where(keep, seg, 0).long(),
                              torch.where(keep[:, None], d, 0.0))
    res = []
    for fn in (lambda d: sc.segment_sum_sorted_csr(d, seg, rowptr, N, 32,
                                                   EB), plain):
        d = data.clone().requires_grad_()
        before = sc.launches
        out = fn(d)
        (gd,) = torch.autograd.grad(torch.sum(c * out * out), d,
                                    create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(gd * v * d), d)
        res.append((gd.detach(), h, sc.launches - before))
    (g_k, h_k, n_k), (g_p, h_p, _) = res
    assert n_k == 2             # the forward and _RowGather's backward
    assert _rel(g_k, g_p) < 1e-5
    assert _rel(h_k, h_p) < 1e-4


def test_overflowing_cap_raises_without_fallback():
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    data, seg, rowptr, N = _problem(dev, torch.float32, 24)
    assert int(sc.csr_block_overflow(rowptr, N, 32, 1024)) > 0
    before = sc.launches
    with pytest.raises(RuntimeError, match="max_edges_per_block"):
        sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, 1024)
    assert sc.launches == before
