"""The sorted-CSR segment-sum CUDA kernel vs its plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_segment_csr_gpu.py

Inputs: sorted ids with empty rows, a skewed degree (one row holds a third
of the edges) and a -1 padding tail; and the shapes the card kernels'
slices make hard (``csrc/segment_csr.cu``: slices of 128 edges, more
below F = 8, a row whose range holds more summed in pieces): one row holding more than half
of 16,384 entries (a gather adjoint over a flat edge list padded with node
0) at F = 1, 3 and 128; rows straddling slice boundaries, long and short;
empty rows, -1 ids inside row ranges (a readout's padding rows) and a -1
tail; E shorter than one slice; more slices than the card holds blocks; a
view that is not 16-byte aligned.
Tolerance: the largest error over the largest reference value, 1e-5 in
float32 and in bf16 (both sides sum the same values in float32; only the
order differs, the plain version's ``index_add_`` adding with atomics).
Beside it, the exact bits of the design: a short row is the float32 sum of
its counted edges in edge order; a long row the sum, in slice order, of
its pieces, each the sum in warp order of 32-edge runs summed in edge
order (``design_sum``, numpy).
"""
import numpy as np
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
SLICE = 128       # csrc/segment_csr.cu's SLICE
PIECE_WARPS = 4   # and its piece-pass warps


def _slice(F):
    """csrc/segment_csr.cu's slice_edges(F)."""
    return SLICE * (8 // F if F < 8 else 1)


def _seq(vals):
    """The float32 sum of the rows of vals in order, from +0."""
    acc = np.zeros(vals.shape[1], np.float32)
    for v in vals:
        acc = acc + v
    return acc


def design_sum(data, seg, rowptr, N):
    """The card kernels' sum, bit for bit (numpy, float32): with slices of
    L = _slice(F) edges, a row whose range [a, b) holds at most L edges adds
    its counted edges in edge order; a longer row adds, in slice order, its
    piece of each slice it reaches, a piece being its counted edges' runs
    of L / 4 edges (one a warp) summed in edge order, then added in warp
    order."""
    x = data.float().cpu().numpy()
    sg, rp = seg.cpu().numpy(), rowptr.cpu().numpy().astype(np.int64)
    E, L = x.shape[0], _slice(x.shape[1])
    W = L // PIECE_WARPS
    out = np.zeros((N, x.shape[1]), np.float32)
    for r in range(N):
        a, b = max(rp[r], 0), min(rp[r + 1], E)
        if b <= a:
            continue
        if b - a <= L:
            out[r] = _seq(x[a:b][sg[a:b] == r])
            continue
        acc = np.zeros(x.shape[1], np.float32)
        for s in range(a // L, (b - 1) // L + 1):
            piece = np.zeros(x.shape[1], np.float32)
            for w in range(PIECE_WARPS):
                lo = max(a, s * L + W * w)
                hi = min(b, s * L + W * w + W)
                if hi > lo:
                    piece = piece + _seq(x[lo:hi][sg[lo:hi] == r])
            acc = acc + piece
        out[r] = acc
    return torch.from_numpy(out)


def _padded_gather(dev, dtype, F, N=696, E=16384, real=7126, seed=0):
    """The ids gather_rows sorts out of a flat edge list of E entries,
    real ones random over N nodes and the rest node 0 (row 0 holds more
    than half)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.cat([torch.randint(0, N, (real,), generator=g),
                     torch.zeros(E - real, dtype=torch.int64)])
    seg = torch.sort(idx).values.to(torch.int32)
    rowptr = torch.searchsorted(seg, torch.arange(N + 1, dtype=torch.int32),
                                out_int32=True)
    data = torch.randn(E, F, generator=g)
    return data.to(dev, dtype), seg.to(dev), rowptr.to(dev), N


def _straddling(dev, dtype, F, seed=0):
    """Row lengths that put rows across slice boundaries: long ones (129-
    1,100) and short ones (1-128) cut by a boundary, empty rows, -1 ids
    inside two row ranges and a -1 tail."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = [300, 100, 257, 256, 255, 0, 600, 1, 0, 513, 37, 1100, 200,
               0, 31, 250, 6, 127, 128, 129, 64, 90]
    seg = torch.cat([torch.full((n,), r, dtype=torch.int32)
                     for r, n in enumerate(lengths)])
    rowptr = torch.tensor([0] + list(np.cumsum(lengths)), dtype=torch.int32)
    seg[rowptr[6] + 100:rowptr[6] + 140] = -1     # padding inside row 6
    seg[rowptr[15] + 10:rowptr[15] + 12] = -1     # and inside row 15
    seg = torch.cat([seg, torch.full((300,), -1, dtype=torch.int32)])
    data = torch.randn(seg.shape[0], F, generator=g)
    return data.to(dev, dtype), seg.to(dev), rowptr.to(dev), len(lengths)


def _short(dev, dtype, F, seed=0):
    """E = 120 edges, shorter than one slice, over 50 rows with empty ones
    and a -1 tail."""
    data, seg, rowptr, N = _problem(dev, dtype, F, N=50, E_real=100,
                                    E_pad=20, seed=seed)
    assert seg.shape[0] < _slice(F)
    return data, seg, rowptr, N


def _large(dev, dtype, F, N=20000, seed=0):
    """About 330,000 edges, more slices than the card holds blocks of the
    piece pass (which then checks a slice by its end edges first): 300,000
    random ids, a row of 20,000 entries with -1 ids inside its range, one
    of 3,000, and a -1 tail."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.cat([torch.randint(0, N, (300000,), generator=g),
                      torch.full((20000,), 777), torch.full((3000,), 5)])
    seg = torch.sort(rows).values.to(torch.int32)
    rowptr = torch.searchsorted(seg, torch.arange(N + 1, dtype=torch.int32),
                                out_int32=True)
    seg[rowptr[777] + 500:rowptr[777] + 700] = -1
    seg = torch.cat([seg, torch.full((5000,), -1, dtype=torch.int32)])
    data = torch.randn(seg.shape[0], F, generator=g)
    return data.to(dev, dtype), seg.to(dev), rowptr.to(dev), N


PROBLEMS = {"padded_row_0": _padded_gather, "straddling": _straddling,
            "short": _short, "skewed": _problem, "large": _large}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3, 24, 128])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_slices_match_plain_and_the_design_bits(problem, F, dtype):
    """Every problem at the main paths' widths: against the plain version
    at TOL, the design's exact bits (design_sum), one launch a call, and a
    repeated call the same bits."""
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    data, seg, rowptr, N = PROBLEMS[problem](dev, dtype, F)
    assert sc.slice_edges(F) == _slice(F)
    window = sc.full_window(seg.shape[0])
    before = sc.launches
    out = sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, window)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (N, F)
    want = sc.segment_sum_sorted_csr_reference(data, seg, rowptr, N)
    assert _rel(out, want) < TOL
    assert torch.equal(out.cpu(), design_sum(data, seg, rowptr, N))
    again = sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, window)
    assert torch.equal(again, out)


@pytest.mark.parametrize("F", [3, 24, 128])
@pytest.mark.parametrize("problem", ["padded_row_0", "straddling"])
def test_unaligned_view_gives_the_aligned_bits(problem, F):
    """A view one float into its storage takes the one-value loads; its
    sums are the same bits, long rows' pieces too."""
    from dig_tpu_torch.ops import segment_csr as sc
    dev = _device()
    data, seg, rowptr, N = PROBLEMS[problem](dev, torch.float32, F)
    buf = torch.empty(data.numel() + 1, device=dev)
    shifted = buf[1:].view_as(data)
    shifted.copy_(data)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    window = sc.full_window(seg.shape[0])
    a = sc.segment_sum_sorted_csr(shifted, seg, rowptr, N, 32, window)
    b = sc.segment_sum_sorted_csr(data, seg, rowptr, N, 32, window)
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
