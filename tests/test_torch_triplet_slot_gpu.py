"""The fused_triplet_slot CUDA kernels vs their plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_triplet_slot_gpu.py

Tolerances, as the largest error over the largest reference value of each
tensor: 1e-4 in float32 (sums in another order); 1e-2 in bf16, where the
output and the gradients are rounded to bf16 once at the end, so a sum in
another order may land one bf16 step (2^-8 of the value) away.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NAMES = ["dx", "dpt", "dws", "dwt"]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, A, K, G, C, n, k, has_t, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    E = G * A * K
    R = n * k + n + (n * n if has_t else 0)
    r = lambda *s: torch.randn(*s, generator=g)
    m2T = (torch.rand(K, E, generator=g) < 0.4).float()
    lj = torch.randint(0, A, (1, E), generator=g, dtype=torch.int32)
    args = [r(E, C), r(K, R, E), r(n * k, C) * 0.3,
            r(n * n * k if has_t else 1, C) * 0.3, m2T]
    args = [a.to(dev, dtype) for a in args] + [lj.to(dev)]
    return args, r(E, C).to(dev, dtype), (A, K, (n, k, has_t))


def _run(fn, args, ct, need_pt=True):
    xs = [a.clone().requires_grad_(i != 1 or need_pt)
          for i, a in enumerate(args[:4])]
    out = fn(*xs, *args[4:])
    want = [x for x in xs if x.requires_grad]
    # the plain version without torsion does not use wt: its gradient is 0
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(out, want, ct, allow_unused=True), want)]
    if not need_pt:
        grads.insert(1, None)
    return out, grads


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


SHAPES = {"small": (5, 4, 3, 32, 3, 2), "flagship": (29, 16, 96, 64, 3, 6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_t", [True, False])
@pytest.mark.parametrize("shape", ["small", "flagship"])
def test_kernel_matches_plain(shape, has_t, dtype):
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, (A, K, cfg) = _inputs(dev, dtype, *SHAPES[shape], has_t)
    kern = lambda *a: ts.fused_triplet_slot(*a, A, K, cfg)
    plain = lambda *a: ts.fused_triplet_slot_reference(*a, A, K, cfg)
    before = ts.launches_fwd, ts.launches_bwd
    out_k, g_k = _run(kern, args, ct)
    torch.cuda.synchronize()
    assert (ts.launches_fwd, ts.launches_bwd) == (before[0] + 1,
                                                  before[1] + 1)
    out_p, g_p = _run(plain, args, ct)
    assert out_k.dtype == dtype
    assert _rel(out_k, out_p) < TOL[dtype]
    for name, a, b in zip(NAMES, g_k, g_p):
        assert a.dtype == b.dtype
        assert _rel(a, b) < TOL[dtype], name
    # without dpt the other gradients are the same bits
    _, g_n = _run(kern, args, ct, need_pt=False)
    for name, a, b in zip(NAMES, g_n, g_k):
        if name != "dpt":
            assert torch.equal(a, b), name
    # two backwards give the same bits
    _, g_again = _run(kern, args, ct)
    assert all(torch.equal(a, b) for a, b in zip(g_again, g_k))


def test_cuda_input_without_kernel_shape_raises():
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, _, (A, K, cfg) = _inputs(dev, torch.float32, 5, 4, 3, 24, 3, 2,
                                   True)
    with pytest.raises(ValueError, match="C in"):
        ts.fused_triplet_slot(*args, A, K, cfg)
