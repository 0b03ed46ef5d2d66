"""The fused_triplet_slot CUDA kernels vs their plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_triplet_slot_gpu.py

Tolerances, as the largest error over the largest reference value of each
tensor: 1e-4 in float32 (sums in another order); 1e-2 in bf16, where the
output and the gradients are rounded to bf16 once at the end, so a sum in
another order may land one bf16 step (2^-8 of the value) away. The
second-order kernel's own outputs are float32 in both types and are held
to 1e-4 (the bf16 operands are the same bf16 values on both sides; only
the order of the f32 sums differs).
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


NAMES2 = ["xb", "ptb", "wsb", "wtb", "ctb"]


def _cotangents(dev, dtype, args, seed=1):
    """Seeded cotangents (u1, u2, u4, u5) of (dx, dpt, dws, dwt)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*a.shape, generator=g).to(dev, dt)
            for a, dt in zip(args[:4], (dtype, dtype, torch.float32,
                                        torch.float32))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_t", [True, False])
@pytest.mark.parametrize("A", [16, 24, 29])
def test_bwd2_kernel_matches_plain(A, has_t, dtype):
    """At the force bench's slot sizes (K=16, C=64, n=3, k=6): all five
    outputs, with every cotangent present and with u4 = u5 = None as in
    force training; two runs give the same bits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, (A, K, cfg) = _inputs(dev, dtype, A, 16, 4, 64, 3, 6, has_t)
    us = _cotangents(dev, dtype, args)
    k_args = ts._kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    for present in (us, us[:2] + [None, None]):
        before = ts.launches_bwd2
        got = ts.triplet_slot_bwd2_kernel(*k_args, ct32, *present, A, K, cfg)
        torch.cuda.synchronize()
        assert ts.launches_bwd2 == before + 1
        want = ts.fused_triplet_slot_bwd2_reference(*args, ct, *present, A,
                                                    K, cfg)
        for name, a, b in zip(NAMES2, got, want):
            assert a.dtype == torch.float32 and a.shape == b.shape, name
            assert torch.isfinite(a).all(), name
            if name == "wtb" and not has_t:
                assert float(a.abs().max()) == 0.0
                continue
            assert _rel(a, b) < 1e-4, name
        again = ts.triplet_slot_bwd2_kernel(*k_args, ct32, *present, A, K,
                                            cfg)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_double_backward_through_the_tower(dtype):
    """Reverse over reverse through fused_triplet_slot, as force training
    runs it: one launch of each kernel, and the second-order gradients of
    x, pt, ws and wt (ws and wt reached through the saved inputs) agree
    with the plain version's double backward."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, (A, K, cfg) = _inputs(dev, dtype, 29, 16, 4, 64, 3, 6, True)
    w1, w2 = _cotangents(dev, dtype, args, seed=2)[:2]

    def second(fn):
        xs = [a.clone().requires_grad_() for a in args[:4]]
        out = fn(*xs, *args[4:], A, K, cfg)
        dx, dpt = torch.autograd.grad(out, xs[:2], ct, create_graph=True)
        loss = (dx.float() * w1.float()).sum() + (dpt.float()
                                                  * w2.float()).sum()
        return torch.autograd.grad(loss, xs)

    before = (ts.launches_fwd, ts.launches_bwd, ts.launches_bwd2)
    got = second(ts.fused_triplet_slot)
    torch.cuda.synchronize()
    after = (ts.launches_fwd, ts.launches_bwd, ts.launches_bwd2)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = second(ts.fused_triplet_slot_reference)
    for name, a, b in zip(["x", "pt", "ws", "wt"], got, want):
        assert a.dtype == b.dtype == dtype, name
        assert float(b.abs().max()) > 0, name
        assert _rel(a, b) < TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A", [16, 24, 29])
def test_bwd2_repeatable_and_zero_at_masked(A, dtype):
    """At the force bench's slot sizes, with torsion and every cotangent
    present, some senders outside the slot: three calls give the same bits,
    and ptb is exactly 0 at every masked triplet (m2T = 0 or lj outside
    [0, A)), whose rows the kernel never visits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, (A, K, cfg) = _inputs(dev, dtype, A, 16, 4, 64, 3, 6, True)
    g = torch.Generator(device="cpu").manual_seed(3)
    lj = args[5].clone()
    out = torch.rand(lj.shape, generator=g).to(dev) < 0.1
    lj[out] = torch.where(torch.rand(lj.shape, generator=g).to(dev)[out]
                          < 0.5, -1, A + 2).to(lj.dtype)
    args = args[:5] + [lj]
    us = _cotangents(dev, dtype, args)
    k_args = ts._kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    runs = [ts.triplet_slot_bwd2_kernel(*k_args, ct32, *us, A, K, cfg)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(again, runs[0]))
    live = (args[4] != 0) & ((lj[0] >= 0) & (lj[0] < A))[None, :]
    ptb = runs[0][1]
    assert float(ptb.abs().masked_fill(live[:, None, :], 0.0).max()) == 0.0
    assert float(ptb.abs().max()) > 0
    want = ts.fused_triplet_slot_bwd2_reference(*args, ct, *us, A, K, cfg)
    for name, a, b in zip(NAMES2, runs[0], want):
        assert _rel(a, b) < 1e-4, name


# The backward lists each (slot, s) block's real triplets and walks them 32
# at a time: (A, K, G, C, n, k, has_t, mask) for the cases the compacted
# walk and its register tiles make risky. mask: "empty" (slot 0 without a
# real triplet), "full" (every triplet real), "ragged" (37 real triplets
# in all: counts that are not multiples of 32), "out" (a tenth of the
# senders outside the slot)
COMPACT = {"empty_slot": (29, 16, 4, 64, 3, 6, True, "empty"),
           "all_real": (16, 16, 4, 64, 3, 6, True, "full"),
           "ragged": (24, 16, 4, 64, 3, 6, True, "ragged"),
           "c32": (29, 16, 4, 32, 3, 6, True, "out"),
           "c128": (29, 16, 4, 128, 3, 6, True, "out"),
           "no_torsion": (29, 16, 4, 64, 7, 6, False, "out")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_backward_compacted_walk(case, dtype):
    """The backward with dpt asked for and not against the plain version:
    dpt exactly 0 at every masked triplet (m2T = 0 or lj outside [0, A)),
    the other gradients the same bits without dpt, three calls the same
    bits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    A, K, G, C, n, k, has_t, how = COMPACT[case]
    args, ct, (A, K, cfg) = _inputs(dev, dtype, A, K, G, C, n, k, has_t)
    m2T, lj = args[4], args[5].clone()
    g = torch.Generator(device="cpu").manual_seed(5)
    if how == "empty":
        m2T[:, :A * K] = 0
    elif how == "full":
        m2T.fill_(1)
    elif how == "ragged":
        m2T.zero_()
        m2T.view(-1)[torch.randperm(m2T.numel(), generator=g)[:37].to(dev)] = 1
    elif how == "out":
        out = torch.rand(lj.shape, generator=g).to(dev) < 0.1
        lj[out] = torch.where(torch.rand(lj.shape, generator=g).to(dev)[out]
                              < 0.5, -1, A + 2).to(lj.dtype)
    args = args[:5] + [lj]
    k_args = ts._kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    runs = [ts.triplet_slot_backward_kernel(*k_args, ct32, A, K, cfg, True)
            for _ in range(3)]
    no_dpt = ts.triplet_slot_backward_kernel(*k_args, ct32, A, K, cfg, False)
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(again, runs[0]))
    assert no_dpt[1] is None
    for i in (0, 2, 3):
        assert torch.equal(no_dpt[i], runs[0][i])
    live = (m2T != 0) & ((lj[0] >= 0) & (lj[0] < A))[None, :]
    dpt = runs[0][1]
    assert float(dpt.abs().masked_fill(live[:, None, :], 0.0).max()) == 0.0
    want = ts.fused_triplet_slot_bwd_reference(*args, ct, A, K, cfg)
    for name, a, b in zip(NAMES, runs[0], want):
        assert torch.isfinite(a).all(), name
        if name == "dwt" and not has_t:
            continue
        assert _rel(a.to(dtype), b.to(dtype)) < TOL[dtype], name


def _compact_inputs(dev, dtype, case):
    """The operands of a ``COMPACT`` case: (args, A, K, cfg)."""
    A, K, G, C, n, k, has_t, how = COMPACT[case]
    args, _, (A, K, cfg) = _inputs(dev, dtype, A, K, G, C, n, k, has_t)
    m2T, lj = args[4], args[5].clone()
    g = torch.Generator(device="cpu").manual_seed(5)
    if how == "empty":
        m2T[:, :A * K] = 0
    elif how == "full":
        m2T.fill_(1)
    elif how == "ragged":
        m2T.zero_()
        m2T.view(-1)[torch.randperm(m2T.numel(), generator=g)[:37].to(dev)] = 1
    elif how == "out":
        out = torch.rand(lj.shape, generator=g).to(dev) < 0.1
        lj[out] = torch.where(torch.rand(lj.shape, generator=g).to(dev)[out]
                              < 0.5, -1, A + 2).to(lj.dtype)
    return args[:5] + [lj], A, K, cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_forward_compacted_walk(case, dtype):
    """The forward, which lists each 32-edge block's real triplets s-major
    and walks them 32 at a time, against the plain version: out exactly 0
    at every edge without a real triplet (m2T = 0 or lj outside [0, A) at
    every s), three calls the same bits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, A, K, cfg = _compact_inputs(dev, dtype, case)
    k_args = ts._kernel_inputs(*args, A, K, cfg)
    outs = [ts.triplet_slot_forward_kernel(*k_args, A, K, cfg)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in outs[1:]:
        assert torch.equal(again, outs[0])
    m2T, lj = args[4], args[5]
    live = ((m2T != 0) & ((lj[0] >= 0) & (lj[0] < A))[None, :]).any(0)
    assert not outs[0][~live].float().any()
    want = ts.fused_triplet_slot_reference(*args, A, K, cfg)
    assert outs[0].dtype == dtype and torch.isfinite(outs[0]).all()
    assert _rel(outs[0], want) < TOL[dtype]
