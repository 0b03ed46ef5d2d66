"""The fused_triplet_pt CUDA kernels vs their plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_triplet_pt_gpu.py

Both sides assemble the basis rows from the same ``pt`` values and round
them to ``pt``'s type, then compute in float32. Tolerances, as the largest
error over the largest reference value of each tensor: 1e-4 for float32
outputs (sums in another order: every output in float32, and the weight
and ``ct`` cotangents, which are float32 in both types); 1e-2 for bf16
outputs (out, dxg, dpt, xb, ptb), rounded to bf16 once, so a sum in
another order may land one bf16 step (2^-8 of the value) away.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (E, K, C, n, k, has_t): ragged and tiny, SphereNet's widths, DimeNet++'s
# published basis (n = 7, k = 6, no torsion), the widest C
SHAPES = {"small": (37, 4, 32, 3, 4, True),
          "spherenet": (300, 16, 64, 3, 6, True),
          "dimenetpp": (300, 16, 64, 7, 6, False),
          "wide": (45, 8, 128, 3, 6, True)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, E, K, C, n, k, has_t, seed=0):
    """Operands (xg, pt, ws, wt, m2), the output cotangent and the
    second-order cotangents (u1, u2, u4, u5); ws and wt float32."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    T, nk = E * K, n * k
    R = nk + n + (n * n if has_t else 0)
    ntk = n * nk if has_t else 1
    args = [r(T, C).to(dev, dtype), r(R, T).to(dev, dtype),
            (r(nk, C) * nk ** -0.5).to(dev),
            (r(ntk, C) * ntk ** -0.5 * has_t).to(dev),
            (torch.rand(E, K, generator=g) < 0.4).to(dev, dtype)]
    us = [r(T, C).to(dev, dtype), r(R, T).to(dev, dtype), r(nk, C).to(dev),
          r(ntk, C).to(dev)]
    return args, r(E, C).to(dev, dtype), us, K, (n, k, has_t)


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _masked_zero(name, a, masked):
    """Rows of xg-shaped, columns of pt-shaped tensors at masked triplets."""
    if a.shape[0] == masked.shape[0]:
        return float(a[masked].abs().max()) == 0.0
    if a.dim() == 2 and a.shape[1] == masked.shape[0]:
        return float(a[:, masked].abs().max()) == 0.0
    return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_and_backward_match_plain(shape, dtype):
    """Forward and first order with dpt asked for and not: one launch
    each, the plain version's values, zero rows and columns at masked
    triplets, the same bits on a repeated call."""
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    args, ct, _, K, cfg = _inputs(dev, dtype, *SHAPES[shape])
    masked = args[4].reshape(-1) == 0
    k_args = op._kernel_inputs(*args, K, cfg)
    before = op.launches_fwd
    out = op.triplet_pt_forward_kernel(*k_args, K, cfg)
    torch.cuda.synchronize()
    assert op.launches_fwd == before + 1 and out.dtype == dtype
    assert _rel(out, op.fused_triplet_pt_ref(*args, K, cfg)) < TOL[dtype]
    ct32 = ct.float().contiguous()
    want = op.fused_triplet_pt_bwd_ref(*args, ct, K, cfg)
    got = {}
    for need_dpt in (True, False):
        before = op.launches_bwd
        got[need_dpt] = op.triplet_pt_backward_kernel(*k_args, ct32, K, cfg,
                                                      need_dpt)
        torch.cuda.synchronize()
        assert op.launches_bwd == before + 1
    assert got[False][1] is None
    for name, a, w in zip(("dxg", "dpt", "dws", "dwt"), got[True], want):
        assert a.dtype == (torch.float32 if name in ("dws", "dwt")
                           else dtype), name
        assert torch.isfinite(a).all(), name
        tol = TOL[a.dtype]
        if name == "dwt" and not cfg[2]:
            assert float(a.abs().max()) == 0.0
            continue
        assert _rel(a, w) < tol, name
        assert _masked_zero(name, a, masked), name
    for i in (0, 2, 3):                  # the same without dpt
        assert torch.equal(got[False][i], got[True][i])
    again = op.triplet_pt_backward_kernel(*k_args, ct32, K, cfg, True)
    assert all(torch.equal(a, b) for a, b in zip(again, got[True]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bwd2_kernel_matches_plain(shape, dtype):
    """The second-order kernel's five outputs against the plain version,
    with every cotangent present and with u4 = u5 absent (as in force
    training); masked rows and columns exactly 0; two runs give the same
    bits."""
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    args, ct, us, K, cfg = _inputs(dev, dtype, *SHAPES[shape])
    masked = args[4].reshape(-1) == 0
    k_args = op._kernel_inputs(*args, K, cfg)
    ct32 = ct.float().contiguous()
    for present in (us, us[:2] + [None, None]):
        before = op.launches_bwd2
        got = op.triplet_pt_bwd2_kernel(*k_args, ct32, *present, K, cfg)
        torch.cuda.synchronize()
        assert op.launches_bwd2 == before + 1
        want = op.fused_triplet_pt_bwd2_ref(*args, ct, *present, K, cfg)
        for name, a, w in zip(("xb", "ptb", "wsb", "wtb", "ctb"), got, want):
            assert torch.isfinite(a).all(), name
            if name == "wtb" and not cfg[2]:
                assert float(a.abs().max()) == 0.0
                continue
            assert _rel(a, w) < TOL[a.dtype], name
            assert _masked_zero(name, a, masked), name
        again = op.triplet_pt_bwd2_kernel(*k_args, ct32, *present, K, cfg)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["spherenet", "dimenetpp"])
def test_double_backward_through_the_tower(shape, dtype):
    """Reverse over reverse through fused_triplet_pt, as force training
    runs it: one launch of each kernel, and the second-order gradients
    (ws and wt reached through the saved inputs) agree with autograd
    through the plain forward."""
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    args, ct, us, K, cfg = _inputs(dev, dtype, *SHAPES[shape])
    args[2], args[3] = args[2].to(dtype), args[3].to(dtype)
    live = 4 if cfg[2] else 3

    def second(fn):
        xs = [a.clone().requires_grad_() for a in args[:live]]
        rest = args[live:4] + [args[4]]
        out = fn(*xs, *rest)
        g = torch.autograd.grad(out, xs[:2], ct, create_graph=True)
        loss = sum((gi.float() * u.float()).sum() for gi, u in zip(g, us))
        return torch.autograd.grad(loss, xs)

    before = (op.launches_fwd, op.launches_bwd, op.launches_bwd2)
    got = second(lambda *a: op.fused_triplet_pt(*a, K, 128, cfg))
    torch.cuda.synchronize()
    after = (op.launches_fwd, op.launches_bwd, op.launches_bwd2)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = second(lambda *a: op.fused_triplet_pt_ref(*a, K, cfg))
    for name, a, b in zip(("xg", "pt", "ws", "wt"), got, want):
        assert a.dtype == b.dtype, name
        assert float(b.abs().max()) > 0, name
        assert _rel(a, b) < TOL[dtype], name


def test_cuda_input_without_kernel_shape_raises():
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    args, _, _, K, cfg = _inputs(dev, torch.float32, 5, 4, 160, 3, 4, True)
    with pytest.raises(ValueError, match="up to 128"):
        op.fused_triplet_pt(*args, K, 128, cfg)


# The backward lists each window's real triplets and walks them in batches
# of 64 (csrc/triplet_pt.cu): (E, K, C, n, k, has_t, mask) for the cases
# the compacted walk and its register tiles make risky. mask: "empty" (the
# first 200 edges, whole windows, without a real triplet), "full" (every
# triplet real), "ragged" (67 real triplets: not a multiple of the batch or
# of a warp's 4 triplets)
COMPACT = {"empty_windows": (300, 16, 64, 3, 6, True, "empty"),
           "all_real": (300, 16, 64, 3, 6, True, "full"),
           "ragged": (37, 4, 64, 3, 6, True, "ragged"),
           "c32": (300, 16, 32, 3, 6, True, "random"),
           "c128": (300, 16, 128, 3, 6, True, "random"),
           "no_torsion": (300, 16, 64, 7, 6, False, "random")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_backward_compacted_walk(case, dtype):
    """The backward with dpt asked for and not against the plain version:
    dxg rows and dpt columns exactly 0 at masked triplets, the other
    gradients the same bits without dpt, three calls the same bits."""
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    E, K, C, n, k, has_t, how = COMPACT[case]
    args, ct, _, K, cfg = _inputs(dev, dtype, E, K, C, n, k, has_t)
    m = args[4]
    if how == "empty":
        m[:200] = 0
    elif how == "full":
        m.fill_(1)
    elif how == "ragged":
        m.zero_()
        g = torch.Generator(device="cpu").manual_seed(5)
        m.view(-1)[torch.randperm(E * K, generator=g)[:67].to(dev)] = 1
    masked = m.reshape(-1) == 0
    k_args = op._kernel_inputs(*args, K, cfg)
    ct32 = ct.float().contiguous()
    runs = [op.triplet_pt_backward_kernel(*k_args, ct32, K, cfg, True)
            for _ in range(3)]
    no_dpt = op.triplet_pt_backward_kernel(*k_args, ct32, K, cfg, False)
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(again, runs[0]))
    assert no_dpt[1] is None
    for i in (0, 2, 3):
        assert torch.equal(no_dpt[i], runs[0][i])
    want = op.fused_triplet_pt_bwd_ref(*args, ct, K, cfg)
    for name, a, w in zip(("dxg", "dpt", "dws", "dwt"), runs[0], want):
        assert torch.isfinite(a).all(), name
        if name == "dwt" and not cfg[2]:
            continue
        assert _rel(a, w) < TOL[a.dtype], name
        assert not bool(masked.any()) or _masked_zero(name, a, masked), name


# The second order lists the real triplets of each window of whole edges
# and walks them in batches of 32 (csrc/triplet_pt.cu), summing ctb per
# edge across batches: COMPACT's cases, the cotangents of a force step and
# every other set, plus "straddle" (K = 12, all real: edges that straddle
# batches) and "many_windows" (several windows a block)
COMPACT2 = dict(COMPACT, straddle=(300, 12, 64, 3, 6, True, "full"),
                many_windows=(20000, 16, 64, 3, 6, True, "random"))
# which of (u1, u2, u4, u5) are present
U_SETS = {"all": (1, 1, 1, 1), "force_step": (1, 1, 0, 0),
          "no_u2": (1, 0, 1, 1), "u4_only": (0, 1, 1, 0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT2))
def test_bwd2_compacted_walk(case, dtype):
    """The second order under each set of cotangents against the plain
    version: xb rows and ptb columns exactly 0 at masked triplets, ctb rows
    exactly 0 at edges without a real triplet, three calls the same bits."""
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    E, K, C, n, k, has_t, how = COMPACT2[case]
    args, ct, us, K, cfg = _inputs(dev, dtype, E, K, C, n, k, has_t)
    m = args[4]
    if how == "empty":
        m[:200] = 0
    elif how == "full":
        m.fill_(1)
    elif how == "ragged":
        m.zero_()
        g = torch.Generator(device="cpu").manual_seed(5)
        m.view(-1)[torch.randperm(E * K, generator=g)[:67].to(dev)] = 1
    masked = m.reshape(-1) == 0
    empty_edges = (m == 0).all(dim=1)
    k_args = op._kernel_inputs(*args, K, cfg)
    ct32 = ct.float().contiguous()
    for label, present in U_SETS.items():
        uset = [u if f else None for u, f in zip(us, present)]
        before = op.launches_bwd2
        runs = [op.triplet_pt_bwd2_kernel(*k_args, ct32, *uset, K, cfg)
                for _ in range(3)]
        torch.cuda.synchronize()
        assert op.launches_bwd2 == before + 3, label
        for again in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(again, runs[0])), \
                label
        want = op.fused_triplet_pt_bwd2_ref(*args, ct, *uset, K, cfg)
        for name, a, w in zip(("xb", "ptb", "wsb", "wtb", "ctb"), runs[0],
                              want):
            assert torch.isfinite(a).all(), (label, name)
            if name == "wtb" and not cfg[2]:
                continue
            assert _rel(a, w) < TOL[a.dtype], (label, name)
            if bool(masked.any()):
                assert _masked_zero(name, a, masked), (label, name)
        if bool(empty_edges.any()):
            assert float(runs[0][4][empty_edges].abs().max()) == 0.0, label


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT2))
def test_forward_compacted_walk(case, dtype):
    """The forward lists each window's real triplets and walks them in
    batches of 64, an edge's sum carried across batches
    (csrc/triplet_pt.cu): against the plain version on COMPACT's cases,
    "straddle" and "many_windows"; out rows exactly 0 at edges without a
    real triplet, three calls the same bits."""
    from dig_tpu_torch.ops import triplet_pt as op
    dev = _device()
    E, K, C, n, k, has_t, how = COMPACT2[case]
    args, _, _, K, cfg = _inputs(dev, dtype, E, K, C, n, k, has_t)
    m = args[4]
    if how == "empty":
        m[:200] = 0
    elif how == "full":
        m.fill_(1)
    elif how == "ragged":
        m.zero_()
        g = torch.Generator(device="cpu").manual_seed(5)
        m.view(-1)[torch.randperm(E * K, generator=g)[:67].to(dev)] = 1
    empty_edges = (m == 0).all(dim=1)
    k_args = op._kernel_inputs(*args, K, cfg)
    before = op.launches_fwd
    runs = [op.triplet_pt_forward_kernel(*k_args, K, cfg) for _ in range(3)]
    torch.cuda.synchronize()
    assert op.launches_fwd == before + 3
    for again in runs[1:]:
        assert torch.equal(again, runs[0])
    out = runs[0]
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert _rel(out, op.fused_triplet_pt_ref(*args, K, cfg)) < TOL[dtype]
    if bool(empty_edges.any()):
        assert float(out[empty_edges].abs().max()) == 0.0
