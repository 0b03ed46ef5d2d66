"""The fused_triplet_product / fused_angle_product CUDA kernels vs their
plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_triplet_product_gpu.py

Tolerances, as the largest error over the largest reference value of each
tensor: 1e-4 in float32 (sums in another order); 1e-2 in bf16, where both
sides compute in float32 from the same bf16 operands and round each
output to bf16 once, so a sum in another order may land one bf16 step
(2^-8 of the value) away. Weight cotangents and ``ctb`` are summed in
float32 on both sides and held to 1e-4 in both types, before the cast to
bf16 (the raw kernel outputs).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (E, K, C, S1, S2): ragged and tiny, SphereNet's widths (S2 = 0: DimeNet++
# at n = 7, k = 6)
SHAPES = {"small": (37, 4, 32, 6, 10), "spherenet": (300, 16, 64, 18, 54),
          "dimenetpp": (300, 16, 64, 42, 0), "wide": (45, 8, 128, 18, 54)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, E, K, C, S1, S2, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    T = E * K
    d = {"xg": r(T, C), "sbf": r(T, S1), "tbf": r(T, S2) if S2 else None,
         "ws": r(S1, C) * S1 ** -0.5,
         "wt": r(S2, C) * S2 ** -0.5 if S2 else None,
         "m2d": (torch.rand(E, K, generator=g) < 0.4).float(),
         "ct": r(E, C)}
    us = [r(T, C), r(T, S1), r(T, S2) if S2 else None, r(S1, C),
          r(S2, C) if S2 else None]
    cast = lambda t, dt: None if t is None else t.to(dev, dt)
    d = {k: cast(v, torch.float32 if k in ("ws", "wt") else dtype)
         for k, v in d.items()}
    us = [cast(u, dtype if i < 3 else torch.float32) for i, u in enumerate(us)]
    return d, us, K


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _run(op, d, K, basis_grads, ct):
    """The op's output and the gradients of its differentiable inputs."""
    keys = [k for k in ("xg", "sbf", "tbf", "ws", "wt") if d[k] is not None]
    xs = {k: d[k].clone().requires_grad_() for k in keys}
    args = [xs.get(k, d[k]) for k in ("xg", "sbf", "tbf", "ws", "wt")]
    out = op.fused_triplet_product(*args, d["m2d"], K,
                                   basis_grads=basis_grads)
    return out, dict(zip(keys, torch.autograd.grad(out, list(xs.values()),
                                                   ct)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_and_backward_match_plain(shape, dtype):
    """Forward and first order with and without basis gradients: one
    launch each, the plain version's values, zero rows at masked triplets,
    the same bits on a repeated call."""
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    d, _, K = _inputs(dev, dtype, *SHAPES[shape])
    masked = d["m2d"].reshape(-1) == 0
    for basis in (True, False):
        before = op.launches_fwd, op.launches_bwd
        out_k, g_k = _run(op, d, K, basis, d["ct"])
        torch.cuda.synchronize()
        assert (op.launches_fwd, op.launches_bwd) == (before[0] + 1,
                                                      before[1] + 1)
        out_p = op.fused_triplet_product_reference(
            d["xg"], d["sbf"], d["tbf"], d["ws"], d["wt"], K, d["m2d"])
        assert out_k.dtype == dtype
        assert _rel(out_k, out_p) < TOL[dtype]
        want = op.fused_triplet_product_bwd_reference(
            d["xg"], d["sbf"], d["tbf"], d["ws"], d["wt"], d["m2d"], d["ct"],
            K, basis)
        for name, w in zip(("xg", "sbf", "tbf", "ws", "wt"), want):
            if w is None:
                continue
            a = g_k[name]
            assert a.dtype == w.dtype, name
            if name in ("sbf", "tbf") and not basis:
                assert float(a.abs().max()) == 0.0
                continue
            assert _rel(a, w) < TOL[dtype], name
            if a.shape[0] == masked.shape[0]:
                assert float(a[masked].abs().max()) == 0.0, name
        _, again = _run(op, d, K, basis, d["ct"])
        assert all(torch.equal(again[k], g_k[k]) for k in g_k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bwd2_kernel_matches_plain(shape, dtype):
    """The second-order kernel's six outputs against the plain version,
    with every cotangent present and with u4 = u5 absent (as in force
    training); masked rows exactly 0; two runs give the same bits."""
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    d, us, K = _inputs(dev, dtype, *SHAPES[shape])
    args = [d[k] for k in ("xg", "sbf", "tbf", "ws", "wt", "m2d")]
    k_args = op._kernel_inputs(*args, K)
    ct32 = d["ct"].float().contiguous()
    masked = d["m2d"].reshape(-1) == 0
    names = ["xb", "sb", "tb", "wsb", "wtb", "ctb"]
    for present in (us, us[:3] + [None, None]):
        before = op.launches_bwd2
        got = op.triplet_product_bwd2_kernel(*k_args, ct32, *present, K)
        torch.cuda.synchronize()
        assert op.launches_bwd2 == before + 1
        # the plain version in float32 from the same operands: the kernel's
        # weight and ct cotangents are float32 before any cast
        f = lambda t: None if t is None else t.float()
        want = op.fused_triplet_product_bwd2_reference(
            *(f(a) for a in args[:5]), d["m2d"], ct32, *present, K)
        for name, a, w in zip(names, got, want):
            assert (a is None) == (w is None), name
            if a is None:
                continue
            assert torch.isfinite(a).all(), name
            tol = TOL[dtype] if a.dtype == dtype != torch.float32 else 1e-4
            assert _rel(a, w) < tol, name
            if a.shape[0] == masked.shape[0]:
                assert float(a[masked].abs().max()) == 0.0, name
        again = op.triplet_product_bwd2_kernel(*k_args, ct32, *present, K)
        assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_double_backward_through_the_tower(dtype):
    """Reverse over reverse through fused_triplet_product, as force
    training runs it: one launch of each kernel, and the second-order
    gradients (ws and wt reached through the saved inputs) agree with
    autograd through the plain forward."""
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    d, us, K = _inputs(dev, dtype, *SHAPES["spherenet"])

    def second(fn):
        xs = [d[k].clone().requires_grad_() for k in ("xg", "sbf", "tbf",
                                                       "ws", "wt")]
        out = fn(*xs, d["m2d"])
        g = torch.autograd.grad(out, xs[:3], d["ct"], create_graph=True)
        loss = sum((gi.float() * u.float()).sum() for gi, u in zip(g, us))
        return torch.autograd.grad(loss, xs)

    before = (op.launches_fwd, op.launches_bwd, op.launches_bwd2)
    got = second(lambda *a: op.fused_triplet_product(*a, K))
    torch.cuda.synchronize()
    after = (op.launches_fwd, op.launches_bwd, op.launches_bwd2)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = second(lambda *a: op.fused_triplet_product_reference(
        *a[:5], K, a[5]))
    for name, a, b in zip(["xg", "sbf", "tbf", "ws", "wt"], got, want):
        assert a.dtype == b.dtype, name
        assert float(b.abs().max()) > 0, name
        assert _rel(a, b) < TOL[dtype], name


def test_cuda_input_without_kernel_shape_raises():
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    d, _, K = _inputs(dev, torch.float32, 5, 4, 160, 6, 10)
    with pytest.raises(ValueError, match="up to 128"):
        op.fused_triplet_product(d["xg"], d["sbf"], d["tbf"], d["ws"],
                                 d["wt"], d["m2d"], K)


# The backward lists each window's real triplets and walks them in batches
# of 64 (csrc/triplet_product.cu): (E, K, C, S1, S2, mask) for the cases the
# compacted walk and its register tiles make risky. mask: "empty" (the
# first 200 edges, whole windows, without a real triplet), "full" (every
# triplet real), "ragged" (67 real triplets: not a multiple of the batch or
# of a warp's 4 triplets), "random" (about 40% real); "many_windows" gives
# each block several windows, "straddle" (K = 12, all real) edges that
# straddle batches
COMPACT = {"empty_windows": (300, 16, 64, 18, 54, "empty"),
           "all_real": (300, 16, 64, 18, 54, "full"),
           "ragged": (37, 4, 64, 18, 54, "ragged"),
           "straddle": (300, 12, 64, 18, 54, "full"),
           "many_windows": (20000, 16, 64, 18, 54, "random"),
           "c32": (300, 16, 32, 18, 54, "random"),
           "c128": (300, 16, 128, 18, 54, "random"),
           "no_torsion": (300, 16, 64, 42, 0, "random")}


def _mask_as(m, how, seed=5):
    """Set the triplet mask m [E, K] in place as COMPACT's ``how`` says."""
    if how == "empty":
        m[:200] = 0
    elif how == "full":
        m.fill_(1)
    elif how == "ragged":
        m.zero_()
        g = torch.Generator(device="cpu").manual_seed(seed)
        m.view(-1)[torch.randperm(m.numel(), generator=g)[:67].to(m.device)] = 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_backward_compacted_walk(case, dtype):
    """The backward with basis gradients and without against the plain
    version: dxg, dsbf and dtbf rows exactly 0 at masked triplets, dxg,
    dws and dwt the same bits without basis gradients, three calls the
    same bits."""
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    E, K, C, S1, S2, how = COMPACT[case]
    d, _, K = _inputs(dev, dtype, E, K, C, S1, S2)
    _mask_as(d["m2d"], how)
    masked = d["m2d"].reshape(-1) == 0
    args = [d[k] for k in ("xg", "sbf", "tbf", "ws", "wt", "m2d")]
    k_args = op._kernel_inputs(*args, K)
    ct32 = d["ct"].float().contiguous()
    before = op.launches_bwd, op.launches_bwd_basis
    runs = [op.triplet_product_backward_kernel(*k_args, ct32, K, True)
            for _ in range(3)]
    no_basis = op.triplet_product_backward_kernel(*k_args, ct32, K, False)
    torch.cuda.synchronize()
    assert (op.launches_bwd, op.launches_bwd_basis) == (before[0] + 4,
                                                        before[1] + 3)
    for again in runs[1:]:
        assert all(a is None or torch.equal(a, b)
                   for a, b in zip(again, runs[0]))
    assert no_basis[1] is None and no_basis[2] is None
    for i in (0, 3, 4):
        assert (no_basis[i] is None) == (runs[0][i] is None)
        assert no_basis[i] is None or torch.equal(no_basis[i], runs[0][i])
    want = op.fused_triplet_product_bwd_reference(*args, d["ct"], K)
    for name, a, w in zip(("dxg", "dsbf", "dtbf", "dws", "dwt"), runs[0],
                          want):
        assert (a is None) == (w is None), name
        if a is None:
            continue
        assert torch.isfinite(a).all(), name
        tol = TOL[a.dtype] if name in ("dxg", "dsbf", "dtbf") else 1e-4
        assert _rel(a, w) < tol, name
        if a.shape[0] == masked.shape[0] and bool(masked.any()):
            assert float(a[masked].abs().max()) == 0.0, name


@pytest.mark.parametrize("u45", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_bwd2_compacted_walk(case, dtype, u45):
    """The second order (u1, u2, u3, and u4, u5 when ``u45``) against the
    plain version on the compacted walk's risky cases: xb, sb and tb rows
    exactly 0 at masked triplets, ctb 0 at edges without a real triplet,
    three calls the same bits."""
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    E, K, C, S1, S2, how = COMPACT[case]
    d, us, K = _inputs(dev, dtype, E, K, C, S1, S2)
    _mask_as(d["m2d"], how)
    present = us if u45 else us[:3] + [None, None]
    masked = d["m2d"].reshape(-1) == 0
    empty = (d["m2d"] == 0).all(1)
    args = [d[k] for k in ("xg", "sbf", "tbf", "ws", "wt", "m2d")]
    k_args = op._kernel_inputs(*args, K)
    ct32 = d["ct"].float().contiguous()
    before = op.launches_bwd2
    runs = [op.triplet_product_bwd2_kernel(*k_args, ct32, *present, K)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert op.launches_bwd2 == before + 3
    for again in runs[1:]:
        assert all(a is None or torch.equal(a, b)
                   for a, b in zip(again, runs[0]))
    f = lambda t: None if t is None else t.float()
    want = op.fused_triplet_product_bwd2_reference(
        *(f(a) for a in args[:5]), d["m2d"], ct32, *present, K)
    for name, a, w in zip(("xb", "sb", "tb", "wsb", "wtb", "ctb"), runs[0],
                          want):
        assert (a is None) == (w is None), name
        if a is None:
            continue
        assert torch.isfinite(a).all(), name
        tol = TOL[dtype] if a.dtype == dtype != torch.float32 else 1e-4
        assert _rel(a, w) < tol, name
        if name in ("xb", "sb", "tb") and bool(masked.any()):
            assert float(a[masked].abs().max()) == 0.0, name
        if name == "ctb" and bool(empty.any()):
            assert float(a[empty].abs().max()) == 0.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_forward_compacted_walk(case, dtype):
    """The forward lists each window's real triplets and walks them in
    batches of 64, an edge's sum carried across batches
    (csrc/triplet_product.cu): against the plain version on COMPACT's
    cases; out rows exactly 0 at edges without a real triplet, three calls
    the same bits."""
    from dig_tpu_torch.ops import triplet_product as op
    dev = _device()
    E, K, C, S1, S2, how = COMPACT[case]
    d, _, K = _inputs(dev, dtype, E, K, C, S1, S2)
    _mask_as(d["m2d"], how)
    empty = (d["m2d"] == 0).all(1)
    args = [d[k] for k in ("xg", "sbf", "tbf", "ws", "wt", "m2d")]
    k_args = op._kernel_inputs(*args, K)
    before = op.launches_fwd
    runs = [op.triplet_product_forward_kernel(*k_args, K) for _ in range(3)]
    torch.cuda.synchronize()
    assert op.launches_fwd == before + 3
    for again in runs[1:]:
        assert torch.equal(again, runs[0])
    out = runs[0]
    assert out.dtype == dtype and torch.isfinite(out).all()
    want = op.fused_triplet_product_reference(*args[:5], K, d["m2d"])
    assert _rel(out, want) < TOL[dtype]
    if bool(empty.any()):
        assert float(out[empty].abs().max()) == 0.0
