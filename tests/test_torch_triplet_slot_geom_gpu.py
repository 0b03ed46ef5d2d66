"""The fused_triplet_slot_geom CUDA kernels vs their plain version, on the
card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_triplet_slot_geom_gpu.py

Inputs: random geometry (theta, phi, d_kj / cutoff down to 0.01, 0 at
masked triplets, as padding gives it) at a small shape and at path 7a's
(A = 29, K = 16, 96 slots, C = 64), n = 3, k = 6. Tolerances, as the
largest error over the largest reference value of each tensor: float32
1e-5 for the forward and the backward, 1e-4 for the second order (sums in
another order; both sides round the same float64 rows to float32); bf16
1e-2 (a sum in another order may land one bf16 step, 2^-8, away).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
NAMES = ["dx", "dgeo", "dws", "dwt"]
NAMES2 = ["xb", "geob", "wsb", "wtb", "ctb"]
SHAPES = {"small": (5, 4, 3, 32), "path7a": (29, 16, 96, 64)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, A, K, G, C, has_t, n=3, k=6, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    E = G * A * K
    r = lambda *s: torch.randn(*s, generator=g)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(K, E, generator=g)
    m2T = (torch.rand(K, E, generator=g) < 0.4).float()
    dk = torch.where(m2T != 0, u(0.01, 1.0), 0.0)
    geo = torch.stack([u(0.05, 3.1), u(-3.1, 3.1), dk] if has_t
                      else [u(0.05, 3.1), dk], 1)
    lj = torch.randint(0, A, (1, E), generator=g, dtype=torch.int32)
    args = [r(E, C).to(dev, dtype), geo.to(dev),
            (r(n * k, C) * 0.3).to(dev, dtype),
            (r(n * n * k if has_t else 1, C) * 0.3).to(dev, dtype),
            m2T.to(dev, dtype), lj.to(dev)]
    us = [r(E, C).to(dev, dtype), r(*geo.shape).to(dev), r(n * k, C).to(dev),
          r(n * n * k, C).to(dev) if has_t else None]
    return args, r(E, C).to(dev, dtype), us, (A, K, (n, k, has_t))


def _run(fn, args, ct, need_geo=True):
    xs = [a.clone().requires_grad_(i != 1 or need_geo)
          for i, a in enumerate(args[:4])]
    out = fn(*xs, *args[4:])
    want = [x for x in xs if x.requires_grad]
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(out, want, ct, allow_unused=True), want)]
    if not need_geo:
        grads.insert(1, None)
    return out, grads


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _masked(t, m2T):
    return float(t.abs().masked_fill((m2T != 0)[:, None, :], 0.0).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_t", [True, False])
@pytest.mark.parametrize("shape", ["small", "path7a"])
def test_forward_backward_match_plain(shape, has_t, dtype):
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, _, (A, K, cfg) = _inputs(dev, dtype, *SHAPES[shape], has_t)
    kern = lambda *a: ts.fused_triplet_slot_geom(*a, A, K, cfg)
    plain = lambda *a: ts.fused_triplet_slot_geom_reference(*a, A, K, cfg)
    before = ts.launches_geom_fwd, ts.launches_geom_bwd
    out_k, g_k = _run(kern, args, ct)
    torch.cuda.synchronize()
    assert (ts.launches_geom_fwd, ts.launches_geom_bwd) == (before[0] + 1,
                                                            before[1] + 1)
    out_p, g_p = _run(plain, args, ct)
    assert out_k.dtype == dtype
    assert _rel(out_k, out_p) < TOL[dtype][0]
    for name, a, b in zip(NAMES, g_k, g_p):
        if name == "dwt" and not has_t:
            continue
        assert a.dtype == b.dtype and torch.isfinite(a).all(), name
        assert _rel(a, b) < TOL[dtype][0], name
    assert _masked(g_k[1], args[4]) == 0.0
    _, g_n = _run(kern, args, ct, need_geo=False)
    for name, a, b in zip(NAMES, g_n, g_k):
        if name != "dgeo":
            assert torch.equal(a, b), name
    _, g_again = _run(kern, args, ct)
    assert all(torch.equal(a, b) for a, b in zip(g_again, g_k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_t", [True, False])
@pytest.mark.parametrize("shape", ["small", "path7a"])
def test_second_order_matches_plain(shape, has_t, dtype):
    """All five outputs, with u1 = u4 = u5 absent as in force training and
    with every cotangent present; geob 0 at masked triplets; two runs give
    the same bits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, us, (A, K, cfg) = _inputs(dev, dtype, *SHAPES[shape], has_t)
    k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    for present in ([None, us[1], None, None], us):
        before = ts.launches_geom_bwd2
        got = ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *present, A, K,
                                               cfg)
        torch.cuda.synchronize()
        assert ts.launches_geom_bwd2 == before + 1
        want = ts.fused_triplet_slot_geom_bwd2_reference(*args, ct, *present,
                                                         A, K, cfg)
        for name, a, b in zip(NAMES2, got, want):
            assert a.dtype == torch.float32 and a.shape == b.shape, name
            assert torch.isfinite(a).all(), name
            if name == "wtb" and not has_t:
                continue
            assert _rel(a, b) < TOL[dtype][1], name
        assert _masked(got[1], args[4]) == 0.0
        again = ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *present, A,
                                                 K, cfg)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_force_structure_through_the_tower(dtype):
    """The force-training structure at path 7a's shape: a loss on dgeo
    (as F = -dE/dpos puts one there) differentiated again through the
    tower, one launch of each kernel, against the plain double backward."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, us, (A, K, cfg) = _inputs(dev, dtype, *SHAPES["path7a"], True)

    def second(fn):
        xs = [a.clone().requires_grad_() for a in args[:4]]
        out = fn(*xs, *args[4:], A, K, cfg)
        (dgeo,) = torch.autograd.grad(out, [xs[1]], ct, create_graph=True)
        return torch.autograd.grad((dgeo * us[1]).sum(), xs)

    before = (ts.launches_geom_fwd, ts.launches_geom_bwd,
              ts.launches_geom_bwd2)
    got = second(ts.fused_triplet_slot_geom)
    torch.cuda.synchronize()
    after = (ts.launches_geom_fwd, ts.launches_geom_bwd,
             ts.launches_geom_bwd2)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = second(ts.fused_triplet_slot_geom_reference)
    for name, a, b in zip(["x", "geo", "ws", "wt"], got, want):
        assert a.dtype == b.dtype, name
        assert float(b.abs().max()) > 0, name
        assert _rel(a, b) < TOL[dtype][1], name


def test_channels_and_unsupported_width():
    """C = 128 runs; a width the kernels are not compiled for raises."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, _, _, (A, K, cfg) = _inputs(dev, torch.float32, 5, 4, 3, 128, True)
    out = ts.fused_triplet_slot_geom(*args, A, K, cfg)
    want = ts.fused_triplet_slot_geom_reference(*args, A, K, cfg)
    assert _rel(out, want) < TOL[torch.float32][0]
    args, _, _, (A, K, cfg) = _inputs(dev, torch.float32, 5, 4, 3, 24, True)
    with pytest.raises(ValueError, match="C in"):
        ts.fused_triplet_slot_geom(*args, A, K, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_second_order_repeatable_and_zero_at_masked(dtype):
    """Path 7a's shape with some senders outside the slot and every
    cotangent present: three calls give the same bits, geob is exactly 0
    at every masked triplet (m2T = 0 or lj outside [0, A)), and the outputs
    hold to the plain version."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, us, (A, K, cfg) = _inputs(dev, dtype, *SHAPES["path7a"], True)
    g = torch.Generator(device="cpu").manual_seed(3)
    lj = args[5].clone()
    out = torch.rand(lj.shape, generator=g).to(dev) < 0.1
    lj[out] = torch.where(torch.rand(lj.shape, generator=g).to(dev)[out]
                          < 0.5, -1, A + 2).to(lj.dtype)
    args = args[:5] + [lj]
    k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    runs = [ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *us, A, K, cfg)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(again, runs[0]))
    live = (args[4] != 0) & ((lj[0] >= 0) & (lj[0] < A))[None, :]
    geob = runs[0][1]
    assert float(geob.abs().masked_fill(live[:, None, :], 0.0).max()) == 0.0
    want = ts.fused_triplet_slot_geom_bwd2_reference(*args, ct, *us, A, K,
                                                     cfg)
    for name, a, b in zip(NAMES2, runs[0], want):
        assert _rel(a, b) < TOL[dtype][1], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_second_order_many_rows_few_channels(dtype):
    """C = 32 with more rows than the second order's product buffers hold
    twice over (n = 3, k = 27, no torsion: R = 84, 2 R > 5 C): write_ptb's
    ptb and dpt get room of their own. Against the plain version, geob 0 at
    masked triplets, the same bits on a second call."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, ct, us, (A, K, cfg) = _inputs(dev, dtype, *SHAPES["small"], False,
                                        n=3, k=27)
    k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    for present in ([None, us[1], None, None], us):
        got = ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *present, A, K,
                                               cfg)
        want = ts.fused_triplet_slot_geom_bwd2_reference(*args, ct, *present,
                                                         A, K, cfg)
        for name, a, b in zip(NAMES2, got, want):
            assert torch.isfinite(a).all(), name
            if name != "wtb":
                assert _rel(a, b) < TOL[dtype][1], name
        assert _masked(got[1], args[4]) == 0.0
        again = ts.triplet_slot_geom_bwd2_kernel(*k_args, ct32, *present, A,
                                                 K, cfg)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


# The backward lists each (slot, s) block's real triplets and walks them 32
# at a time, the rows' gradients across the block: (A, K, G, C, has_t,
# mask) for the cases the compacted walk and its register tiles make
# risky. mask: "empty" (slot 0 without a real triplet), "full" (every
# triplet real), "ragged" (37 real triplets in all), "out" (a tenth of the
# senders outside the slot)
COMPACT = {"empty_slot": (29, 16, 4, 64, True, "empty"),
           "all_real": (16, 16, 4, 64, True, "full"),
           "ragged": (24, 16, 4, 64, True, "ragged"),
           "c32": (29, 16, 4, 32, True, "out"),
           "c128": (29, 16, 4, 128, True, "out"),
           "no_torsion": (29, 16, 4, 64, False, "out")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_backward_compacted_walk(case, dtype):
    """The backward with dgeo asked for and not against the plain version:
    dgeo exactly 0 at every masked triplet (m2T = 0 or lj outside [0, A)),
    the other gradients the same bits without dgeo, three calls the same
    bits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    A, K, G, C, has_t, how = COMPACT[case]
    args, ct, _, (A, K, cfg) = _inputs(dev, dtype, A, K, G, C, has_t)
    geo, m2T, lj = args[1].clone(), args[4], args[5].clone()
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
    # real triplets keep d_kj / cutoff in [0.01, 1] (the Bessel rows' poles)
    geo[:, -1] = torch.where(m2T != 0, geo[:, -1].clamp_min(0.01), 0.0)
    args = [args[0], geo] + args[2:5] + [lj]
    k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
    ct32 = ct.float().contiguous()
    runs = [ts.triplet_slot_geom_backward_kernel(*k_args, ct32, A, K, cfg,
                                                 True) for _ in range(3)]
    no_dgeo = ts.triplet_slot_geom_backward_kernel(*k_args, ct32, A, K, cfg,
                                                   False)
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(again, runs[0]))
    assert no_dgeo[1] is None
    for i in (0, 2, 3):
        assert torch.equal(no_dgeo[i], runs[0][i])
    live = (m2T != 0) & ((lj[0] >= 0) & (lj[0] < A))[None, :]
    dgeo = runs[0][1]
    assert float(dgeo.abs().masked_fill(live[:, None, :], 0.0).max()) == 0.0
    want = ts.fused_triplet_slot_geom_bwd_reference(*args, ct, A, K, cfg)
    for name, a, b in zip(NAMES, runs[0], want):
        assert torch.isfinite(a).all(), name
        if name == "dwt" and not has_t:
            continue
        assert _rel(a.to(dtype), b.to(dtype)) < TOL[dtype][0], name


def _compact_inputs(dev, dtype, case):
    """The operands of a ``COMPACT`` case: (args, A, K, cfg)."""
    A, K, G, C, has_t, how = COMPACT[case]
    args, _, _, (A, K, cfg) = _inputs(dev, dtype, A, K, G, C, has_t)
    geo, m2T, lj = args[1].clone(), args[4], args[5].clone()
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
    # real triplets keep d_kj / cutoff in [0.01, 1] (the Bessel rows' poles)
    geo[:, -1] = torch.where(m2T != 0, geo[:, -1].clamp_min(0.01), 0.0)
    return [args[0], geo] + args[2:5] + [lj], A, K, cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(COMPACT))
def test_forward_compacted_walk(case, dtype):
    """The forward, which lists each 32-edge block's real triplets s-major
    and evaluates the rows only for those, against the plain version: out
    exactly 0 at every edge without a real triplet (m2T = 0 or lj outside
    [0, A) at every s), three calls the same bits."""
    from dig_tpu_torch.ops import triplet_slot as ts
    dev = _device()
    args, A, K, cfg = _compact_inputs(dev, dtype, case)
    k_args = ts._geom_kernel_inputs(*args, A, K, cfg)
    outs = [ts.triplet_slot_geom_forward_kernel(*k_args, A, K, cfg)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in outs[1:]:
        assert torch.equal(again, outs[0])
    m2T, lj = args[4], args[5]
    live = ((m2T != 0) & ((lj[0] >= 0) & (lj[0] < A))[None, :]).any(0)
    assert not outs[0][~live].float().any()
    want = ts.fused_triplet_slot_geom_reference(*args, A, K, cfg)
    assert outs[0].dtype == dtype and torch.isfinite(outs[0]).all()
    assert _rel(outs[0], want) < TOL[dtype][0]
