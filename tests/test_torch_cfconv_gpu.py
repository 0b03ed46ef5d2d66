"""The cfconv CUDA kernels vs their plain version, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, so every worker collects the same tests). Run on a
machine with the card, without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cfconv_gpu.py

Tolerances, as the largest error over the largest reference value of each
tensor: 1e-4 in "f32" (sums in another order), 2e-2 in "bf16" (a value on
a bf16 rounding tie may round the other way in one of the two).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {"f32": 1e-4, "bf16": 2e-2}
NAMES = ["dist", "vj", "w1", "b1", "w2", "b2"]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, G, n, F, R, cutoff, seed=0):
    from dig_tpu_torch.ops.cfconv import MASK_DIST
    g = torch.Generator(device="cpu").manual_seed(seed)
    pos = torch.rand(G, n, 3, generator=g) * 6.0 - 3.0
    dist = torch.cdist(pos, pos)
    drop = torch.rand(G, n, n, generator=g) < 0.1
    dist = torch.where(torch.eye(n, dtype=torch.bool) | drop, MASK_DIST,
                       dist)
    args = [dist, torch.randn(G, n, F, generator=g),
            torch.randn(R, F, generator=g) * 0.2,
            torch.randn(F, generator=g) * 0.1,
            torch.randn(F, F, generator=g) * F ** -0.5,
            torch.randn(F, generator=g) * 0.1]
    return [a.to(dev) for a in args], torch.randn(G, n, F, generator=g).to(dev)


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _run(fn, args, g_out):
    xs = [a.clone().requires_grad_() for a in args]
    out = fn(xs)
    return out, torch.autograd.grad(out, xs, g_out)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
# n=40: a row has more in-cutoff pairs than one 32-pair chunk
@pytest.mark.parametrize("F,n", [(32, 16), (128, 32), (64, 24), (64, 40)])
def test_kernel_matches_plain(precision, F, n):
    from dig_tpu_torch.ops import cfconv as cf
    dev = _device()
    R, cutoff = 50 if F == 128 else 12, 5.0
    args, g_out = _inputs(dev, 7, n, F, R, cutoff)
    kern = lambda xs: cf.cfconv_fused(*xs, cutoff, R, precision)
    plain = lambda xs: cf.cfconv_reference(*xs, cutoff=cutoff,
                                           num_gaussians=R,
                                           precision=precision)
    out_k, g_k = _run(kern, args, g_out)
    out_p, g_p = _run(plain, args, g_out)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) < TOL[precision]
    for name, a, b in zip(NAMES, g_k, g_p):
        assert _rel(a, b) < TOL[precision], name


# The backward lists each slot's in-cutoff pairs and walks them 64 a tile
# across rows: (G, n, F, R, how) for the cases that make it risky. how:
# "empty" (slot 1 has no in-cutoff pair), "full" (every pair of every slot,
# the diagonal too, in cutoff: n^2 pairs, several tiles a slot), "random"
# (cdist of random points with 10% dropped). G = 3 is below the SM count,
# G = 300 above it (blocks take several slots); n = 40 rows hold more
# in-cutoff pairs than 32.
WALK = {"empty_slot": (5, 24, 64, 50, "empty"),
        "full_slots": (4, 32, 128, 50, "full"),
        "n40_f128": (6, 40, 128, 50, "random"),
        "n40_f32": (6, 40, 32, 12, "random"),
        "few_slots": (3, 16, 64, 24, "random"),
        "many_slots_f32": (300, 16, 32, 12, "random"),
        "many_slots_f128": (300, 24, 128, 50, "random")}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(WALK))
def test_pair_list_walk(case, precision):
    """The backward on the pair-list walk's risky cases, need_dist_grad
    on and off: the plain version's gradients, three calls the same bits,
    need_dist_grad=False the same bits in every other gradient and zeros
    in d_dist."""
    from dig_tpu_torch.ops import cfconv as cf
    from dig_tpu_torch.ops.cfconv import MASK_DIST
    dev = _device()
    G, n, F, R, how = WALK[case]
    args, g_out = _inputs(dev, G, n, F, R, 5.0)
    if how == "empty":
        args[0][1] = MASK_DIST
    elif how == "full":
        args[0] = torch.rand(G, n, n, generator=torch.Generator().manual_seed(3)
                             ).to(dev) * 4.9
    k_args = cf._kernel_inputs(*args)
    g32 = g_out.float().contiguous()
    runs = {flag: [cf.cfconv_backward_kernel(*k_args, g32, 5.0, R, precision,
                                             flag) for _ in range(3)]
            for flag in (True, False)}
    torch.cuda.synchronize()
    for flag, rs in runs.items():
        for again in rs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(again, rs[0])), flag
    on, off = runs[True][0], runs[False][0]
    assert float(off[0].abs().max()) == 0.0
    for name, a, b in zip(NAMES[1:], on[1:], off[1:]):
        assert torch.equal(a, b), name
    _, g_p = _run(lambda xs: cf.cfconv_reference(
        *xs, cutoff=5.0, num_gaussians=R, precision=precision), args, g_out)
    for name, a, b in zip(NAMES, on, g_p):
        assert _rel(a, b) < TOL[precision], name
    if how == "empty":
        assert float(on[0][1].abs().max()) == 0.0
        assert float(on[1][1].abs().max()) == 0.0


def _walk_inputs(dev, case):
    """The inputs of a ``WALK`` case: (args, R, how)."""
    from dig_tpu_torch.ops.cfconv import MASK_DIST
    G, n, F, R, how = WALK[case]
    args, _ = _inputs(dev, G, n, F, R, 5.0)
    if how == "empty":
        args[0][1] = MASK_DIST
    elif how == "full":
        args[0] = torch.rand(G, n, n, generator=torch.Generator().manual_seed(3)
                             ).to(dev) * 4.9
    return args, R, how


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(WALK))
def test_forward_pair_list_walk(case, precision):
    """The forward on the pair-list walk's risky cases (it lists a slot's
    in-cutoff pairs in (i, j) order and walks them 64 a tile across rows):
    the plain version's output, three calls the same bits, the rows of an
    empty slot exactly 0."""
    from dig_tpu_torch.ops import cfconv as cf
    dev = _device()
    args, R, how = _walk_inputs(dev, case)
    k_args = cf._kernel_inputs(*args)
    outs = [cf.cfconv_forward_kernel(*k_args, 5.0, R, precision)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in outs[1:]:
        assert torch.equal(again, outs[0])
    want = cf.cfconv_reference(*args, cutoff=5.0, num_gaussians=R,
                               precision=precision)
    assert torch.isfinite(outs[0]).all()
    assert _rel(outs[0], want) < TOL[precision]
    if how == "empty":
        assert float(outs[0][1].abs().max()) == 0.0


def test_need_dist_grad_false_and_bitwise_repeat():
    from dig_tpu_torch.ops import cfconv as cf
    dev = _device()
    args, g_out = _inputs(dev, 9, 24, 128, 50, 5.0, seed=1)
    runs = {}
    for flag in (True, False, False):
        _, grads = _run(lambda xs: cf.cfconv_fused(*xs, 5.0, 50, "bf16",
                                                   flag), args, g_out)
        runs.setdefault(flag, []).append(grads)
    on, off, off2 = runs[True][0], runs[False][0], runs[False][1]
    assert float(off[0].abs().max()) == 0.0
    assert float(on[0].abs().max()) > 0.0
    for name, a, b, c in zip(NAMES[1:], on[1:], off[1:], off2[1:]):
        assert _rel(b, a) < 1e-6, name
        assert torch.equal(b, c), name          # deterministic backward


def test_counters_and_rejections():
    from dig_tpu_torch.ops import cfconv as cf
    dev = _device()
    args, g_out = _inputs(dev, 3, 16, 32, 12, 5.0)
    cf.reset_launch_counts()
    _run(lambda xs: cf.cfconv_fused(*xs, 5.0, 12, "f32"), args, g_out)
    assert (cf.launches_fwd, cf.launches_bwd) == (1, 1)
    bad, _ = _inputs(dev, 3, 16, 48, 12, 5.0)
    with pytest.raises(ValueError):
        cf.cfconv_fused(*bad, 5.0, 12, "f32")
    big, g_big = _inputs(dev, 2, 64, 128, 50, 5.0)
    with pytest.raises(RuntimeError, match="shared memory"):
        _run(lambda xs: cf.cfconv_fused(*xs, 5.0, 50, "f32"), big, g_big)
    with pytest.raises(RuntimeError):
        xs = [a.clone().requires_grad_() for a in args]
        (g,) = torch.autograd.grad(cf.cfconv_fused(*xs, 5.0, 12).sum(),
                                   [xs[1]], create_graph=True)
        torch.autograd.grad(g.sum(), [xs[2]])


def test_schnet_dense_kernel_matches_plain_branch():
    from dig_tpu_torch.datasets import (BucketedDenseMoleculeLoader,
                                        synthetic_molecules)
    from dig_tpu_torch.models import SchNetDense
    from dig_tpu_torch.train import dense_loss
    dev = _device()
    mols = synthetic_molecules(300, seed=0, min_atoms=12, max_atoms=29,
                               box=6.0)
    batches = next(iter(BucketedDenseMoleculeLoader(
        mols, {16: 20, 24: 30, 32: 20}, shuffle=True, device=dev)))
    model = SchNetDense(cutoff=5.0, num_layers=2, hidden_channels=128,
                        num_filters=128, num_gaussians=50, use_kernel=True,
                        device=dev)
    grads = {}
    for use_kernel in (True, False):
        model.use_kernel = use_kernel
        model.zero_grad()
        loss = dense_loss(model, batches)
        loss.backward()
        grads[use_kernel] = (float(loss), [p.grad.clone()
                                           for p in model.parameters()])
    (lk, gk), (lp, gp) = grads[True], grads[False]
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        assert _rel(a, b) < 1e-3
