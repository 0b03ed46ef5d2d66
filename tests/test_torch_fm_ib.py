"""The port's GraphFM-IB (``lsgraph/fm_ib.py``) against the JAX package's,
on the CPU: the neighbour sampler's batches for one seed, the forward
(log-probabilities), the pushed histories and the parameter gradients of
one step from seeded non-zero histories with flax weights transplanted,
and ``full_inference``.

Tolerance: float32, 1e-5 of the largest value of each compared tensor
(sums in other orders); batches exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import dig_tpu.lsgraph as jl
import dig_tpu_torch.lsgraph as tl
from dig_tpu_torch.convert import graphfm_ib_from_flax

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def data():
    return tl.synthetic_large_graph(120, seed=2, avg_deg=4)


def test_batches_equal_jax_for_one_seed(data):
    s, r, tm = data["senders"], data["receivers"], data["train_mask"]
    N = len(data["y"])
    args = (s, r, N, tm)
    kw = dict(sizes=[3, 2], batch_size=8, seed=4)
    got_ld, want_ld = tl.NeighborSampledLoader(*args, **kw), \
        jl.NeighborSampledLoader(*args, **kw)
    assert got_ld.caps == want_ld.caps
    for _ in range(2):                      # two epochs: the rng carries on
        got, want = list(got_ld), list(want_ld)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.batch_size == w.batch_size
            for f in ("n_id", "node_mask"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            for f in ("src_idx", "dst_idx", "edge_mask"):
                assert len(getattr(g, f)) == len(getattr(w, f)) == 2
                for a, c in zip(getattr(g, f), getattr(w, f)):
                    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("alpha", [0.1, 0.0])
def test_step_against_jax(data, alpha):
    """Forward, new histories and gradients of sum(out * w), one batch."""
    s, r, x = data["senders"], data["receivers"], data["x"]
    N = len(data["y"])
    ld = jl.NeighborSampledLoader(s, r, N, data["train_mask"], sizes=[3, 3],
                                  batch_size=16, seed=3)
    b = next(iter(ld))
    jm = jl.GraphFMIB(N, x.shape[1], 16, 4, 2, alpha=alpha).bind(ld)
    params = jax.jit(lambda k: jm.init(k, x, b))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    hists = [rng.normal(size=h.shape).astype(np.float32)
             for h in jm.histories]
    w = rng.normal(size=(16, 4)).astype(np.float32)

    def run(p, h):
        out, nh = jm.forward(p, h, jnp.asarray(x), b)
        return jnp.sum(out * w), (out, nh)
    (_, (j_out, j_hist)), j_g = jax.jit(jax.value_and_grad(
        run, has_aux=True))(params, tuple(jnp.asarray(h) for h in hists))

    tm = tl.GraphFMIB(N, x.shape[1], 16, 4, 2, alpha=alpha,
                      device="cpu").bind(ld)
    graphfm_ib_from_flax(flatten_dict(params["params"], sep="/"), tm)
    out, new_h = tm(tuple(torch.tensor(h) for h in hists), torch.tensor(x),
                    b)
    (out * torch.tensor(w)).sum().backward()
    assert out.shape == (16, 4)
    assert _rel(out.detach().numpy(), j_out) < TOL
    for a, h in zip(new_h, j_hist):
        assert not a.requires_grad
        assert _rel(a.numpy(), h) < TOL
    if alpha == 0:
        for a, h in zip(new_h, hists):
            np.testing.assert_array_equal(a.numpy(), h)
    for i in range(2):
        g = flatten_dict(j_g["params"], sep="/")
        assert _rel(tm.lin_l[i].weight.grad.numpy(),
                    np.asarray(g[f"lin_l_{i}/kernel"]).T) < TOL
        assert _rel(tm.lin_l[i].bias.grad.numpy(),
                    g[f"lin_l_{i}/bias"]) < TOL
        assert _rel(tm.lin_r[i].weight.grad.numpy(),
                    np.asarray(g[f"lin_r_{i}/kernel"]).T) < TOL


def test_full_inference_against_jax(data):
    s, r, x = data["senders"], data["receivers"], data["x"]
    N = len(data["y"])
    ld = jl.NeighborSampledLoader(s, r, N, data["train_mask"], sizes=[3, 3],
                                  batch_size=16, seed=3)
    jm = jl.GraphFMIB(N, x.shape[1], 16, 4, 2).bind(ld)
    b = next(iter(ld))
    params = jax.jit(lambda k: jm.init(k, x, b))(jax.random.PRNGKey(1))
    em = np.random.default_rng(6).random(len(s)) < 0.8
    tm = tl.GraphFMIB(N, x.shape[1], 16, 4, 2, device="cpu").bind(ld)
    graphfm_ib_from_flax(flatten_dict(params["params"], sep="/"), tm)
    for mask in (None, em):
        want = jax.jit(lambda p: jm.full_inference(
            p, jnp.asarray(x), jnp.asarray(s), jnp.asarray(r),
            None if mask is None else jnp.asarray(mask)))(params)
        got = tm.full_inference(torch.tensor(x), s, r, mask)
        assert _rel(got.numpy(), want) < TOL
