"""The port's segment reductions, ``spmm_bidir_csr`` and ``ops/scatter.py``
against the JAX package's, on the CPU.

Inputs are seeded numpy arrays: 13 rows over 6 segments, segment 2 with
no row, segment 4 with only masked rows, values rounded to a grid of 0.5
so that several rows of a segment tie at its maximum and minimum. Forward
values and the VJPs of a seeded cotangent are compared at 1e-6 (float32
sums in another order); a max or min's gradient is split evenly among the
rows that attain it in both packages, so the tied rows get the same
shares. ``segment_argmin`` and ``coalesce_mean``'s representative mask are
equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dig_tpu.ops as J
import dig_tpu_torch.ops as T

S = 6
IDS = np.array([0, 0, 0, 1, 1, 3, 3, 3, 3, 4, 4, 5, 5], np.int32)
MASK = np.array([1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1], bool)
TOL = 1e-6


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=shape) * 2) / 2).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _both(name, x, masked, **kw):
    """(port output, port VJP, JAX output, JAX VJP) of reduction ``name``
    on ``x`` with a seeded cotangent."""
    m = MASK if masked else None
    jf = lambda d: getattr(J, name)(d, jnp.asarray(IDS), S,
                                    None if m is None else jnp.asarray(m),
                                    **kw)
    out_j, vjp = jax.vjp(jf, jnp.asarray(x))
    ct = np.random.default_rng(1).normal(size=out_j.shape).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out_t = getattr(T, name)(xt, torch.tensor(IDS), S,
                             None if m is None else torch.tensor(m), **kw)
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(ct))
    return out_t.detach().numpy(), g_t.numpy(), np.asarray(out_j), \
        np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max", "segment_min",
                                  "segment_softmax", "segment_normalize"])
@pytest.mark.parametrize("shape", [(13,), (13, 3)], ids=["1d", "2d"])
def test_reductions_and_vjps_match_jax(name, masked, shape):
    x = _data(shape)
    if name == "segment_normalize":
        x = np.abs(x) + 0.5          # segment sums away from 0
    out_t, g_t, out_j, g_j = _both(name, x, masked)
    assert out_t.shape == out_j.shape and out_t.dtype == out_j.dtype
    fin = np.isfinite(out_j)
    # the identities: -inf / +inf for the segment with no row, -1e30 /
    # +1e30 for the one with only masked rows
    np.testing.assert_array_equal(out_t[~fin], out_j[~fin])
    assert _rel(out_t[fin], out_j[fin]) < TOL
    assert _rel(g_t, g_j) < TOL


def test_extremum_identities_and_tie_split():
    """segment 2 holds no row, 4 only masked rows; three rows of segment 3
    tie at its max (1.0), and each gets a third of its cotangent."""
    x = np.array([0, 1, 2, 3, 4, 1, 9, 1, 1, 5, 6, 7, 8], np.float32)
    out_t, g_t, out_j, g_j = _both("segment_max", x, True)
    assert out_t[2] == out_j[2] == -np.inf
    assert out_t[4] == out_j[4] == np.float32(-1e30)
    np.testing.assert_array_equal(out_t, out_j)
    tied = IDS == 3
    tied &= MASK
    assert np.allclose(g_j[tied], g_j[tied][0])
    assert _rel(g_t, g_j) < TOL
    out_t, _, out_j, _ = _both("segment_min", x, True)
    assert out_t[2] == out_j[2] == np.inf
    assert out_t[4] == out_j[4] == np.float32(1e30)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_argmin_first_index_and_empty_zero(masked):
    x = _data((13,), seed=2)
    x[5] = x[7] = x[8] = -3.0        # a three-way tie at segment 3's min
    m = MASK if masked else None
    got = T.segment_argmin(torch.tensor(x), torch.tensor(IDS), S,
                           None if m is None else torch.tensor(m))
    want = J.segment_argmin(jnp.asarray(x), jnp.asarray(IDS), S,
                            None if m is None else jnp.asarray(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[2]) == 0 and int(got[3]) == 5


def _bidir_tables(rng, N=9, E=40, pad=5):
    """A random graph's receiver-sorted edges with ``pad`` padding edges
    last, and the reverse (sender-sorted) tables."""
    recv = np.sort(rng.integers(0, N, E - pad)).astype(np.int32)
    send = rng.integers(0, N, E - pad).astype(np.int32)
    recv_ids = np.concatenate([recv, -np.ones(pad, np.int32)])
    senders = np.concatenate([send, np.zeros(pad, np.int32)])
    coef = rng.uniform(0.1, 1.0, E).astype(np.float32)
    coef[E - pad:] = 0.0
    rowptr = np.searchsorted(recv, np.arange(N + 1)).astype(np.int32)
    key = np.where(recv_ids >= 0, senders, N)
    rev_perm = np.argsort(key, kind="stable").astype(np.int32)
    send_sorted = np.where(recv_ids[rev_perm] >= 0, senders[rev_perm],
                           -1).astype(np.int32)
    rowptr_rev = np.searchsorted(key[rev_perm],
                                 np.arange(N + 1)).astype(np.int32)
    return (coef, senders, recv_ids, rowptr, rev_perm, send_sorted,
            rowptr_rev), N


def test_spmm_bidir_csr_and_its_vjp_match_jax():
    rng = np.random.default_rng(3)
    tabs, N = _bidir_tables(rng)
    h = rng.normal(size=(N, 4)).astype(np.float32)
    ct = rng.normal(size=(N, 4)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda hh: J.spmm_bidir_csr(
        hh, *map(jnp.asarray, tabs), N), jnp.asarray(h))
    ht = torch.tensor(h, requires_grad=True)
    out_t = T.spmm_bidir_csr(ht, *map(torch.tensor, tabs), N)
    (g_t,) = torch.autograd.grad(out_t, ht, torch.tensor(ct))
    assert out_t.dtype == torch.float32
    assert _rel(out_t.detach().numpy(), out_j) < TOL
    assert _rel(g_t.numpy(), vjp(jnp.asarray(ct))[0]) < TOL
    # the adjoint is h's, not coef's: coef is a constant
    coef = torch.tensor(tabs[0], requires_grad=True)
    T.spmm_bidir_csr(ht, coef, *map(torch.tensor, tabs[1:]), N).sum() \
        .backward()
    assert coef.grad is None


def test_gather_and_scatter_sum_edges_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    idx = rng.integers(0, 7, 11).astype(np.int32)
    m = rng.random(11) > 0.3
    got = T.gather(torch.tensor(x), torch.tensor(idx), torch.tensor(m))
    want = J.gather(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    e = rng.normal(size=(11, 3)).astype(np.float32)
    got = T.scatter_sum_edges(torch.tensor(e), torch.tensor(idx), 7,
                              torch.tensor(m))
    want = J.scatter_sum_edges(jnp.asarray(e), jnp.asarray(idx), 7,
                               jnp.asarray(m))
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_coalesce_mean_matches_jax(masked):
    rng = np.random.default_rng(5)
    E = 24
    s = rng.integers(0, 4, E).astype(np.int32)
    r = rng.integers(0, 4, E).astype(np.int32)
    v = rng.normal(size=(E, 2)).astype(np.float32)
    m = rng.random(E) > 0.25 if masked else None
    mv_t, rep_t = T.coalesce_mean(torch.tensor(v), torch.tensor(s),
                                  torch.tensor(r), 4,
                                  None if m is None else torch.tensor(m))
    mv_j, rep_j = J.coalesce_mean(jnp.asarray(v), jnp.asarray(s),
                                  jnp.asarray(r), 4,
                                  None if m is None else jnp.asarray(m))
    np.testing.assert_array_equal(rep_t.numpy(), np.asarray(rep_j))
    assert _rel(mv_t.numpy(), mv_j) < TOL
