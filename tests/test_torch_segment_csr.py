"""Port's sorted-CSR segment sum (``segment_sum_sorted_csr``, its closed
autograd pair, ``csr_block_overflow``, ``segment_sum_sorted``) vs the JAX
package's, on the CPU.

The JAX ``segment_sum_sorted_csr`` runs its Pallas kernel in interpret mode
(as ``tests/test_pallas_segment.py`` does); the port on a CPU tensor runs
the kernel's plain version. Inputs are made with numpy from a seed: sorted
ids with a -1 padding tail, empty rows and a skewed degree (one row holds
a third of the edges); and the pattern of a flat edge list's row gathers,
whose padding edges all hold node 0, so that row 0 of the sorted ids holds
most of the entries (the adjoint of ``gather_rows`` over the senders or
receivers, at the widths the models gather: 1, 3 and 128).

Tolerances: float32 sums in another order, 1e-5 relative and absolute for
the forward and the VJP (a gather: exact), 1e-4 for the double backward
(products of two sums). bf16 data: the plain version sums the same bf16
values in float32, so the port and JAX agree to 1e-5 too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ops.pallas_segment import csr_block_overflow as j_overflow
from dig_tpu.ops.pallas_segment import segment_sum_sorted_csr as j_csr
from dig_tpu.ops.segment import segment_sum_sorted as j_sorted
from dig_tpu_torch.ops import segment_csr as sc
from dig_tpu_torch.ops.segment import gather_rows, segment_sum_sorted

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(seed=0, N=50, E_real=400, E_pad=48, F=24):
    """Sorted ids over N rows (row 7 takes a third of the edges; rows 0-2
    and 40-44 are empty), then E_pad padding rows with id -1."""
    rng = np.random.default_rng(seed)
    rows = np.setdiff1d(np.arange(N), [0, 1, 2, 40, 41, 42, 43, 44])
    seg = rng.choice(rows, size=E_real)
    seg[: E_real // 3] = 7
    seg = np.sort(seg).astype(np.int32)
    rowptr = np.searchsorted(seg, np.arange(N + 1)).astype(np.int32)
    seg = np.concatenate([seg, np.full(E_pad, -1, np.int32)])
    data = rng.normal(size=(E_real + E_pad, F)).astype(np.float32)
    return data, seg, rowptr, N


def _padded_senders(seed=0, N=40, E_real=150, E=512):
    """A flat edge list as ``adjacency_to_edges`` lays it out: E_real real
    (receiver, sender) pairs in receiver order, then padding pairs holding
    node 0; the senders of it, unsorted."""
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, N, E_real))
    send = (recv + rng.integers(1, N, E_real)) % N
    return np.concatenate([send, np.zeros(E - E_real, np.int64)]), N


def _padded_problem(F, seed=0):
    """The sorted ids and row pointer gather_rows builds for the padded
    senders (row 0 holds the padding: most of the entries), data [E, F]."""
    idx, N = _padded_senders(seed)
    seg = np.sort(idx).astype(np.int32)
    rowptr = np.searchsorted(seg, np.arange(N + 1)).astype(np.int32)
    data = np.random.default_rng(seed + 1).normal(
        size=(seg.shape[0], F)).astype(np.float32)
    return data, seg, rowptr, N


def _plain(data, seg, N):
    """The oracle: index_add_ over the real edges, float32."""
    keep = seg >= 0
    out = torch.zeros((N, data.shape[1]), dtype=data.dtype)
    return out.index_add_(0, torch.where(keep, seg, 0).long(),
                          torch.where(keep[:, None], data, 0.0))


@pytest.mark.parametrize("F", [24, 128, 1, 3])
def test_forward_and_vjp_match_jax(F):
    data, seg, rowptr, N = _problem(F=F)
    BN, EB = 8, 512             # the densest 8 rows + 127 slack fit
    assert int(j_overflow(jnp.asarray(rowptr), N, BN, EB)) == 0
    ct = np.random.default_rng(1).normal(size=(N, F)).astype(np.float32)

    out_j, vjp = jax.vjp(lambda d: j_csr(d, jnp.asarray(seg),
                                         jnp.asarray(rowptr), N, BN, EB),
                         jnp.asarray(data))
    (g_j,) = vjp(jnp.asarray(ct))
    d = torch.tensor(data, requires_grad=True)
    out_t = sc.segment_sum_sorted_csr(d, torch.tensor(seg),
                                      torch.tensor(rowptr), N, BN, EB)
    (g_t,) = torch.autograd.grad(out_t, d, torch.tensor(ct))
    assert out_t.dtype == torch.float32 and out_t.shape == (N, F)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(out_t.detach().numpy(),
                               _plain(torch.tensor(data), torch.tensor(seg),
                                      N).numpy(), **TOL)
    assert np.all(out_t.detach().numpy()[[0, 1, 2, 40, 44]] == 0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)
    assert np.all(g_t.numpy()[seg < 0] == 0)


@pytest.mark.parametrize("F", [1, 3, 128])
def test_padded_row_zero_matches_jax(F):
    """The padded-row-0 pattern: one row holds 362 of 512 entries; a
    window of the whole edge list, so that no edge is dropped."""
    data, seg, rowptr, N = _padded_problem(F)
    assert np.diff(rowptr).max() > seg.shape[0] // 2
    BN, EB = 8, sc.full_window(seg.shape[0])
    assert int(j_overflow(jnp.asarray(rowptr), N, BN, EB)) == 0
    ct = np.random.default_rng(2).normal(size=(N, F)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda d: j_csr(d, jnp.asarray(seg),
                                         jnp.asarray(rowptr), N, BN, EB),
                         jnp.asarray(data))
    (g_j,) = vjp(jnp.asarray(ct))
    d = torch.tensor(data, requires_grad=True)
    out_t = sc.segment_sum_sorted_csr(d, torch.tensor(seg),
                                      torch.tensor(rowptr), N, BN, EB)
    (g_t,) = torch.autograd.grad(out_t, d, torch.tensor(ct))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)


@pytest.mark.parametrize("F", [3, 128])
def test_gather_rows_adjoint_matches_jax(F):
    """gather_rows over the padded senders (its adjoint: the sorted-CSR sum
    over the sorted ids, row 0 holding the padding) against jax.vjp of
    ``x[idx]``."""
    idx, N = _padded_senders(seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, F)).astype(np.float32)
    ct = rng.normal(size=(idx.shape[0], F)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: a[jnp.asarray(idx)], jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    out_t = gather_rows(xt, torch.tensor(idx))
    (g_t,) = torch.autograd.grad(out_t, xt, torch.tensor(ct))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)
    assert np.abs(g_t.numpy()[0]).max() > 0     # row 0: the padding's sum


def test_bf16_data_matches_jax_and_casts_the_gradient():
    data, seg, rowptr, N = _problem(seed=2)
    data16 = torch.tensor(data).to(torch.bfloat16)
    want = j_csr(jnp.asarray(data16.float().numpy()).astype(jnp.bfloat16),
                 jnp.asarray(seg), jnp.asarray(rowptr), N, 8, 512)
    d = data16.clone().requires_grad_()
    out = sc.segment_sum_sorted_csr(d, torch.tensor(seg),
                                    torch.tensor(rowptr), N, 8, 512)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(want, np.float32), **TOL)
    (g,) = torch.autograd.grad(out.sum(), d)
    assert g.dtype == torch.bfloat16


def test_double_backward_of_the_closed_pair():
    """grad of a nonlinear loss with create_graph, then the grad of a
    contraction of that grad: the second pass runs _RowGather's backward,
    the CSR sum again. Held against autograd of a plain index_add_."""
    data, seg, rowptr, N = _problem(seed=3)
    rng = np.random.default_rng(4)
    c = torch.tensor(rng.normal(size=(N, data.shape[1])).astype(np.float32))
    v = torch.tensor(rng.normal(size=data.shape).astype(np.float32))
    seg_t, rp = torch.tensor(seg), torch.tensor(rowptr)
    results = []
    for fn in (lambda d: sc.segment_sum_sorted_csr(d, seg_t, rp, N, 8, 512),
               lambda d: _plain(d, seg_t, N)):
        d = torch.tensor(data, requires_grad=True)
        out = fn(d)
        (g,) = torch.autograd.grad(torch.sum(c * out * out), d,
                                   create_graph=True)
        (h,) = torch.autograd.grad(torch.sum(g * v * d), d)
        results.append((g.detach().numpy(), h.numpy()))
    (g_k, h_k), (g_p, h_p) = results
    assert np.abs(h_p).max() > 0
    np.testing.assert_allclose(g_k, g_p, **TOL)
    np.testing.assert_allclose(h_k, h_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("BN, EB", [(8, 512), (8, 64), (32, 1024),
                                    (16, 130)])
def test_block_overflow_matches_jax(BN, EB):
    _, _, rowptr, N = _problem(seed=5)
    want = int(j_overflow(jnp.asarray(rowptr), N, BN, EB))
    got = int(sc.csr_block_overflow(torch.tensor(rowptr), N, BN, EB))
    assert got == want
    if EB == 64:                # the skewed row alone holds 133 edges
        assert got > 0


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_sorted_matches_jax(masked):
    """Without a mask every id is real and sorted. With one, the masked
    tail (the padding of a flat edge list, holding any ids) goes to id -1
    for the sum and is parked at num_segments for the search that recovers
    rowptr (the JAX function on the TPU); on the CPU the JAX function is
    jax.ops.segment_sum."""
    data, seg, _, N = _problem(seed=6, E_pad=48 if masked else 0)
    rng = np.random.default_rng(7)
    ids = np.where(seg < 0, rng.integers(0, N, seg.shape), seg).astype(
        np.int32)
    mask = seg >= 0
    kw = dict(max_edges_per_block=512, block_rows=8)
    want = j_sorted(jnp.asarray(data), jnp.asarray(ids), N,
                    mask=jnp.asarray(mask) if masked else None, **kw)
    got = segment_sum_sorted(torch.tensor(data), torch.tensor(ids), N,
                             mask=torch.tensor(mask) if masked else None,
                             **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sc.launches == 0      # the CPU path launches nothing


def test_unsorted_ids_give_a_wrong_sum_as_in_jax():
    """The contract: ids must ascend over the real edges. Fed unsorted ids
    (rowptr from the same search the functions run), the port's plain
    version and the JAX kernel both miss edges the true sum counts."""
    data, seg, _, N = _problem(seed=8, E_pad=0)
    perm = np.random.default_rng(9).permutation(seg.shape[0])
    seg_u, data_u = seg[perm], data[perm]
    rowptr = np.searchsorted(seg_u, np.arange(N + 1)).astype(np.int32)
    truth = _plain(torch.tensor(data_u), torch.tensor(seg_u), N).numpy()
    port = segment_sum_sorted(torch.tensor(data_u), torch.tensor(seg_u), N,
                              max_edges_per_block=512, block_rows=8).numpy()
    jax_k = np.asarray(j_csr(jnp.asarray(data_u), jnp.asarray(seg_u),
                             jnp.asarray(rowptr), N, 8, 512))
    for got in (port, jax_k):
        assert np.abs(got - truth).max() > 1.0
    # sorted, the same data is summed right
    order = np.argsort(seg_u, kind="stable")
    ok = segment_sum_sorted(torch.tensor(data_u[order]),
                            torch.tensor(seg_u[order]), N,
                            max_edges_per_block=512, block_rows=8).numpy()
    np.testing.assert_allclose(ok, truth, **TOL)
