"""Port's chunked sorted-CSR segment sum, its chunk planner, spmm_csr and
synthetic_large_graph (on the CPU: the plain versions) vs the JAX package's.

The JAX kernels run in interpret mode, at the sizes and (block_rows,
chunk_edges) pairs of tests/test_pallas_segment.py. The chunk tables must be
the same integers, and the synthetic graph the same arrays. Sums: 1e-5 of
the largest value (float32 sums in another order; the JAX kernel splits
float32 data into three bf16 terms for its matrix unit); the VJP (a plain
row gather of 2 out on both sides) and spmm_csr, 1e-5 as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.lsgraph.data import synthetic_large_graph as j_graph
from dig_tpu.ops.pallas_segment import choose_chunk_plan as j_choose
from dig_tpu.ops.pallas_segment import plan_chunks as j_plan
from dig_tpu.ops.pallas_segment import \
    segment_sum_sorted_csr_chunked as j_chunked
from dig_tpu.ops.pallas_segment import spmm_csr as j_spmm
from dig_tpu_torch.lsgraph import synthetic_large_graph
from dig_tpu_torch.ops.segment_csr import (
    choose_chunk_plan, plan_chunks, segment_sum_sorted_csr_chunked,
    segment_sum_sorted_csr_chunked_reference, spmm_csr)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _sorted_problem(seed=0, N=50, E=400, F=24):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    rowptr = np.zeros(N + 1, np.int32)
    np.add.at(rowptr[1:], seg, 1)
    rowptr = np.cumsum(rowptr).astype(np.int32)
    data = rng.normal(size=(E, F)).astype(np.float32)
    return data, seg, rowptr, N


def _skewed(N=60):
    deg = np.where(np.arange(N) % 17 == 0, 200, 3)
    seg = np.repeat(np.arange(N), deg).astype(np.int32)
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return seg, rowptr, N


def _rowptrs():
    _, _, rp, N = _sorted_problem(seed=4, N=70, E=900)
    _, rp2, N2 = _skewed()
    empty = np.zeros(41, np.int32)                         # no edges
    one = np.concatenate([[0] * 20, [5000] * 21]).astype(np.int32)
    return [(rp, N), (rp2, N2), (empty, 40), (one, 40)]


@pytest.mark.parametrize("case", range(4))
def test_plans_equal_jax(case):
    rp, N = _rowptrs()[case]
    for BN, EB in ((8, 128), (16, 256), (32, 128), (64, 512)):
        want = j_plan(rp, N, BN, EB)
        got = plan_chunks(rp, N, BN, EB)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for F, jd, td in ((24, jnp.float32, torch.float32),
                      (128, jnp.bfloat16, torch.bfloat16)):
        want = j_choose(rp, N, F, jd)
        got = choose_chunk_plan(rp, N, F, td)
        assert got[:2] == want[:2] and got[3] == want[3]
        assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("BN,EB", [(8, 128), (16, 256), (32, 128)])
def test_chunked_forward_matches_jax(BN, EB):
    data, seg, rowptr, N = _sorted_problem(seed=4, N=70, E=900, F=24)
    meta = plan_chunks(rowptr, N, BN, EB)
    out = segment_sum_sorted_csr_chunked(torch.tensor(data),
                                         torch.tensor(seg), meta, N, BN, EB)
    assert out.dtype == torch.float32 and out.shape == (N, 24)
    want = j_chunked(jnp.asarray(data), jnp.asarray(seg), jnp.asarray(meta),
                     N, BN, EB)
    assert _rel(out.numpy(), want) < 1e-5
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg),
                              num_segments=N)
    assert _rel(out.numpy(), ref) < 1e-5


def test_chunked_vjp_matches_jax():
    data, seg, rowptr, N = _sorted_problem(seed=5, N=40, E=500, F=16)
    meta = plan_chunks(rowptr, N, 8, 128)
    d = torch.tensor(data, requires_grad=True)
    out = segment_sum_sorted_csr_chunked(d, torch.tensor(seg), meta, N, 8,
                                         128)
    (g,) = torch.autograd.grad((out ** 2).sum(), d)
    gj = jax.grad(lambda x: jnp.sum(j_chunked(
        x, jnp.asarray(seg), jnp.asarray(meta), N, 8, 128) ** 2))(
            jnp.asarray(data))
    assert _rel(g.numpy(), gj) < 1e-5


def test_chunked_skewed_and_bf16():
    """Power-law-ish rows with the planner's own choice, as the JAX test;
    bf16 data sums to float32 as the float32 sum of the same bf16 values."""
    seg, rowptr, N = _skewed()
    data = np.random.default_rng(6).normal(
        size=(len(seg), 24)).astype(np.float32)
    BN, EB, meta, _ = choose_chunk_plan(rowptr, N, 24)
    out = segment_sum_sorted_csr_chunked(torch.tensor(data),
                                         torch.tensor(seg), meta, N, BN, EB)
    want = j_chunked(jnp.asarray(data), jnp.asarray(seg), jnp.asarray(meta),
                     N, BN, EB)
    assert _rel(out.numpy(), want) < 1e-5
    d16 = torch.tensor(data).to(torch.bfloat16)
    out16 = segment_sum_sorted_csr_chunked(d16, torch.tensor(seg), meta, N,
                                           BN, EB)
    assert out16.dtype == torch.float32
    ref = segment_sum_sorted_csr_chunked_reference(d16.float(),
                                                   torch.tensor(seg), meta, N,
                                                   BN, EB)
    assert _rel(out16.numpy(), ref.numpy()) < 1e-6


def test_chunked_padding_ids_and_tail_rows():
    """-1 padding ids inside and after the edges add nothing; rows past the
    last edge are zero; windows run past the end of the data."""
    data, seg, rowptr, N = _sorted_problem(seed=7, N=60, E=300, F=8)
    seg = seg.copy()
    seg[::7] = -1
    data_p = np.concatenate([data, np.ones((37, 8), np.float32)])
    seg_p = np.concatenate([seg, np.full(37, -1, np.int32)])
    rp = np.concatenate([rowptr, [rowptr[-1]] * 5]).astype(np.int32)
    meta = plan_chunks(rp, N + 5, 16, 128)
    out = segment_sum_sorted_csr_chunked(torch.tensor(data_p),
                                         torch.tensor(seg_p), meta, N + 5,
                                         16, 128)
    keep = seg >= 0
    want = np.zeros((N + 5, 8), np.float64)
    np.add.at(want, seg[keep], data[keep])
    assert _rel(out.numpy(), want) < 1e-5
    assert np.all(out.numpy()[N:] == 0)


def test_spmm_csr_matches_jax():
    rng = np.random.default_rng(3)
    N, F = 40, 16
    dense = (rng.uniform(size=(N, N)) < 0.15).astype(np.float32)
    dense *= rng.normal(size=(N, N)).astype(np.float32)
    x = rng.normal(size=(N, F)).astype(np.float32)
    rowptr, col, val = [0], [], []
    for i in range(N):
        nz = np.nonzero(dense[i])[0]
        col.extend(nz)
        val.extend(dense[i, nz])
        rowptr.append(len(col))
    rp = np.array(rowptr, np.int32)
    col = np.array(col + [3, 3], np.int32)          # two padding edges
    val = np.array(val + [1.0, 1.0], np.float32)
    got = spmm_csr(torch.tensor(rp), torch.tensor(col), torch.tensor(val),
                   torch.tensor(x), N, block_rows=8, max_edges_per_block=256)
    want = j_spmm(jnp.asarray(rp), jnp.asarray(col), jnp.asarray(val),
                  jnp.asarray(x), N, block_rows=8, max_edges_per_block=256)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    assert _rel(got.numpy(), dense @ x) < 1e-5
    xt = torch.tensor(x, requires_grad=True)
    out = spmm_csr(torch.tensor(rp), torch.tensor(col), torch.tensor(val),
                   xt, N)
    (g,) = torch.autograd.grad(out.sum(), xt)
    assert _rel(g.numpy(), dense.sum(0)[:, None] * np.ones((1, F))) < 1e-5


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_large_graph_bit_identical(seed):
    got = synthetic_large_graph(300, seed=seed)
    want = j_graph(300, seed=seed)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
