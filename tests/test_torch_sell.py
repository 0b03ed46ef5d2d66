"""The port's SELL ops (``ops/sell.py``, ``ops.segment.spmm_bidir_sell``)
against the JAX package's, on the CPU: the plans, ``segment_sum_sell`` in
both row orders with its VJP, ``spmm_sell`` with its VJPs, and
``spmm_bidir_sell`` with its VJP on a padded subgraph-like layout.

Tolerance: float32, 1e-5 of the largest value of each compared tensor
(the sums run in other orders); plans exactly. Inputs carry exactly
``num_edges`` rows wherever the JAX ``_sell_core`` would read past them
(it masks pad lanes with ``data.shape[0]``, not ``plan.num_edges``); a
separate case holds the port to the sum over the plan's edges when
``data`` is longer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dig_tpu.ops.segment as j_segment
import dig_tpu.ops.sell as j_sell
from dig_tpu_torch.ops import segment_sum, spmm_bidir_sell
from dig_tpu_torch.ops.sell import build_sell_plan, segment_sum_sell, spmm_sell

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_vjp(f, args, ct):
    """``f(*args)`` and its VJP at ``ct``, in one jit."""
    def run(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)
    return jax.jit(run)(tuple(jnp.asarray(a) for a in args), jnp.asarray(ct))


def _rowptr(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _rowptrs():
    """Random ids, a skewed degree with empty rows (tests/test_sell.py), and
    a subgraph's: in-batch rows of Poisson degree, then a long run of
    degree-0 halo and padding rows."""
    rng = np.random.default_rng(0)
    random = np.bincount(rng.integers(0, 60, 500), minlength=60)
    skewed = np.where(np.arange(50) % 13 == 0, 150, np.arange(50) % 4)
    sub = np.concatenate([rng.poisson(6, 40), np.zeros(70, np.int64)])
    return {"random": _rowptr(random), "skewed": _rowptr(skewed),
            "subgraph": _rowptr(sub)}


@pytest.mark.parametrize("name", ["random", "skewed", "subgraph"])
def test_plans_and_sums_against_jax(name):
    rowptr = _rowptrs()[name]
    N, E = len(rowptr) - 1, int(rowptr[-1])
    want = j_sell.build_sell_plan(rowptr)
    got = build_sell_plan(rowptr, device="cpu")
    assert (got.num_rows, got.num_edges, got.num_zero_rows) == (
        want.num_rows, want.num_edges, want.num_zero_rows)
    assert got.pad_overhead == want.pad_overhead
    assert len(got.tables) == len(want.tables)
    for a, b in zip(got.tables, want.tables):
        np.testing.assert_array_equal(a.numpy(), b)
    for f in ("row_order", "out_inv", "edge_row_out"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f))
    rng = np.random.default_rng(1)
    data = rng.normal(size=(E, 12)).astype(np.float32)
    ct = rng.normal(size=(N, 12)).astype(np.float32)
    for order in (False, True):
        d = torch.tensor(data, requires_grad=True)
        out = segment_sum_sell(d, got, original_order=order)
        (g,) = torch.autograd.grad(out, d, torch.tensor(ct))
        j_out, (j_g,) = _jax_vjp(lambda x: j_sell.segment_sum_sell(
            x, want, original_order=order), (data,), ct)
        assert out.dtype == torch.float32
        assert _rel(out.detach().numpy(), j_out) < TOL
        assert _rel(g.numpy(), j_g) < TOL


def test_spmm_sell_against_jax():
    rng = np.random.default_rng(3)
    N, F = 40, 16
    dense = (rng.uniform(size=(N, N)) < 0.2) * rng.normal(size=(N, N))
    col = np.concatenate([np.nonzero(row)[0] for row in dense]).astype(
        np.int32)
    val = dense[dense != 0].astype(np.float32)
    rowptr = _rowptr((dense != 0).sum(1))
    x = rng.normal(size=(N, F)).astype(np.float32)
    ct = rng.normal(size=(N, F)).astype(np.float32)
    plan = build_sell_plan(rowptr, device="cpu")
    xs, vs = (torch.tensor(a, requires_grad=True) for a in (x, val))
    out = spmm_sell(torch.tensor(col), vs, xs, plan)
    gx, gv = torch.autograd.grad(out, (xs, vs), torch.tensor(ct))
    j_plan = j_sell.build_sell_plan(rowptr)
    j_out, (jx, jv) = _jax_vjp(lambda x, v: j_sell.spmm_sell(
        jnp.asarray(col), v, x, j_plan), (x, val), ct)
    assert _rel(out.detach().numpy(), j_out) < TOL
    assert _rel(out.detach().numpy(), dense.astype(np.float32) @ x) < TOL
    assert _rel(gx.numpy(), jx) < TOL
    assert _rel(gv.numpy(), jv) < TOL


def _padded_layout(seed=5, N=40, E=300, E_pad=352):
    """tests/test_sell.py's spmm_bidir_sell layout: receiver-sorted real
    edges, padding edges after them with zero coef."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, E)
    receivers = np.sort(rng.integers(0, N, E))
    em = np.arange(E_pad) < E
    s_p = np.zeros(E_pad, np.int32)
    s_p[:E] = senders
    r_p = np.zeros(E_pad, np.int32)
    r_p[:E] = receivers
    order = np.argsort(senders, kind="stable")
    return dict(
        N=N, em=em, s_p=s_p, r_p=r_p,
        rowptr=_rowptr(np.bincount(receivers, minlength=N)),
        rowptr_rev=_rowptr(np.bincount(senders, minlength=N)),
        rev_perm=np.concatenate([order, np.arange(E, E_pad)]).astype(
            np.int32),
        recv_ids=np.where(em, r_p, -1).astype(np.int32),
        coef=np.where(em, rng.uniform(0.1, 1, E_pad), 0.0).astype(
            np.float32),
        h=rng.normal(size=(N, 16)).astype(np.float32),
        ct=rng.normal(size=(N, 16)).astype(np.float32))


def _port_args(L):
    return (torch.tensor(L["coef"]), torch.tensor(L["s_p"]),
            torch.tensor(L["recv_ids"]),
            build_sell_plan(L["rowptr"], device="cpu"),
            torch.tensor(L["rev_perm"]),
            build_sell_plan(L["rowptr_rev"], device="cpu"))


def test_spmm_bidir_sell_against_jax():
    L = _padded_layout()
    h = torch.tensor(L["h"], requires_grad=True)
    out = spmm_bidir_sell(h, *_port_args(L))
    (g,) = torch.autograd.grad(out, h, torch.tensor(L["ct"]))
    plans = (j_sell.build_sell_plan(L["rowptr"]),
             j_sell.build_sell_plan(L["rowptr_rev"]))
    j_out, (j_g,) = _jax_vjp(lambda h: j_segment.spmm_bidir_sell(
        h, jnp.asarray(L["coef"]), jnp.asarray(L["s_p"]),
        jnp.asarray(L["recv_ids"]), plans[0], jnp.asarray(L["rev_perm"]),
        plans[1]), (L["h"],), L["ct"])
    assert _rel(out.detach().numpy(), j_out) < TOL
    assert _rel(g.numpy(), j_g) < TOL
    msg = torch.tensor(L["h"])[torch.tensor(L["s_p"]).long()] * \
        torch.tensor(L["coef"])[:, None]
    plain = segment_sum(msg, torch.tensor(L["r_p"]), L["N"],
                        mask=torch.tensor(L["em"]))
    assert _rel(out.detach().numpy(), plain.numpy()) < TOL


@pytest.mark.parametrize("fault,says", [
    ("unsorted receivers", "receiver-sorted order"),
    ("pad coef", "zero coef"), ("rev_perm", "rev_perm into")])
def test_spmm_bidir_sell_checks_its_layout(fault, says):
    """The two assumptions the JAX function makes silently (receiver-sorted
    CSR order, zero coef on padding) and the reverse permutation raise."""
    L = _padded_layout()
    if fault == "unsorted receivers":
        L["recv_ids"][[3, 200]] = L["recv_ids"][[200, 3]]
    elif fault == "pad coef":
        L["coef"][-1] = 0.5
    else:
        L["rev_perm"][[0, 1]] = L["rev_perm"][[1, 0]]
        if L["s_p"][L["rev_perm"][0]] == L["s_p"][L["rev_perm"][1]]:
            L["rev_perm"][[0, 299]] = L["rev_perm"][[299, 0]]
    with pytest.raises(ValueError, match=says):
        spmm_bidir_sell(torch.tensor(L["h"]), *_port_args(L))


def test_pad_lanes_ignore_rows_past_the_plan():
    """``data`` longer than the plan's edges: pad lanes add nothing, and
    the rows past the plan get a zero gradient."""
    rowptr = _rowptrs()["subgraph"]
    E = int(rowptr[-1])
    plan = build_sell_plan(rowptr, device="cpu")
    data = torch.randn(E + 9, 5, generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    out = segment_sum_sell(data, plan, original_order=True)
    seg = torch.repeat_interleave(torch.arange(len(rowptr) - 1),
                                  torch.tensor(np.diff(rowptr)))
    want = segment_sum(data[:E].detach(), seg, len(rowptr) - 1)
    assert _rel(out.detach().numpy(), want.numpy()) < TOL
    (g,) = torch.autograd.grad(out.sum(), data)
    assert float(g[E:].abs().max()) == 0.0
    assert float((g[:E] - 1.0).abs().max()) == 0.0
