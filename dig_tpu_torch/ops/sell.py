"""SELL-style (sliced-ELLPACK) segment sum / SpMM. Port of
``dig_tpu/ops/sell.py``.

Rows are sorted by degree (the σ-sort of SELL-C-σ), padded up to a small
ladder of slice widths, and each width-``d`` bucket becomes a dense
``[rows, d]`` gather table into the edge array; the segment sum is then
``data[table].sum(1)`` per bucket and a zeros block for the degree-0 rows
(they get no table and sort last). The plan (permutation + tables) is
static per graph and built on the host with numpy (:func:`build_sell_plan`,
copied), as the METIS partition is. Output rows come out in degree-sorted
order; ``plan.unpermute`` restores the original order.

The JAX package computes SELL in plain XLA, outside any Pallas kernel, so
plain PyTorch is the whole port here: a gather, a reduction and a
concatenation per width bucket. The VJP of the sum is the per-edge row
gather ``d_data[e] = d_out[row(e)]`` (a ``torch.autograd.Function``).

Pad lanes point at edge ``plan.num_edges`` and add nothing, whatever rows
``data`` holds past the plan's edges: the sum reads ``data[:num_edges]``
and a zero row appended at ``num_edges``. (The JAX ``_sell_core`` masks
with ``data.shape[0]``, so there a pad lane reads a real row of ``data``
when ``data`` holds more rows than the plan's edges.)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SellPlan:
    """Static per-graph gather plan; index tensors int64 on one device."""
    tables: Tuple[torch.Tensor, ...]  # [rows_b, d_b] edge ids per bucket
    row_order: torch.Tensor   # [N] original row id per output row
    out_inv: torch.Tensor     # [N] output row per original row id
    edge_row_out: torch.Tensor  # [E] output row of each edge
    num_rows: int
    num_edges: int
    pad_overhead: float       # padded/real edge ratio - 1 (diagnostic)
    num_zero_rows: int = 0    # degree-0 rows: no table, a zeros block
    # (they sort last in row_order)

    def unpermute(self, out: torch.Tensor) -> torch.Tensor:
        return out[self.out_inv]

    def to(self, device: DeviceLike) -> "SellPlan":
        """The same plan with its index tensors on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, tables=tuple(t.to(dev) for t in self.tables),
            row_order=self.row_order.to(dev), out_inv=self.out_inv.to(dev),
            edge_row_out=self.edge_row_out.to(dev))


def build_sell_plan(rowptr, *, width_multiple: int = 4, min_width: int = 4,
                    device: DeviceLike = None) -> SellPlan:
    """Host-side SELL-C-σ plan from a CSR rowptr (numpy), its tensors on
    ``device`` (``None``: the card).

    Rows are sorted by degree (descending), each row's slice width is its
    degree rounded up to ``width_multiple`` (the bucket ladder), and every
    bucket gets a dense gather table whose padding entries point at edge
    ``num_edges`` (a zero row the sum appends).
    """
    dev = resolve_device(device)
    rp = np.asarray(rowptr, np.int64)
    N = rp.shape[0] - 1
    E = int(rp[-1])
    deg = np.diff(rp)
    perm = np.argsort(-deg, kind="stable")
    # degree-0 rows get NO table: the sum appends a zeros block for them
    # (they sort last); partitioned subgraphs carry many such halo rows
    nz = perm[deg[perm] > 0]
    zero_rows = perm[deg[perm] == 0]
    dpad = np.maximum(min_width, -(-deg // width_multiple) * width_multiple)
    tables = []
    order_parts = []
    for d in np.unique(dpad[nz]):
        rows = nz[dpad[nz] == d]
        starts = rp[rows]
        lens = deg[rows]
        idx = starts[:, None] + np.arange(d)[None, :]
        idx = np.where(np.arange(d)[None, :] < lens[:, None], idx, E)
        tables.append(idx)
        order_parts.append(rows)
    order_parts.append(zero_rows)
    row_order = np.concatenate(order_parts)
    out_inv = np.empty(N, np.int64)
    out_inv[row_order] = np.arange(N)
    edge_row_out = np.repeat(out_inv, deg)
    pad = float(sum(int(t.size) for t in tables)) / max(E, 1) - 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)
    return SellPlan(tables=tuple(t(x) for x in tables),
                    row_order=t(row_order), out_inv=t(out_inv),
                    edge_row_out=t(edge_row_out), num_rows=N, num_edges=E,
                    pad_overhead=pad, num_zero_rows=int(len(zero_rows)))


def sell_sum(data: torch.Tensor, plan: SellPlan) -> torch.Tensor:
    """The plan's row sums of ``data [>= num_edges, F]`` in degree-sorted
    row order, float32, no autograd of its own."""
    E, F = plan.num_edges, data.shape[1]
    if data.shape[0] < E:
        raise ValueError(f"SELL sum: data has {data.shape[0]} rows, the plan "
                         f"{E} edges")
    d32 = data[:E].float()
    ext = torch.cat([d32, d32.new_zeros((1, F))])   # pad lanes read row E
    outs = [ext[t].sum(dim=1) for t in plan.tables]
    if plan.num_zero_rows:
        outs.append(d32.new_zeros((plan.num_zero_rows, F)))
    return torch.cat(outs) if outs else d32.new_zeros((0, F))


class _SellSum(torch.autograd.Function):
    """``data [E', F] -> [N, F]`` float32 (degree-sorted rows). Adjoint:
    ``g[edge_row_out]`` for the plan's edges, zeros for rows of ``data``
    past them, in ``data``'s type."""

    @staticmethod
    def forward(ctx, data, plan):
        ctx.plan = plan
        ctx.meta = (data.shape[0], data.dtype)
        return sell_sum(data, plan)

    @staticmethod
    def backward(ctx, g):
        plan, (rows, dtype) = ctx.plan, ctx.meta
        d = g[plan.edge_row_out]
        if rows > plan.num_edges:
            d = torch.cat([d, d.new_zeros((rows - plan.num_edges,
                                           d.shape[1]))])
        return d.to(dtype), None


def segment_sum_sell(data: torch.Tensor, plan: SellPlan, *,
                     original_order: bool = False) -> torch.Tensor:
    """Segment sum of ``data [E, F]`` under ``plan`` -> ``[N, F]`` float32.

    Output rows are in the plan's degree-sorted order unless
    ``original_order`` (one extra N-row gather). Differentiable: the VJP
    is the per-edge row gather ``d_data[e] = d_out[row(e)]``.
    """
    out = _SellSum.apply(data, plan)
    return plan.unpermute(out) if original_order else out


def spmm_sell(col: torch.Tensor, val, x: torch.Tensor, plan: SellPlan, *,
              original_order: bool = True) -> torch.Tensor:
    """CSR sparse @ dense via the SELL plan: ``out[i] = sum_e val*x[col]``.

    ``col``/``val`` follow the same sorted-CSR layout the plan was built
    from.
    """
    data = x[col.long()]
    if val is not None:
        data = data * val[:, None]
    return segment_sum_sell(data, plan, original_order=original_order)
