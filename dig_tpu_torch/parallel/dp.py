"""Data-parallel training step over the ``data`` dimension of a mesh. Port of
``dig_tpu/parallel/dp.py`` on ``torch.distributed``.

Each rank holds a self-contained slab of the batch (its sub-batch, node
indices local to the slab: :func:`~dig_tpu_torch.parallel.mesh.
shard_graph_batch`), computes its loss sums and gradients, and the only
collectives are the sums of the counts, the loss sums and the gradients.

The step is the JAX one, not DDP's: the local loss sums are divided by the
*global* masked counts (summed over the ranks) and the gradients are then
summed, so one step over P slabs equals one single-process step over
their union. (DDP averages the gradients of per-rank means instead.)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..graph import GraphBatch
from ..train.trainer import energy_force
from . import comm


def _local_sums(model, g: GraphBatch, err, energy_and_force: bool,
                target_key: str):
    """(e_sum, f_sum, e_cnt, f_cnt) of the rank's slab; the counts do not
    depend on the weights."""
    y = g.globals[target_key]
    if y.ndim == 1:
        y = y[:, None]
    if energy_and_force:
        e, force = energy_force(model, g)
        d = err(e - y)
        e_sum = torch.sum(torch.where(g.graph_mask[:, None], d, 0.0))
        f_sum = torch.sum(torch.where(g.node_mask[:, None],
                                      err(force - g.nodes["force"]), 0.0))
        return (e_sum, f_sum, torch.sum(g.graph_mask) * d.shape[-1],
                torch.sum(g.node_mask) * 3)
    d = err(model(g) - y)
    e_sum = torch.sum(torch.where(g.graph_mask[:, None], d, 0.0))
    return (e_sum, torch.zeros((), device=e_sum.device),
            torch.sum(g.graph_mask) * d.shape[-1],
            torch.zeros((), device=e_sum.device))


def dp_loss_step(model, params, g: GraphBatch, group, *, err,
                 energy_and_force: bool, p: float,
                 target_key: str) -> Dict[str, torch.Tensor]:
    """Backward of one rank's share of the global loss of ``model`` into
    ``params``' ``.grad``, then the gradients, loss sums and counts summed
    over ``group``; returns the global ``{"loss", "e_loss", "f_loss"}``."""
    e_sum, f_sum, e_cnt, f_cnt = _local_sums(model, g, err,
                                             energy_and_force, target_key)
    cnt = comm.all_reduce_(torch.stack([e_cnt, f_cnt]).float(), group)
    e_cnt_g, f_cnt_g = torch.clamp(cnt, min=1.0)
    local = e_sum / e_cnt_g
    if energy_and_force:
        local = local + p * f_sum / f_cnt_g
    local.backward(inputs=params)
    grads = [q.grad if q.grad is not None else torch.zeros_like(q)
             for q in params]
    flat = torch.cat([gr.reshape(-1) for gr in grads]
                     + [torch.stack([e_sum, f_sum]).detach()])
    comm.all_reduce_(flat, group)
    off = 0
    for q, gr in zip(params, grads):
        k = gr.numel()
        q.grad = flat[off:off + k].view_as(q).clone()
        off += k
    e_loss = flat[-2] / e_cnt_g
    f_loss = flat[-1] / f_cnt_g
    total = e_loss + (p * f_loss if energy_and_force else 0.0)
    return {"loss": total, "e_loss": e_loss, "f_loss": f_loss}


def make_dp_train_step(model, optimizer, mesh, *, axis: str = "data",
                       loss_fn: Optional[Callable] = None,
                       energy_and_force: bool = False, p: float = 100.0,
                       target_key: str = "y"):
    """Returns ``train_step(g) -> aux``: one DP step over this rank's slab
    ``g``. ``model`` must be the same on every rank
    (:func:`~dig_tpu_torch.parallel.mesh.replicate`); gradients are summed
    over ``axis`` after the global-count division, so every rank applies
    the same update. ``loss_fn``: the elementwise error (default
    ``abs``)."""
    err = loss_fn or torch.abs
    group = mesh.get_group(axis)
    params = [q for q in model.parameters() if q.requires_grad]

    def train_step(g: GraphBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        aux = dp_loss_step(model, params, g, group, err=err,
                           energy_and_force=energy_and_force, p=p,
                           target_key=target_key)
        optimizer.step()
        return aux

    return train_step


def make_dp_eval_step(model, mesh, *, axis: str = "data"):
    """Returns ``eval_step(g) -> (predictions, graph_mask)`` of this rank's
    slab."""

    @torch.no_grad()
    def eval_step(g: GraphBatch):
        return model(g), g.graph_mask

    return eval_step
