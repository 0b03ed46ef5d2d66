"""Training steps. Port of ``make_step_fns`` (``dig_tpu/train/trainer.py:55-127``,
energy training) and of the bucketed dense step of ``bench.py:787-800``.

``make_step_fns`` trains on flat ``GraphBatch``es: the loss is the L1 (or
L2) energy error masked by ``graph_mask`` (``_masked_mean``). Energy+force
training (force = -dE/dpos, a double backward) waits for the second-order
triplet kernel: it raises. ``make_dense_step_fns`` runs the model once per
slot bucket of a ``{n_max: DenseGraphBatch}`` batch and averages over every
molecule of every bucket (``mol_mask``). ``Run3D`` is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..graph import GraphBatch
from ..graph_dense import DenseGraphBatch

Batches = Dict[int, DenseGraphBatch]


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.reshape(mask.shape + (1,) * (err.ndim - mask.ndim))
    s = torch.sum(torch.where(m, err, 0.0))
    cnt = torch.clamp(torch.sum(mask) * (err.numel() // mask.numel()), min=1)
    return s / cnt


def make_step_fns(model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, *,
                  energy_and_force: bool = False, loss: str = "l1",
                  target_key: str = "y"):
    """Build ``(train_step, eval_step)`` over flat ``GraphBatch``es.

    ``train_step(g)`` -> ``{"loss": tensor}`` after one optimizer step;
    ``eval_step(g)`` -> ``{"y_pred", "graph_mask"}`` without gradients.
    ``loss`` ('l1' | 'l2') applies to the energies; the target
    ``globals[target_key]`` broadcasts against the ``[G, out]`` prediction
    as in the JAX step.
    """
    if loss not in ("l1", "l2"):
        raise ValueError(f"loss must be 'l1' or 'l2', got {loss!r}")
    err_fn = torch.abs if loss == "l1" else torch.square

    if energy_and_force and not getattr(model, "pallas_basis_grads", True):
        # with basis cotangents elided, dE/dpos SILENTLY drops the
        # basis->position path: reject rather than train on garbage
        raise ValueError(
            "energy_and_force requires pallas_basis_grads=True: "
            "pallas_basis_grads=False elides the basis cotangents, so "
            "dE/dpos would silently drop the basis->position path")
    if energy_and_force:
        raise NotImplementedError(
            "energy_and_force needs the second-order triplet kernel "
            "(pallas_triplet_slot.py:501 _run_bwd2): the SphereNet "
            "force-training slice, ROADMAP queue 2 item 3")

    def compute_loss(g: GraphBatch) -> torch.Tensor:
        y = g.globals[target_key]
        if y.ndim == 1:
            y = y[:, None]
        e = model(g)
        return _masked_mean(err_fn(e - y), g.graph_mask)

    def train_step(g: GraphBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total = compute_loss(g)
        total.backward()
        optimizer.step()
        return {"loss": total.detach()}

    @torch.no_grad()
    def eval_step(g: GraphBatch):
        return {"y_pred": model(g), "graph_mask": g.graph_mask}

    return train_step, eval_step


def dense_loss(model: torch.nn.Module, batches: Batches,
               loss: str = "l1") -> torch.Tensor:
    """Energy error over every molecule of every bucket (packed batches:
    ``globals['mol_mask']``)."""
    if loss not in ("l1", "l2"):
        raise ValueError(f"loss must be 'l1' or 'l2', got {loss!r}")
    err_fn = torch.abs if loss == "l1" else torch.square
    errs, masks = [], []
    for k in sorted(batches):                      # one model, all buckets
        b = batches[k]
        e = model(b)                               # [G, M, out]
        y = b.globals["y"][..., :e.shape[-1]]
        errs.append(err_fn(e - y).reshape(-1))
        masks.append(b.globals["mol_mask"][..., None].expand_as(e)
                     .reshape(-1))
    return _masked_mean(torch.cat(errs), torch.cat(masks))


def make_dense_step_fns(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        loss: str = "l1"):
    """Build ``(train_step, eval_step)`` over ``{n_max: DenseGraphBatch}``.

    ``train_step(batches)`` -> ``{"loss": tensor}`` after one optimizer
    step. ``eval_step(batches)`` -> ``{n_max: {"y_pred", "mol_mask"}}``
    without gradients.
    """

    def train_step(batches: Batches) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total = dense_loss(model, batches, loss)
        total.backward()
        optimizer.step()
        return {"loss": total.detach()}

    @torch.no_grad()
    def eval_step(batches: Batches):
        return {k: {"y_pred": model(b), "mol_mask": b.globals["mol_mask"]}
                for k, b in batches.items()}

    return train_step, eval_step


def step_lr(lr: float, decay_factor: float, decay_epochs: int,
            steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR schedule as a function of the step: ``lr * decay_factor **
    (step // (decay_epochs * steps_per_epoch))`` (optax
    ``exponential_decay(staircase=True)``, as the JAX package uses)."""
    period = max(decay_epochs * steps_per_epoch, 1)
    return lambda step: lr * decay_factor ** (step // period)
