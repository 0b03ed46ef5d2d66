"""Training steps and the epoch driver. Port of ``dig_tpu/train/trainer.py``
(``make_train_state``, ``make_step_fns``, ``step_lr``, ``Run3D``,
``evaluate``), of the
bucketed dense step of ``bench.py:787-800`` and of the bucketed SphereNet
force step of ``bench.py:238-256``.

``make_step_fns`` trains on flat ``GraphBatch``es: the loss is the L1 (or
L2) energy error masked by ``graph_mask`` (``_masked_mean``), plus, with
``energy_and_force``, ``p`` times the force error masked by ``node_mask``,
where force = -dE/dpos is taken with ``create_graph`` inside the loss (the
reference's double autograd, ``dig/threedgraph/method/run.py:126``), so
the step differentiates the model twice. ``make_dense_step_fns`` runs the
model once per slot bucket of a ``{n_max: DenseGraphBatch}`` batch;
``make_bucketed_step_fns`` runs one model (one parameter set) once per
bucket of a ``BucketedMoleculeLoader`` batch with forces. ``Run3D`` is the
epoch loop (Adam or AdamW, StepLR, best-valid checkpoints).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..graph_dense import DenseGraphBatch
from .metrics import MetricLogger, Throughput

Batches = Dict[int, DenseGraphBatch]
Buckets = Dict[int, GraphBatch]


@dataclasses.dataclass
class TrainState:
    """The port's train state: the module (holding its weights), its
    optimizer and the number of steps taken. The JAX ``TrainState`` holds
    ``params``, ``opt_state`` and ``step`` as values; here the steps of
    :func:`make_step_fns` update ``model`` and ``optimizer`` in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_state(model: Callable[[torch.Generator], torch.nn.Module],
                     optimizer: Callable[..., torch.optim.Optimizer],
                     example_batch, seed: int = 42) -> TrainState:
    """The JAX ``make_train_state(model, optimizer, example_batch, seed)``
    in PyTorch's idiom. ``model`` builds the module from a
    ``torch.Generator`` seeded with ``seed`` (the JAX
    ``model.init(PRNGKey(seed), ...)``); the module runs once on
    ``example_batch`` without gradients, so that layers sized by their
    first input exist. ``optimizer`` builds the optimizer from the
    module's trainable parameters (the optax transformation's ``init``).
    Returns ``TrainState(model, optimizer, step=0)``."""
    model = model(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model(example_batch)
    return TrainState(model=model, optimizer=optimizer(_trainable(model)),
                      step=0)


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.reshape(mask.shape + (1,) * (err.ndim - mask.ndim))
    s = torch.sum(torch.where(m, err, 0.0))
    cnt = torch.clamp(torch.sum(mask) * (err.numel() // mask.numel()), min=1)
    return s / cnt


def _err_fn(loss: str):
    if loss not in ("l1", "l2"):
        raise ValueError(f"loss must be 'l1' or 'l2', got {loss!r}")
    return torch.abs if loss == "l1" else torch.square


def energy_force(model: torch.nn.Module, g: GraphBatch,
                 create_graph: bool = True, **model_kw):
    """``(e [G, out], force [N, 3])`` with force = -d(sum of the real
    graphs' energies)/dpos. ``create_graph`` keeps the force's graph, so a
    loss on it trains the model (a double backward)."""
    pos = g.nodes["pos"].detach().requires_grad_()
    e = model(g.replace_nodes(pos=pos), **model_kw)
    esum = torch.sum(torch.where(g.graph_mask[:, None], e, 0.0))
    (gpos,) = torch.autograd.grad(esum, pos, create_graph=create_graph)
    return e, -gpos


def _trainable(model: torch.nn.Module):
    return [p for p in model.parameters() if p.requires_grad]


def make_step_fns(model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, *,
                  energy_and_force: bool = False, p: float = 100.0,
                  loss: str = "l1", target_key: str = "y"):
    """Build ``(train_step, eval_step)`` over flat ``GraphBatch``es.

    ``train_step(g)`` -> ``{"loss"}`` (with ``energy_and_force`` also
    ``"e_loss"`` and ``"f_loss"``; ``loss = e_loss + p * f_loss``) after
    one optimizer step. ``eval_step(g)`` -> ``{"y_pred", "graph_mask"}``,
    with ``energy_and_force`` also ``{"force_pred", "node_mask"}``.
    ``loss`` ('l1' | 'l2') applies to energies and forces; the target
    ``globals[target_key]`` broadcasts against the ``[G, out]`` prediction
    as in the JAX step, the forces are ``nodes["force"]``.
    """
    err_fn = _err_fn(loss)
    if energy_and_force and not getattr(model, "pallas_basis_grads", True):
        # with basis cotangents elided, dE/dpos SILENTLY drops the
        # basis->position path: reject rather than train on garbage
        raise ValueError(
            "energy_and_force requires pallas_basis_grads=True: "
            "pallas_basis_grads=False elides the basis cotangents, so "
            "dE/dpos would silently drop the basis->position path")
    params = _trainable(model)

    def compute_loss(g: GraphBatch) -> Dict[str, torch.Tensor]:
        y = g.globals[target_key]
        if y.ndim == 1:
            y = y[:, None]
        if not energy_and_force:
            return {"loss": _masked_mean(err_fn(model(g) - y), g.graph_mask)}
        e, force = energy_force(model, g)
        e_loss = _masked_mean(err_fn(e - y), g.graph_mask)
        f_loss = _masked_mean(err_fn(force - g.nodes["force"]), g.node_mask)
        return {"loss": e_loss + p * f_loss, "e_loss": e_loss,
                "f_loss": f_loss}

    def train_step(g: GraphBatch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        aux = compute_loss(g)
        # with forces, the parameters only: the positions' own gradient
        # is not needed
        aux["loss"].backward(inputs=params if energy_and_force else None)
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    def eval_step(g: GraphBatch):
        if not energy_and_force:
            with torch.no_grad():
                return {"y_pred": model(g), "graph_mask": g.graph_mask}
        with torch.enable_grad():
            e, force = energy_force(model, g, create_graph=False)
        return {"y_pred": e.detach(), "graph_mask": g.graph_mask,
                "force_pred": force.detach(), "node_mask": g.node_mask}

    return train_step, eval_step


def bucketed_force_loss(model: torch.nn.Module, batches: Buckets,
                        p: float = 100.0) -> torch.Tensor:
    """The loss of ``bench.py:241-256`` over a ``{slot_size: GraphBatch}``
    batch: ``(sum |E - y| graph_mask + p sum |F_pred - F| node_mask) /
    max(real graphs, 1)``, summed over every bucket, the model applied to
    each bucket at its slot size. Forces keep their graph."""
    num, den = 0.0, 0
    for s, g in batches.items():
        e, force = energy_force(model, g, block_size=s)
        num = num + torch.sum(torch.abs(e[:, 0] - g.globals["y"][:, 0])
                              * g.graph_mask)
        num = num + p * torch.sum(torch.abs(force - g.nodes["force"])
                                  * g.node_mask[:, None])
        den = den + torch.sum(g.graph_mask)
    return num / torch.clamp(den, min=1)


def make_bucketed_step_fns(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer, *,
                           p: float = 100.0):
    """Build ``(train_step, eval_step)`` of energy+force training over
    ``BucketedMoleculeLoader`` batches ``{slot_size: GraphBatch}``.

    One model, so one parameter set, serves every bucket
    (``model(g, block_size=slot_size)``). ``train_step(batches)`` ->
    ``{"loss"}`` (:func:`bucketed_force_loss`) after one backward and one
    optimizer step. ``eval_step(batches)`` -> ``{slot_size: {"y_pred",
    "force_pred", "graph_mask", "node_mask"}}``.
    """
    params = _trainable(model)

    def train_step(batches: Buckets) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total = bucketed_force_loss(model, batches, p)
        total.backward(inputs=params)
        optimizer.step()
        return {"loss": total.detach()}

    def eval_step(batches: Buckets):
        out = {}
        for s, g in batches.items():
            with torch.enable_grad():
                e, force = energy_force(model, g, create_graph=False,
                                        block_size=s)
            out[s] = {"y_pred": e.detach(), "force_pred": force.detach(),
                      "graph_mask": g.graph_mask, "node_mask": g.node_mask}
        return out

    return train_step, eval_step


def dense_loss(model: torch.nn.Module, batches: Batches,
               loss: str = "l1") -> torch.Tensor:
    """Energy error over every molecule of every bucket (packed batches:
    ``globals['mol_mask']``)."""
    err_fn = _err_fn(loss)
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


def evaluate(eval_step, loader, evaluator) -> float:
    """Energy MAE of ``eval_step``'s predictions over ``loader`` (real
    graphs only), by ``evaluator``. Port of the JAX ``evaluate``, which
    takes the train state first and an ``energy_and_force`` flag that it
    does not read; here the model holds its weights, and the flag is gone."""
    preds, trues = [], []
    for g in loader:
        out = eval_step(g)
        m = out["graph_mask"]
        preds.append(out["y_pred"][m].detach().cpu())
        y = g.globals["y"]
        if y.ndim == 1:
            y = y[:, None]
        trues.append(y[m].cpu())
    res = evaluator.eval({"y_pred": torch.cat(preds),
                          "y_true": torch.cat(trues)})
    return float(res["mae"])


class Run3D:
    """Epoch-loop driver with the reference trainer's public surface
    (``run.run(device, train, valid, test, model, loss, evaluator, ...)``):
    slot-aligned ``MoleculeLoader``s, Adam (AdamW with ``weight_decay``)
    under a StepLR schedule, L1/L2 losses, optional energy+force training,
    per-epoch metrics, best-validation tracking and checkpoints
    (``save_dir``, :class:`~dig_tpu_torch.train.checkpoint.Checkpointer`).
    """

    def run(self, train_data, valid_data, test_data, model, evaluator,
            *, epochs: int = 20, batch_size: int = 32,
            vt_batch_size: int = 32, lr: float = 5e-4,
            lr_decay_factor: float = 0.5, lr_decay_step_size: int = 15,
            weight_decay: float = 0.0, energy_and_force: bool = False,
            p: float = 100.0, loss: str = "l1", seed: int = 42,
            save_dir: str = "", log_dir: str = "",
            n_node_pad: Optional[int] = None,
            slot_size: Optional[int] = None,
            quiet: bool = False, profile_dir: str = "",
            debug: bool = False,
            device: DeviceLike = None) -> Dict[str, object]:
        """Train ``model`` for ``epochs`` epochs; returns ``{"best_valid",
        "best_test", "model", "optimizer"}``. ``device`` (default: the
        card) is where the batches and the model go. ``seed`` seeds the
        training loader's shuffle (the model's weights are set when it is
        built). ``profile_dir``: write a ``torch.profiler`` Chrome trace of
        steps 10-14 of the run there (:class:`~dig_tpu_torch.train.
        profiling.StepProfiler`). ``debug``: assert that a step updates the
        weights and optimizer state in place (on a copy of the model), then
        train under NaN checks (:mod:`dig_tpu_torch.train.debug`)."""
        from ..datasets.loader import MoleculeLoader
        from ..ops.radius import _pairwise_same_graph, radius_blocked_dropped
        from .debug import assert_donation_discipline, debug_mode
        from .profiling import StepProfiler

        dev = resolve_device(device)
        model.to(dev)
        # slot_size: slot-aligned batches (one molecule per fixed slot),
        # which the models' block_size layout requires
        train_loader = MoleculeLoader(train_data, batch_size,
                                      n_node_pad=n_node_pad, shuffle=True,
                                      seed=seed, slot_size=slot_size,
                                      device=dev)
        valid_loader = MoleculeLoader(valid_data, vt_batch_size,
                                      n_node_pad=n_node_pad,
                                      slot_size=slot_size, device=dev)
        test_loader = MoleculeLoader(test_data, vt_batch_size,
                                     n_node_pad=n_node_pad,
                                     slot_size=slot_size, device=dev)

        schedule = step_lr(lr, lr_decay_factor, lr_decay_step_size,
                           len(train_loader))
        params = _trainable(model)
        optimizer = (torch.optim.AdamW(params, lr=lr,
                                       weight_decay=weight_decay)
                     if weight_decay else torch.optim.Adam(params, lr=lr))
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda step: schedule(step) / lr)
        train_step, eval_step = make_step_fns(
            model, optimizer, energy_and_force=energy_and_force, p=p,
            loss=loss)

        logger = MetricLogger(log_dir or None, quiet=quiet)
        tp = Throughput()
        # edges are built inside the model, so they are counted here for
        # the edges/s rate
        cutoff = getattr(model, "cutoff", None)
        max_edges = getattr(model, "max_edges", None)
        block_size = getattr(model, "block_size", None)

        def count_edges(g: GraphBatch) -> int:
            d2, valid = _pairwise_same_graph(g.nodes["pos"], g.node_graph,
                                             g.node_mask)
            return int(torch.sum(valid & (d2 < cutoff * cutoff)))

        overflow_warned = blocked_warned = False
        best_valid = best_test = float("inf")
        ckpt_mgr = None
        if save_dir:
            from .checkpoint import Checkpointer
            ckpt_mgr = Checkpointer(save_dir)

        total_steps = epochs * len(train_loader)
        prof = StepProfiler(profile_dir or None,
                            start_step=min(10, max(total_steps - 5, 0)))
        if debug:
            # the check takes steps, so it runs on a copy
            scratch = copy.deepcopy(model)
            opt2 = type(optimizer)(_trainable(scratch),
                                   **optimizer.defaults)
            step2, _ = make_step_fns(scratch, opt2,
                                     energy_and_force=energy_and_force, p=p,
                                     loss=loss)
            example = next(iter(valid_loader))
            assert_donation_discipline(step2, TrainState(scratch, opt2),
                                       example)
        dbg_ctx = debug_mode() if debug else contextlib.nullcontext()

        with dbg_ctx:
            for epoch in range(1, epochs + 1):
                tp.reset()
                losses = []
                for g in train_loader:
                    with prof.step():
                        losses.append(train_step(g)["loss"])
                    scheduler.step()
                    if not cutoff:
                        continue
                    n_edges = count_edges(g)
                    tp.update(n_edges)
                    # static caps silently drop edges: surface it once
                    if (max_edges and n_edges > max_edges
                            and not overflow_warned):
                        print(f"WARNING: batch has {n_edges} radius edges > "
                              f"model.max_edges={max_edges}; overflow is "
                              "dropped — raise max_edges", flush=True)
                        overflow_warned = True
                    # the blocked radius graph drops cross-block same-graph
                    # pairs when the batch is not slot-aligned
                    if block_size and not blocked_warned:
                        n_drop = int(radius_blocked_dropped(
                            g.nodes["pos"], g.node_graph, g.node_mask,
                            cutoff, block_size))
                        if n_drop:
                            print(f"WARNING: {n_drop} radius pairs cross "
                                  "block boundaries and are DROPPED by the "
                                  "blocked radius graph — feed slot-aligned "
                                  "batches (MoleculeLoader(slot_size="
                                  f"{block_size}))", flush=True)
                            blocked_warned = True
                train_loss = float(np.mean([float(x) for x in losses]))
                valid_mae = evaluate(eval_step, valid_loader, evaluator)
                test_mae = evaluate(eval_step, test_loader, evaluator)
                logger.log(epoch, {"train_loss": train_loss,
                                   "valid_mae": valid_mae,
                                   "test_mae": test_mae, **tp.rates()},
                           prefix="")
                if valid_mae < best_valid:
                    best_valid, best_test = valid_mae, test_mae
                    if ckpt_mgr is not None:
                        ckpt_mgr.save({"model": model.state_dict(),
                                       "optimizer": optimizer.state_dict()},
                                      step=epoch,
                                      metrics={"valid_mae": valid_mae,
                                               "test_mae": test_mae})
        prof.stop()
        logger.close()
        return {"best_valid": best_valid, "best_test": best_test,
                "model": model, "optimizer": optimizer}
