"""The port's SchNetDense with the fused cfconv kernels, energy only, its
Adam and its train step, as a user builds them (``dig_tpu_torch``)."""
from __future__ import annotations

import torch

from ..core.weights import load_into


def build(cfg: dict, traffic: dict, weights: dict, device):
    """``(model, optimizer, train_step)`` of ``make_dense_step_fns`` (L1
    energy loss over every molecule of every bucket)."""
    from dig_tpu_torch.models import SchNetDense
    from dig_tpu_torch.train import make_dense_step_fns

    model = SchNetDense(cutoff=cfg["cutoff"], num_layers=cfg["num_layers"],
                        hidden_channels=cfg["hidden_channels"],
                        out_channels=cfg["out_channels"],
                        num_filters=cfg["num_filters"],
                        num_gaussians=cfg["num_gaussians"],
                        compute_dtype=torch.float32, use_kernel=True,
                        pos_grads=cfg["pos_grads"], device=device)
    load_into(model, weights)
    opt = torch.optim.Adam(model.parameters(), lr=traffic["lr"])
    step, _ = make_dense_step_fns(model, opt, loss=traffic["loss"]["energy"])
    return model, opt, step


def pool(cfg: dict, traffic: dict, groups, device):
    """``BucketedDenseMoleculeLoader`` batches ``{n_max:
    DenseGraphBatch}`` of ``groups``, on ``device``."""
    from dig_tpu_torch.datasets import BucketedDenseMoleculeLoader

    mols = [m for g in groups for m in g]
    slots = {int(s): c for s, c in traffic["slots"].items()}
    out = list(BucketedDenseMoleculeLoader(
        mols, slots, max_per_slot=traffic["max_per_slot"], shuffle=False,
        device=device))
    if len(out) != len(groups):
        raise RuntimeError(f"{len(groups)} groups made {len(out)} batches")
    return out
