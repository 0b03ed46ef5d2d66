"""The port's SphereNet on the slot layout with the slot kernels, its
Adam and its train step, as a user builds them (``dig_tpu_torch``)."""
from __future__ import annotations

import torch

from ..core.weights import load_into

MODEL_KEYS = ("cutoff", "num_layers", "hidden_channels", "out_channels",
              "int_emb_size", "basis_emb_size_dist", "basis_emb_size_angle",
              "basis_emb_size_torsion", "out_emb_channels", "num_spherical",
              "num_radial", "envelope_exponent", "num_before_skip",
              "num_after_skip", "num_output_layers", "nk_degree")


def build(cfg: dict, traffic: dict, weights: dict, device):
    """``(model, optimizer, train_step)``: energy training through
    ``make_step_fns`` (target ``energy`` = y_0), energy+force training
    through ``make_bucketed_step_fns``."""
    from dig_tpu_torch.models import SphereNet
    from dig_tpu_torch.train import make_bucketed_step_fns, make_step_fns

    model = SphereNet(**{k: cfg[k] for k in MODEL_KEYS},
                      block_size=max(int(s) for s in traffic["slots"]),
                      compute_dtype=torch.float32, pallas_triplet=True,
                      pallas_fuse_basis=True, pallas_slot=True,
                      device=device)
    load_into(model, weights)
    opt = torch.optim.Adam(model.parameters(), lr=traffic["lr"])
    if traffic["kind"] == "energy_force":
        step, _ = make_bucketed_step_fns(
            model, opt, p=traffic["loss"]["force_weight"])
    else:
        step, _ = make_step_fns(model, opt, loss="l1", target_key="energy")
    return model, opt, step


def pool(cfg: dict, traffic: dict, groups, device):
    """The batches of ``groups`` through the port's loaders, on ``device``:
    ``BucketedMoleculeLoader`` batches ``{slot: GraphBatch}``, or
    ``MoleculeLoader`` batches in slots of the one slot size."""
    from dig_tpu_torch.datasets import BucketedMoleculeLoader, MoleculeLoader

    mols = [m for g in groups for m in g]
    slots = {int(s): c for s, c in traffic["slots"].items()}
    if traffic["loader"] == "bucketed":
        out = list(BucketedMoleculeLoader(mols, slots, shuffle=False,
                                          device=device))
    else:
        (slot, count), = slots.items()
        out = [b.replace_globals(energy=b.globals["y"][:, :1])
               for b in MoleculeLoader(mols, count, slot_size=slot,
                                       shuffle=False, device=device)]
    if len(out) != len(groups):
        raise RuntimeError(f"{len(groups)} groups made {len(out)} batches")
    return out
