"""The work of a SchNetDense energy step on one batch: the model FLOPs
from its equations over real atoms and in-cutoff pairs, and the calls of
the port's kernels with their frozen bounds.

Forward FLOPs, per interaction: each in-cutoff directed pair forms its
filter, Gaussians R -> F -> F (2F(R + F)), gates it and multiplies and
adds it into the sum (3F); each atom runs lin_vj, lin1 and lin2 (2HF +
2FH + 2H^2); the readout runs H -> H/2 -> 1 on each atom. Energy training
is 3 times the forward (the backward's two products per forward one).
Activations, the Gaussians and the cutoff are not counted."""
from __future__ import annotations

from ..bounds import cfconv
from ..core.traffic import bucket_of
from ..reference.schnet_dense_qm9 import CHUNK, pad, pairs


def work(cfg: dict, traffic: dict, mols, device) -> dict:
    """``{slot: {"G", "atoms", "pairs"}}`` of one batch's molecules."""
    out = {int(s): {"G": c, "atoms": 0, "pairs": 0}
           for s, c in traffic["slots"].items()}
    for i in range(0, len(mols), CHUNK):
        part = mols[i:i + CHUNK]
        _, pos, mask = pad(part, device)
        _, adj = pairs(pos, mask, cfg["cutoff"])
        per = adj.sum((1, 2)).tolist()
        for m, p in zip(part, per):
            b = out[bucket_of(len(m["z"]), traffic["slots"])]
            b["atoms"] += len(m["z"])
            b["pairs"] += int(p)
    return out


def step_flops(cfg: dict, traffic: dict, w: dict) -> float:
    H, F, R = cfg["hidden_channels"], cfg["num_filters"], cfg["num_gaussians"]
    atoms = sum(b["atoms"] for b in w.values())
    P = sum(b["pairs"] for b in w.values())
    fwd = cfg["num_layers"] * (P * (2 * F * (R + F) + 3 * F)
                               + atoms * (4 * H * F + 2 * H * H))
    fwd += atoms * (2 * H * (H // 2) + 2 * (H // 2))
    return 3.0 * fwd


def kernel_calls(cfg: dict, traffic: dict, w: dict) -> dict:
    """``{family: (launches a step, bound ms a step)}``: a forward and a
    backward cfconv call a layer and bucket (no geometry gradient)."""
    F, R, L = cfg["num_filters"], cfg["num_gaussians"], cfg["num_layers"]
    ms = sum(cfconv.bound_ms(b["G"], n, F, R, b["pairs"], "f32", kind,
                             cfg["pos_grads"])
             for n, b in w.items() for kind in ("fwd", "bwd"))
    return {"cfconv": (2 * L * len(w), L * ms)}
