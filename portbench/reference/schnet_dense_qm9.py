"""Plain reference of SchNet (DIG's ``schnet.py``, the continuous-filter
convolution of Schütt et al. 2017) at the configuration's widths, energy
training.

Per molecule: all ordered atom pairs i != j closer than the cutoff are
edges; the filter W(d) = Linear(ssp(Linear(rbf(d)))) times the cosine
cutoff; each interaction adds Linear(ssp(Linear(sum_j W(d_ij) *
Linear(v_j)))) to v; the energy is the sum over atoms of
Linear(ssp(Linear(v))). rbf: 50 Gaussians on [0, cutoff]. The loss is
the mean over molecules of |E - y_0| (L1).

Departures from DIG, as the port has them: the neighbour list is every
pair within the cutoff (DIG's radius_graph keeps at most 32 a node), and
the weights' init is the seed's. The molecules are padded to the longest
of a block; padding contributes exactly zero.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import (Precision, accumulate, chunks, linear_spec,
                     shifted_softplus)

CHUNK = 128          # molecules a block of the reference's work


def param_spec(cfg: dict):
    H, F, R = cfg["hidden_channels"], cfg["num_filters"], cfg["num_gaussians"]
    spec = [("embedding.weight", (100, H), ("normal", 1.0))]
    for l in range(cfg["num_layers"]):
        p = f"interactions.{l}"
        spec += linear_spec(f"{p}.lin_vj", H, F, False)
        spec += linear_spec(f"{p}.mlp.layers.0", R, F, True)
        spec += linear_spec(f"{p}.mlp.layers.1", F, F, True)
        spec += linear_spec(f"{p}.lin1", F, H, True)
        spec += linear_spec(f"{p}.lin2", H, H, True)
    spec += linear_spec("out1", H, H // 2, True)
    spec += linear_spec("out2", H // 2, cfg["out_channels"], True)
    return spec


def pad(mols, device):
    """``(z [M, n], pos [M, n, 3], mask [M, n])`` of a list of molecules,
    n the most atoms among them."""
    n = max(len(m["z"]) for m in mols)
    M = len(mols)
    z = np.zeros((M, n), np.int64)
    pos = np.zeros((M, n, 3), np.float32)
    mask = np.zeros((M, n), bool)
    for i, m in enumerate(mols):
        k = len(m["z"])
        z[i, :k], pos[i, :k], mask[i, :k] = m["z"], m["pos"], True
    t = lambda a: torch.from_numpy(a).to(device)
    return t(z), t(pos), t(mask)


def pairs(pos, mask, cutoff):
    """``(dist, adj)``: distances ``[M, n, n]`` and the in-cutoff pairs of
    real atoms, i != j."""
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-12))
    n = pos.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    adj = mask[:, :, None] & mask[:, None, :] & ~eye & (dist < cutoff)
    return dist, adj


def energies(P, z, pos, mask, cfg, prec: Precision):
    cutoff, R = cfg["cutoff"], cfg["num_gaussians"]
    lin = lambda x, name, b=True: prec.linear(
        x, P[f"{name}.weight"], P[f"{name}.bias"] if b else None)
    dist, adj = pairs(pos, mask, cutoff)
    offset = torch.linspace(0.0, cutoff, R, device=pos.device)
    coeff = -0.5 / (cutoff / (R - 1)) ** 2
    rbf = torch.exp(coeff * (dist[..., None] - offset) ** 2)
    gate = 0.5 * (torch.cos(dist * (math.pi / cutoff)) + 1.0) * adj
    v = P["embedding.weight"][z] * mask[..., None]
    for l in range(cfg["num_layers"]):
        p = f"interactions.{l}"
        vj = lin(v, f"{p}.lin_vj", False)
        W = lin(shifted_softplus(lin(rbf, f"{p}.mlp.layers.0")),
                f"{p}.mlp.layers.1") * gate[..., None]
        agg = prec.einsum("gijf,gjf->gif", W, vj)
        out = lin(shifted_softplus(lin(agg, f"{p}.lin1")), f"{p}.lin2")
        v = v + out * mask[..., None]
    h = lin(shifted_softplus(lin(v, "out1")), "out2") * mask[..., None]
    return h.sum(1)[:, 0]


def loss_and_grads(P, mols, cfg, traffic, prec: Precision):
    """The mean over ``mols`` of |E - y_0| and its gradient, in blocks of
    ``CHUNK`` molecules."""
    names = list(P)
    leaves = [P[k].detach().requires_grad_() for k in names]
    Pg = dict(zip(names, leaves))
    dev = leaves[0].device
    total, grads = 0.0, None
    for part in chunks(mols, CHUNK):
        z, pos, mask = pad(part, dev)
        y = torch.tensor(np.array([m["y"][0] for m in part]), device=dev)
        loss = torch.sum(torch.abs(energies(Pg, z, pos, mask, cfg, prec)
                                   - y)) / len(mols)
        g = torch.autograd.grad(loss, leaves)
        grads = accumulate(grads, dict(zip(names, g)))
        total += float(loss.detach())
    return total, grads
