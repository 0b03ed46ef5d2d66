"""Weights from the seed, made on the run's device in one draw.

``spec`` is the reference's list of ``(name, shape, init)``: ``("normal",
std)`` takes its slice of one standard-normal draw scaled by ``std``,
``("zeros",)`` zeros and ``("values", [...])`` the given numbers. The
same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math

import torch


def draw(spec, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    total = sum(math.prod(shape) for _, shape, init in spec
                if init[0] == "normal")
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) * init[1]
            at += n
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.tensor(init[1], dtype=torch.float32,
                                     device=device).view(shape)
    return out


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the model's parameters, which must be exactly
    the names and shapes of the spec."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            f"the program's parameters differ from the reference's: only "
            f"the program has {sorted(set(params) - set(weights))}, only "
            f"the reference {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f"{name}: program shape {tuple(p.shape)}, "
                                   f"reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])
