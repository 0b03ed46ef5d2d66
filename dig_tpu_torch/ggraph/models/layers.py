"""Layers and initializers shared by the ggraph models.

Weights are drawn on the CPU from an explicit ``torch.Generator`` with
flax's initializers (``glorot_uniform`` for the kernels given
``kernel_init=xavier``, ``lecun_normal`` for a default ``Dense``, zero
biases, a truncated normal of std ``1/sqrt(features)`` for ``Embed``), so
the port's own init draws from the JAX package's distributions; parity
tests load the JAX weights instead (``dig_tpu_torch.convert``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# flax's truncated-normal correction: the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


@torch.no_grad()
def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    gen: torch.Generator) -> torch.Tensor:
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return t.copy_(torch.rand(t.shape, generator=gen) * (2 * a) - a)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float,
                  gen: torch.Generator) -> torch.Tensor:
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=gen)


def linear(i: int, o: int, gen: torch.Generator, bias: bool = True,
           init: str = "xavier") -> nn.Linear:
    """A flax ``Dense(o)`` on ``i`` inputs: ``init`` "xavier"
    (glorot_uniform), "lecun" (flax's default, lecun_normal) or "tiny"
    (the constant 1e-10 of GraphAF's ST nets); zero bias."""
    lin = nn.Linear(i, o, bias=bias)
    if init == "xavier":
        glorot_uniform_(lin.weight, i, o, gen)
    elif init == "lecun":
        trunc_normal_(lin.weight, math.sqrt(1.0 / i), gen)
    elif init == "tiny":
        nn.init.constant_(lin.weight, 1e-10)
    else:
        raise ValueError(f"unknown init {init!r}")
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def embedding(n: int, features: int, gen: torch.Generator) -> nn.Embedding:
    """flax ``Embed(n, features)``: a truncated normal of std
    1/sqrt(features)."""
    emb = nn.Embedding(n, features)
    trunc_normal_(emb.weight, math.sqrt(1.0 / features), gen)
    return emb


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``'s parametrization (``ir``, ``iz``, ``in`` with
    bias; ``hr``, ``hz`` without; ``hn`` with):
    r = sig(ir(x) + hr(h)), z = sig(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h.
    torch's ``nn.GRUCell`` carries a bias on every recurrent gate, whose
    Adam steps would differ from flax's. The input kernels draw from
    glorot_uniform (the JAX modules pass ``kernel_init=xavier``), the
    recurrent ones are orthogonal (flax's default)."""

    def __init__(self, in_features: int, hidden: int,
                 gen: torch.Generator):
        super().__init__()
        for name in ("ir", "iz", "in"):
            setattr(self, name, linear(in_features, hidden, gen))
        for name in ("hr", "hz", "hn"):
            lin = nn.Linear(hidden, hidden, bias=name == "hn")
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=gen)
                if lin.bias is not None:
                    nn.init.zeros_(lin.bias)
            setattr(self, name, lin)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h
