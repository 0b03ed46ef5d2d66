"""GraphEBM — energy-based molecule generation with Langevin dynamics
(port of ``dig_tpu.ggraph.models.graphebm``).

Parity with ``dig/ggraph/method/GraphEBM/{graphebm.py,energy_func.py}``:
multi-relational graph-conv energy over dense (adj, x), contrastive
divergence training (pos = dequantized data, neg = Langevin samples from
uniform noise with gradient clamping and [0, 1+c] box projection).

The Langevin loop is a plain loop of ``torch.autograd.grad`` on (x, adj)
(the JAX package scans it). Its noise is drawn apart
(``draw_langevin``) and passed in, so a test can feed the JAX side's
draws.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import default_generator, glorot_uniform_, linear


def swish(x):
    return x * torch.sigmoid(x)


class EBMGraphConv(nn.Module):
    """Per-edge-type dense conv (reference energy_func.py:12-103):
    out = sum_e adj[e] @ (x W_e) (+ self term)."""

    def __init__(self, in_ch: int, out_ch: int, num_edge_type: int = 4,
                 add_self: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.weight = nn.Parameter(glorot_uniform_(
            torch.empty(num_edge_type, in_ch, out_ch),
            in_ch * num_edge_type, out_ch * num_edge_type, gen))
        self.self_lin = linear(in_ch, out_ch, gen) if add_self else None
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, adj, h):
        support = torch.einsum("bnd,edh->benh", h, self.weight)
        out = torch.einsum("benj,bejh->benh", adj, support).sum(dim=1)
        if self.self_lin is not None:
            out = out + self.self_lin(h)
        return out + self.bias


class EnergyFunc(nn.Module):
    """Energy E(adj, x) -> [B, 1] (reference energy_func.py:105-142).
    flax infers the input width; here it is ``n_atom_type``."""

    def __init__(self, n_atom_type: int, hidden: int = 64,
                 num_edge_type: int = 4, depth: int = 2,
                 use_swish: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.use_swish = use_swish
        self.convs = nn.ModuleList(
            EBMGraphConv(n_atom_type if k == 0 else hidden, hidden,
                         num_edge_type, generator=gen)
            for k in range(depth + 1))
        self.out = linear(hidden, 1, gen)

    def forward(self, adj, x):
        act = swish if self.use_swish else (
            lambda v: F.leaky_relu(v, negative_slope=0.2))
        out = x
        for conv in self.convs:
            out = act(conv(adj, out))
        return self.out(out.sum(dim=1))


def rescale_adj(adj):
    """Normalize adjacency by node degree over all edge types."""
    deg = adj.sum(dim=(1, 2), keepdim=True)  # [B, 1, 1, N]
    return adj / deg.clamp_min(1.0)


class LangevinNoise(NamedTuple):
    """The draws of one Langevin run: uniforms of the start [B, N, T] and
    [B, 4, N, N], unit normals of every step [steps, ...] of each."""
    x0: torch.Tensor
    adj0: torch.Tensor
    x_steps: torch.Tensor
    adj_steps: torch.Tensor


def draw_langevin(gen: torch.Generator, shape_x: Sequence[int],
                  shape_adj: Sequence[int], ld_step: int,
                  device=None) -> LangevinNoise:
    """Draw a Langevin run's noise on the generator's device and move it
    to ``device``."""
    gd = gen.device
    dev = gd if device is None else torch.device(device)
    draws = (torch.rand(tuple(shape_x), generator=gen, device=gd),
             torch.rand(tuple(shape_adj), generator=gen, device=gd),
             torch.randn((ld_step,) + tuple(shape_x), generator=gen,
                         device=gd),
             torch.randn((ld_step,) + tuple(shape_adj), generator=gen,
                         device=gd))
    return LangevinNoise(*(d.to(dev) for d in draws))


def langevin_sample(energy: Callable, noise: LangevinNoise,
                    ld_noise: float = 0.005, ld_step_size: float = 30.0,
                    clamp: float = 0.01, c: float = 0.0,
                    grad_energy_extra: Optional[Callable] = None):
    """SGLD from uniform init (graphebm.py:83-130), one step per row of
    ``noise.x_steps``. ``energy(adj, x) -> [B, 1]``; its parameters get no
    gradient. ``grad_energy_extra(x, adj) -> (gx, gadj)`` optionally adds
    an extra objective gradient."""
    x = noise.x0 * (1 + c)
    adj = noise.adj0
    for nx, na in zip(noise.x_steps, noise.adj_steps):
        x = (x + ld_noise * nx).detach().requires_grad_()
        adj = (adj + ld_noise * na).detach().requires_grad_()
        with torch.enable_grad():
            gx, gadj = torch.autograd.grad(energy(adj, x).sum(), (x, adj))
        if grad_energy_extra is not None:
            ex, eadj = grad_energy_extra(x, adj)
            gx = gx + ex
            gadj = gadj + eadj
        gx = gx.clamp(-clamp, clamp)
        gadj = gadj.clamp(-clamp, clamp)
        with torch.no_grad():
            x = (x - ld_step_size * gx).clamp(0.0, 1 + c)
            adj = (adj - ld_step_size * gadj).clamp(0.0, 1.0)
    return x.detach(), adj.detach()
