"""GraphAF — continuous masked autoregressive flow for molecule generation
(port of ``dig_tpu.ggraph.models.graphaf``).

Parity with ``dig/ggraph/method/GraphAF/model/{graphaf.py,graphflow.py,
st_net.py}``: GraphDF's mask schedule and RGCN embeddings, affine coupling
x' = x * s + t with sigmoid-parameterized scales (ST_Net_Sigmoid,
st_net.py:5-56), uniform dequantization of the one-hot inputs, and a
standard-normal base with exact log-det.

The dequantization uniforms are drawn apart from the flow
(``GraphFlowModelAF.draw``) and passed in, so a test can feed the JAX
side's draws.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .flow_utils import FlowMasks, build_flow_masks
from .graphdf import FlowCore, link_entries
from .layers import default_generator, linear


class Rescale(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return torch.exp(self.weight) * x


class STNetSigmoid(nn.Module):
    """Linear-tanh-Linear -> (sigmoid(s + shift), t) with learnable
    rescales (reference st_net.py:5-56)."""

    def __init__(self, in_dim: int, output_dim: int, hid_dim: int = 128,
                 sigmoid_shift: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.output_dim = output_dim
        self.sigmoid_shift = sigmoid_shift
        self.lin1 = linear(in_dim, hid_dim, gen)
        # second linear init ~0 so the flow starts near identity
        self.lin2 = linear(hid_dim, output_dim * 2, gen, init="tiny")
        self.rescale1 = Rescale()
        self.rescale2 = Rescale()

    def forward(self, emb):
        out = self.rescale1(self.lin2(torch.tanh(self.lin1(emb))))
        s = out[..., :self.output_dim]
        t = out[..., self.output_dim:]
        s = self.rescale2(torch.sigmoid(s + self.sigmoid_shift))
        return s, t


def _logabs(s, dims):
    return torch.log(s.abs() + 1e-12).sum(dim=dims)


class MaskedGraphAF(FlowCore):
    """Flow core (reference GraphAF/model/graphaf.py:9-318)."""

    def __init__(self, masks: FlowMasks, num_flow_layer: int = 12,
                 graph_size: int = 38, num_node_type: int = 9,
                 num_edge_type: int = 4, use_bn: bool = True,
                 num_rgcn_layer: int = 3, nhid: int = 128, nout: int = 128,
                 generator: Optional[torch.Generator] = None):
        gen = default_generator(generator)
        super().__init__(masks, graph_size, num_node_type, num_edge_type,
                         use_bn, num_rgcn_layer, nhid, nout, gen)
        self.num_flow_layer = num_flow_layer
        self.node_st = nn.ModuleList(
            STNetSigmoid(nout, num_node_type, nhid, generator=gen)
            for _ in range(num_flow_layer))
        self.edge_st = nn.ModuleList(
            STNetSigmoid(3 * nout, num_edge_type, nhid, generator=gen)
            for _ in range(num_flow_layer))

    def forward(self, x, adj, x_deq, adj_deq):
        """Returns ((z_node, z_edge), (logdet_node, logdet_edge))."""
        emb_node, emb_edge = self.all_embs(x, adj)
        logdet_n = x.new_zeros(x.shape[0])
        logdet_e = x.new_zeros(x.shape[0])
        for i in range(self.num_flow_layer):
            s, t = self.node_st[i](emb_node)
            x_deq = x_deq * s + t
            logdet_n = logdet_n + _logabs(s, (1, 2))
            s, t = self.edge_st[i](emb_edge)
            adj_deq = adj_deq * s + t
            logdet_e = logdet_e + _logabs(s, (1, 2))
        return (x_deq, adj_deq), (logdet_n, logdet_e)

    def _forward_rl(self, sts, emb, action):
        z = action
        logdet = action.new_zeros(action.shape[0])
        for st in sts:
            s, t = st(emb)
            z = z * s + t
            logdet = logdet + _logabs(s, -1)
        return z, logdet

    def forward_rl_node(self, x, adj, action):
        """(z, logdet) of a recorded node action on the current canvas
        (running statistics; reference GraphAF graphflow_rl
        forward_rl_node)."""
        return self._forward_rl(self.node_st, self.embs_node(x, adj), action)

    def forward_rl_edge(self, x, adj, action, edge_index):
        return self._forward_rl(self.edge_st,
                                self.embs_edge(x, adj, edge_index), action)

    def reverse_node(self, x, adj, latent):
        emb = self.embs_node(x, adj)
        for i in reversed(range(self.num_flow_layer)):
            s, t = self.node_st[i](emb)
            latent = (latent - t) / s
        return latent

    def reverse_edge(self, x, adj, latent, edge_index):
        emb = self.embs_edge(x, adj, edge_index)
        for i in reversed(range(self.num_flow_layer)):
            s, t = self.edge_st[i](emb)
            latent = (latent - t) / s
        return latent


_LOG_2PI = math.log(2 * math.pi)


def _gauss_ll(z, dims):
    return -0.5 * (_LOG_2PI + z ** 2).sum(dim=dims)


class GraphFlowModelAF(nn.Module):
    """GraphAF top (reference GraphAF/model/graphflow.py): dequantized
    forward + Gaussian log-prob."""

    def __init__(self, max_size: int, edge_unroll: int, node_dim: int,
                 bond_dim: int, num_flow_layer: int = 12,
                 num_rgcn_layer: int = 3, nhid: int = 128, nout: int = 128,
                 deq_coeff: float = 0.9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.max_size, self.edge_unroll = max_size, edge_unroll
        self.node_dim, self.bond_dim = node_dim, bond_dim
        self.deq_coeff = deq_coeff
        self.masks = build_flow_masks(max_size, edge_unroll)
        self.flow_core = MaskedGraphAF(
            self.masks, num_flow_layer, max_size, node_dim, bond_dim, True,
            num_rgcn_layer, nhid, nout, generator=gen)

    @property
    def total_len(self) -> int:
        return (self.max_size * self.node_dim
                + self.masks.num_edge_steps * self.bond_dim)

    def draw(self, gen: torch.Generator, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dequantization uniforms of one forward: [B, N, node_dim]
        and [B, S, bond_dim], on the generator's device, moved to x's."""
        B = x.shape[0]
        gd = gen.device
        u_x = torch.rand(x.shape, generator=gen, device=gd)
        u_e = torch.rand((B, self.masks.num_edge_steps, self.bond_dim),
                         generator=gen, device=gd)
        return u_x.to(x.device), u_e.to(x.device)

    def forward(self, x, adj, noise):
        """noise: (u_x, u_adj) from ``draw``."""
        u_x, u_e = noise
        adj_deq = link_entries(adj, self.flow_core.link_index)
        x_deq = x + self.deq_coeff * u_x
        adj_deq = adj_deq + self.deq_coeff * u_e
        return self.flow_core(x, adj, x_deq, adj_deq)

    def log_prob(self, z, logdet):
        """Standard-normal base log-likelihood + logdet, averaged and
        normalized per latent dim (reference graphflow.py:285-299)."""
        (zn, ze), (ldn, lde) = z, logdet
        ll = _gauss_ll(zn, (1, 2)) + _gauss_ll(ze, (1, 2)) + ldn + lde
        return -ll.mean() / self.total_len

    def loss(self, x, adj, noise):
        z, logdet = self(x, adj, noise)
        return self.log_prob(z, logdet)

    def nll(self, x, adj):
        """Per-sample NLL with deterministic mid-bin dequantization."""
        adj_deq = link_entries(adj, self.flow_core.link_index)
        x_deq = x + 0.5 * self.deq_coeff
        adj_deq = adj_deq + 0.5 * self.deq_coeff
        (zn, ze), (ldn, lde) = self.flow_core(x, adj, x_deq, adj_deq)
        ll = _gauss_ll(zn, (1, 2)) + _gauss_ll(ze, (1, 2)) + ldn + lde
        return -ll / self.total_len

    def reverse_node(self, x, adj, latent):
        return self.flow_core.reverse_node(x, adj, latent)

    def reverse_edge(self, x, adj, latent, edge_index):
        return self.flow_core.reverse_edge(x, adj, latent, edge_index)

    def rl_node_ll(self, x, adj, action, node_step):
        """Gaussian-base log-likelihood of recorded node actions [B]
        (PPO fine-tune; reference GraphAF graphflow_rl)."""
        del node_step  # continuous flow: base is a standard normal
        z, logdet = self.flow_core.forward_rl_node(
            x, adj, action + 0.5 * self.deq_coeff)
        return _gauss_ll(z, -1) + logdet

    def rl_edge_ll(self, x, adj, action, edge_index, edge_cnt):
        del edge_cnt
        z, logdet = self.flow_core.forward_rl_edge(
            x, adj, action + 0.5 * self.deq_coeff, edge_index)
        return _gauss_ll(z, -1) + logdet
