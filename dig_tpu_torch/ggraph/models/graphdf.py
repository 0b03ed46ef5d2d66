"""GraphDF — discrete normalizing flow for autoregressive molecule
generation (port of ``dig_tpu.ggraph.models.graphdf``).

Parity with ``dig/ggraph/method/GraphDF/model/{graphflow.py,disgraphaf.py,
st_net.py}``: node-then-edge autoregression over dense one-hot tensors,
modular one-hot shifts produced by straight-through argmax ST nets on RGCN
graph embeddings of BFS-masked subgraphs, discrete log-prob against
learnable categorical bases.

* The R masked subgraph views per molecule are one ``[B*R, N, ...]``
  batched RGCN, as in the JAX package.
* ``BatchNormEmb`` is written by hand: the JAX module normalises over
  axes (0, 1) with the biased variance and updates its running statistics
  with that variance (``running = 0.9 running + 0.1 batch``), which
  ``nn.BatchNorm1d`` does not. The training forward uses batch statistics
  and updates the buffers when the module is in ``train()`` mode;
  generation and the RL log-likelihoods use the running ones.
* Generation is two small step functions (``reverse_node`` /
  ``reverse_edge``) driven by a host loop that owns the valency feedback
  (``dig_tpu_torch.ggraph.methods``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .flow_utils import (FlowMasks, build_flow_masks, one_hot_add,
                         one_hot_argmax_st, one_hot_minus)
from .layers import default_generator, linear
from .rgcn import RGCN


class STDis(nn.Module):
    """Discrete ST net: Linear-tanh-Linear -> ST one-hot argmax
    (reference st_net.py:197-223)."""

    def __init__(self, in_dim: int, output_dim: int, hid_dim: int = 128,
                 temperature: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.temperature = temperature
        self.lin1 = linear(in_dim, hid_dim, gen)
        self.lin2 = linear(hid_dim, output_dim, gen)

    def logits(self, emb: torch.Tensor) -> torch.Tensor:
        return self.lin2(torch.tanh(self.lin1(emb)))

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return one_hot_argmax_st(self.logits(emb), self.temperature)


class BatchNormEmb(nn.Module):
    """Feature-axis batch norm over node embeddings ``[B, N, d]`` with
    running statistics (reference BatchNorm1d at disgraphaf.py:31).

    ``use_running_average=None`` means ``not self.training``. With batch
    statistics (mean and biased variance over (B, N)) the running buffers
    move by ``momentum`` when the module is training; they never move at
    construction."""

    def __init__(self, d: int, momentum: float = 0.9):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("mean", torch.zeros(d))
        self.register_buffer("var", torch.ones(d))

    def forward(self, h: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean = h.mean(dim=(0, 1))
            var = (h - mean).square().mean(dim=(0, 1))
            if self.training:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        return (h - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias


class FlowCore(nn.Module):
    """What GraphDF's and GraphAF's flow cores share: the RGCN and batch
    norm, the masked-view embeddings of training and the canvas
    embeddings of generation. Subclasses add their ST nets."""

    def __init__(self, masks: FlowMasks, graph_size: int, num_node_type: int,
                 num_edge_type: int, use_bn: bool, num_rgcn_layer: int,
                 nhid: int, nout: int, gen: torch.Generator):
        super().__init__()
        self.graph_size = graph_size
        self.num_node_type = num_node_type
        self.num_edge_type = num_edge_type
        self.rgcn = RGCN(num_node_type, nhid, nout, num_edge_type - 1,
                         num_rgcn_layer, generator=gen)
        self.bn = BatchNormEmb(nout) if use_bn else None
        self.register_buffer("node_masks", torch.from_numpy(masks.node_masks),
                             persistent=False)
        self.register_buffer("adj_masks", torch.from_numpy(masks.adj_masks),
                             persistent=False)
        self.register_buffer("link_index", torch.from_numpy(masks.link_index),
                             persistent=False)

    def all_embs(self, x: torch.Tensor, adj: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training embeddings of every masked view: node steps [B, N, d]
        (graph sums) and edge steps [B, S, 3d] ([emb(j); emb(i); graph])."""
        B = x.shape[0]
        R = self.node_masks.shape[0]
        N = self.graph_size
        zero = x.new_zeros(())
        xm = torch.where(self.node_masks[None, :, :, None], x[:, None], zero)
        xm = xm.reshape(B * R, N, self.num_node_type)
        adjm = torch.where(self.adj_masks[None, :, None], adj[:, None, :3],
                           zero)
        adjm = adjm.reshape(B * R, 3, N, N)
        h = self.rgcn(xm, adjm)                          # [B*R, N, d]
        if self.bn is not None:
            h = self.bn(h, use_running_average=False)
        h = h.reshape(B, R, N, -1)
        graph_emb = h.sum(dim=2)                         # [B, R, d]
        emb_node = graph_emb[:, :N]
        h_edge = h[:, N:]                                # [B, S, N, d]
        S = h_edge.shape[1]
        s_idx = torch.arange(S, device=x.device)[:, None]
        sel = h_edge[:, s_idx, self.link_index]          # [B, S, 2, d]
        emb_edge = torch.cat([sel.reshape(B, S, -1), graph_emb[:, N:]],
                             dim=-1)
        return emb_node, emb_edge

    # -- generation-time embeddings (unmasked canvas, running statistics) --
    def node_embs(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = self.rgcn(x, adj[:, :3])
        if self.bn is not None:
            h = self.bn(h, use_running_average=True)
        return h

    def embs_node(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return self.node_embs(x, adj).sum(dim=1)         # [B, d]

    def embs_edge(self, x: torch.Tensor, adj: torch.Tensor,
                  edge_index: torch.Tensor) -> torch.Tensor:
        """edge_index: [B, 2] (j_source, i_new)."""
        h = self.node_embs(x, adj)                       # [B, N, d]
        g = h.sum(dim=1)
        B = x.shape[0]
        sel = h[torch.arange(B, device=x.device)[:, None],
                edge_index.long()]                       # [B, 2, d]
        return torch.cat([sel.reshape(B, -1), g], dim=-1)


class DisGraphAF(FlowCore):
    """The flow core (reference disgraphaf.py:7-223)."""

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
            STDis(nout, num_node_type, nhid, generator=gen)
            for _ in range(num_flow_layer))
        self.edge_st = nn.ModuleList(
            STDis(3 * nout, num_edge_type, nhid, generator=gen)
            for _ in range(num_flow_layer))

    def forward(self, x, adj, x_deq, adj_deq):
        """Training forward: z for every node/edge step.

        x: [B, N, node_dim]; adj: [B, 4, N, N];
        x_deq: [B, N, node_dim]; adj_deq: [B, E_steps, bond_dim].
        """
        emb_node, emb_edge = self.all_embs(x, adj)
        for i in range(self.num_flow_layer):
            x_deq = one_hot_add(x_deq, self.node_st[i](emb_node))
            adj_deq = one_hot_add(adj_deq, self.edge_st[i](emb_edge))
        return x_deq, adj_deq

    def forward_rl_node(self, x, adj, action):
        """z for a recorded node action on the current canvas (running
        statistics, reference graphflow_rl.py forward_rl_node)."""
        emb = self.embs_node(x, adj)
        z = action
        for i in range(self.num_flow_layer):
            z = one_hot_add(z, self.node_st[i](emb))
        return z

    def forward_rl_edge(self, x, adj, action, edge_index):
        emb = self.embs_edge(x, adj, edge_index)
        z = action
        for i in range(self.num_flow_layer):
            z = one_hot_add(z, self.edge_st[i](emb))
        return z

    def reverse_node(self, x, adj, latent):
        emb = self.embs_node(x, adj)
        for i in reversed(range(self.num_flow_layer)):
            latent = one_hot_minus(latent, self.node_st[i](emb))
        return latent

    def reverse_edge(self, x, adj, latent, edge_index):
        emb = self.embs_edge(x, adj, edge_index)
        for i in reversed(range(self.num_flow_layer)):
            latent = one_hot_minus(latent, self.edge_st[i](emb))
        return latent


def link_entries(adj: torch.Tensor, link_index: torch.Tensor) -> torch.Tensor:
    """[B, 4, N, N] -> [B, S, 4]: the modelled adjacency entries in
    link_index order (row-major over (i, j < i))."""
    return adj[:, :, link_index[:, 1], link_index[:, 0]].transpose(1, 2)


class GraphFlowModelDF(nn.Module):
    """GraphDF top (reference graphflow.py:9-326): flow core + learnable
    categorical bases + discrete log-prob."""

    def __init__(self, max_size: int, edge_unroll: int, node_dim: int,
                 bond_dim: int, num_flow_layer: int = 12,
                 num_rgcn_layer: int = 3, nhid: int = 128, nout: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.max_size, self.edge_unroll = max_size, edge_unroll
        self.node_dim, self.bond_dim = node_dim, bond_dim
        self.masks = build_flow_masks(max_size, edge_unroll)
        self.flow_core = DisGraphAF(
            self.masks, num_flow_layer, max_size, node_dim, bond_dim, True,
            num_rgcn_layer, nhid, nout, generator=gen)
        self.node_base_log_probs = nn.Parameter(
            torch.randn((max_size, node_dim), generator=gen))
        self.edge_base_log_probs = nn.Parameter(
            torch.randn((self.masks.num_edge_steps, bond_dim), generator=gen))

    @property
    def total_len(self) -> int:
        return (self.max_size * self.node_dim
                + self.masks.num_edge_steps * self.bond_dim)

    def forward(self, x, adj):
        """Training: z = flow(x, adj); returns (z_node, z_edge)."""
        adj_deq = link_entries(adj, self.flow_core.link_index)
        return self.flow_core(x, adj, x, adj_deq)

    def _ll(self, z):
        x_deq, adj_deq = z
        node_lp = F.log_softmax(self.node_base_log_probs, dim=-1)
        edge_lp = F.log_softmax(self.edge_base_log_probs, dim=-1)
        return ((x_deq * node_lp).sum(dim=(-1, -2))
                + (adj_deq * edge_lp).sum(dim=(-1, -2)))

    def dis_log_prob(self, z):
        """Mean negative log-likelihood per dimension
        (graphflow.py:320-326)."""
        return -(self._ll(z).mean() / self.total_len)

    def loss(self, x, adj):
        return self.dis_log_prob(self(x, adj))

    def nll(self, x, adj):
        """Per-sample negative log-likelihood [B]."""
        return -self._ll(self(x, adj)) / self.total_len

    def reverse_node(self, x, adj, latent):
        return self.flow_core.reverse_node(x, adj, latent)

    def reverse_edge(self, x, adj, latent, edge_index):
        return self.flow_core.reverse_edge(x, adj, latent, edge_index)

    def rl_node_ll(self, x, adj, action, node_step):
        """Log-likelihood of recorded node actions [B] (PPO fine-tune,
        reference graphflow_rl.py:560-566)."""
        z = self.flow_core.forward_rl_node(x, adj, action)
        lp = F.log_softmax(self.node_base_log_probs, dim=-1)[node_step.long()]
        return (z * lp).sum(dim=-1)

    def rl_edge_ll(self, x, adj, action, edge_index, edge_cnt):
        z = self.flow_core.forward_rl_edge(x, adj, action, edge_index)
        lp = F.log_softmax(self.edge_base_log_probs, dim=-1)[edge_cnt.long()]
        return (z * lp).sum(dim=-1)


def base_logits(model) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """GraphDF's categorical base logits on the host, None for a model
    without them (GraphAF's Gaussian base)."""
    if not hasattr(model, "node_base_log_probs"):
        return None
    return (model.node_base_log_probs.detach().cpu().numpy(),
            model.edge_base_log_probs.detach().cpu().numpy())
