"""SchNet on the flat (compacted edge list) layout. Port of
``dig_tpu/models/schnet.py``.

The radius graph is built inside the model from ``GraphBatch`` positions
(:func:`~dig_tpu_torch.ops.radius.radius_graph_flat`, capped at
``max_edges``), so energy+force training differentiates through it. Each
interaction computes the continuous-filter message ``W(dist) *
lin_vj(v)[senders]`` per edge and sums it onto the receivers: with
``segment_eb > 0`` through the sorted-CSR segment sum (the kernel of
``csrc/segment_csr.cu`` on the card; ``segment_eb`` is its
``max_edges_per_block``), otherwise through ``index_add_``.

The modules and their parameter names are SchNetDense's (``embedding``,
``interactions[l].{lin_vj, mlp, lin1, lin2}``, ``out1``, ``out2``), so a
state dict moves between the two layouts unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..nn.blocks import shifted_softplus
from ..ops.basis import cosine_cutoff, gaussian_rbf
from ..ops.radius import radius_graph_flat
from ..ops.segment import flat_edges_to_nodes, gather_rows, readout_sum
from ..ops.triplets import edge_distances
from .schnet_dense import Interaction, _linear


class SchNet(nn.Module):
    """Per-graph predictions ``[G, out_channels]`` of a flat ``GraphBatch``
    with node fields ``z`` and ``pos``.

    ``max_edges``: the radius graph's static cap (``Run3D`` warns when a
    batch has more in-cutoff pairs). ``segment_eb > 0``: edge->node sums
    through the sorted-CSR kernel with that many edges per block of 32
    receiver rows (the JAX package's cap: the densest 32 rows plus 127 of
    alignment slack must fit). Float32 throughout, as the JAX model.
    """

    def __init__(self, cutoff: float = 10.0, num_layers: int = 6,
                 hidden_channels: int = 128, out_channels: int = 1,
                 num_filters: int = 128, num_gaussians: int = 50,
                 max_edges: int = 4096, segment_eb: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.cutoff = cutoff
        self.num_gaussians = num_gaussians
        self.max_edges = max_edges
        self.segment_eb = segment_eb
        self.embedding = nn.Embedding(100, hidden_channels)
        with torch.no_grad():   # flax Embed init: U[0, sqrt(3))
            self.embedding.weight.uniform_(0.0, math.sqrt(3.0),
                                           generator=gen)
        self.interactions = nn.ModuleList(
            Interaction(hidden_channels, num_filters, num_gaussians, None,
                        gen) for _ in range(num_layers))
        self.out1 = _linear(hidden_channels, hidden_channels // 2, True, gen)
        self.out2 = _linear(hidden_channels // 2, out_channels, True, gen)
        self.to(device)

    def forward(self, g: GraphBatch) -> torch.Tensor:
        pos = g.nodes["pos"]
        N, mask = g.num_nodes, g.node_mask[:, None]
        senders, receivers, edge_mask = radius_graph_flat(
            pos, g.node_graph, g.node_mask, self.cutoff, self.max_edges)
        dist = edge_distances(pos, senders, receivers, edge_mask)
        dist_emb = gaussian_rbf(dist, 0.0, self.cutoff, self.num_gaussians)
        gate = cosine_cutoff(dist, self.cutoff)[:, None]

        v = torch.where(mask, self.embedding(g.nodes["z"].long()), 0.0)
        for layer in self.interactions:
            e = (gather_rows(layer.lin_vj(v), senders)
                 * (layer.mlp(dist_emb) * gate))
            agg = flat_edges_to_nodes(e, receivers, N, edge_mask,
                                      self.segment_eb)
            out = layer.lin2(shifted_softplus(layer.lin1(agg)))
            v = torch.where(mask, v + out, 0.0)

        h = self.out2(shifted_softplus(self.out1(v)))
        return readout_sum(h, g.node_graph, g.num_graphs, g.node_mask)
