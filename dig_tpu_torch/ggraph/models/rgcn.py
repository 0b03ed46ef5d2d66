"""Relational GCN on dense one-hot molecular tensors (port of
``dig_tpu.ggraph.models.rgcn``).

Parity with ``dig/ggraph/method/GraphDF/model/rgcn.py``: linear feature
embedding, then ``num_layers`` per-edge-type relational convolutions
(ReLU on all but the last), sum-aggregated over edge types, as batched
dense einsums (no sparse op: these stay ``torch.einsum``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import default_generator, glorot_uniform_, linear


class RelGraphConv(nn.Module):
    def __init__(self, in_features: int, out_features: int, edge_dim: int = 3,
                 use_relu: bool = True, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.use_relu = use_relu
        # flax layout [edge_dim, in, out]; glorot over (in * E, out * E)
        self.weight = nn.Parameter(glorot_uniform_(
            torch.empty(edge_dim, in_features, out_features),
            in_features * edge_dim, out_features * edge_dim, gen))
        self.bias = (nn.Parameter(torch.zeros(edge_dim, 1, out_features))
                     if bias else None)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: [B, N, d_in], adj: [B, E, N, N] -> [B, N, out]."""
        support = torch.einsum("bid,edh->beih", x, self.weight)
        out = torch.einsum("beij,bejh->beih", adj, support)
        if self.bias is not None:
            out = out + self.bias
        if self.use_relu:
            out = torch.relu(out)
        return out.sum(dim=1)  # sum over edge types


class RGCN(nn.Module):
    """emb -> gc1(relu) -> (num_layers-2) hidden(relu) -> gc_out(no relu)
    (reference rgcn.py:89-140). flax infers the input width; here it is
    ``in_features`` (the node one-hot width)."""

    def __init__(self, in_features: int, nhid: int = 128, nout: int = 128,
                 edge_dim: int = 3, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.emb = linear(in_features, in_features, gen, bias=False)
        widths = [in_features] + [nhid] * (num_layers - 1) + [nout]
        self.convs = nn.ModuleList(
            RelGraphConv(widths[k], widths[k + 1], edge_dim,
                         use_relu=k < num_layers - 1, generator=gen)
            for k in range(num_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: [B, N, node_dim] one-hot, adj: [B, edge_dim, N, N]. Returns
        node embeddings [B, N, nout]."""
        h = self.emb(x)
        for conv in self.convs:
            h = conv(h, adj)
        return h
