"""Pre-configured contrastive methods: GraphCL, InfoGraph, MVGRL, GRACE,
pGRACE. Port of ``dig_tpu/ssl/methods.py``; parity with
``dig/sslgraph/method/contrastive/model/*.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from .adaptive import AdaEdgePerturbation, AdaNodeAttrMask
from .contrastive import Contrastive
from .encoders import init_weights, pool_graphs
from .views import (Diffusion, EdgePerturbation, NodeAttrMask, RandomView,
                    RWSample, SequentialView, UniformSample, identity_view)


class GraphCL(Contrastive):
    """Graph Contrastive Learning with Augmentations
    (reference graphcl.py:6-72): NT-Xent over two augmented views with an
    MLP projection head (discarded after pretraining)."""

    def __init__(self, dim: int, aug_1: Optional[str] = None,
                 aug_2: Optional[str] = None, aug_ratio: float = 0.2,
                 **kwargs):
        views_fn = []
        for aug in (aug_1, aug_2):
            if aug is None:
                views_fn.append(identity_view)
            elif aug == "dropN":
                views_fn.append(UniformSample(ratio=aug_ratio))
            elif aug == "permE":
                views_fn.append(EdgePerturbation(ratio=aug_ratio))
            elif aug == "subgraph":
                views_fn.append(RWSample(ratio=aug_ratio))
            elif aug == "maskN":
                views_fn.append(NodeAttrMask(mask_ratio=aug_ratio))
            elif aug == "random2":
                views_fn.append(RandomView([UniformSample(aug_ratio),
                                            RWSample(aug_ratio)]))
            elif aug == "random4":
                views_fn.append(RandomView([UniformSample(aug_ratio),
                                            RWSample(aug_ratio),
                                            EdgePerturbation(ratio=aug_ratio)]))
            elif aug == "random3":
                views_fn.append(RandomView([
                    UniformSample(aug_ratio), RWSample(aug_ratio),
                    EdgePerturbation(ratio=aug_ratio),
                    NodeAttrMask(mask_ratio=aug_ratio)]))
            else:
                raise ValueError(
                    "aug must be from ['dropN','permE','subgraph','maskN',"
                    "'random2','random3','random4'] or None")
        super().__init__(objective="NCE", views_fn=views_fn, z_dim=dim,
                         proj="MLP", node_level=False, **kwargs)


class InfoGraph(Contrastive):
    """InfoGraph (reference infograph.py): local-global JSE between node
    and graph embeddings of a single (identity) view, with projection
    heads on both levels."""

    def __init__(self, g_dim: int, n_dim: int, **kwargs):
        super().__init__(objective="JSE", views_fn=[identity_view],
                         graph_level=True, node_level=True,
                         z_dim=g_dim, z_n_dim=n_dim,
                         proj="MLP", proj_n="MLP", **kwargs)


class DenseDiffusionEncoder(nn.Module):
    """GCN over the dense diffusion matrix (MVGRL's second view). The
    aggregation S @ (X W) is one dense product per layer, the form of the
    reference's weighted sparse conv over the diffusion edge list
    (mvgrl.py:26-35 + structure.py:110-160). ``feat_dim`` is the input
    width (flax infers it); weights from ``generator`` (None: seed 0), on
    ``device`` (None: the card)."""

    def __init__(self, feat_dim: int, hidden_dim: int, n_layers: int = 2,
                 mode: str = "ppr", alpha: float = 0.2, t: float = 5.0,
                 pool: str = "sum",
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.lins = nn.ModuleList(
            nn.Linear(feat_dim if i == 0 else hidden_dim, hidden_dim)
            for i in range(n_layers))
        self.diffusion = Diffusion(mode, alpha, t)
        self.pool = pool
        init_weights(self, generator or torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def forward(self, g: GraphBatch):
        _, S = self.diffusion.apply(g)
        x = g.nodes["x"]
        xs = []
        for lin in self.lins:
            x = torch.relu(S @ lin(x))
            x = torch.where(g.node_mask[:, None], x, 0.0)
            xs.append(x)
        return torch.cat([pool_graphs(h, g, self.pool) for h in xs], 1), x


class MVGRL(Contrastive):
    """Multi-View Graph Representation Learning (reference mvgrl.py:63-):
    contrasts an adjacency view vs a diffusion view with local-global JSE.
    Pass a *list* of two encoders to ``train`` — typically a GCN for the
    adjacency view and :class:`DenseDiffusionEncoder` for the diffusion
    view."""

    def __init__(self, g_dim: int, n_dim: int, diffusion_type: str = "ppr",
                 alpha: float = 0.2, t: float = 5.0, **kwargs):
        self.diffusion_type = diffusion_type
        self.alpha = alpha
        self.t = t
        super().__init__(objective="JSE",
                         views_fn=[identity_view, identity_view],
                         graph_level=True, node_level=True,
                         z_dim=g_dim, z_n_dim=n_dim,
                         proj="linear", proj_n="linear", **kwargs)

    def make_diffusion_encoder(self, feat_dim: int, hidden_dim: int,
                               n_layers: int = 2,
                               generator: Optional[torch.Generator] = None,
                               device: DeviceLike = None):
        return DenseDiffusionEncoder(feat_dim, hidden_dim, n_layers,
                                     self.diffusion_type, self.alpha, self.t,
                                     generator=generator, device=device)


class GRACE(Contrastive):
    """GRACE (reference grace.py:5-44): node-level NT-Xent over two
    (edge-drop + feature-mask) views."""

    def __init__(self, dim: int, dropE_rate_1: float, dropE_rate_2: float,
                 maskN_rate_1: float, maskN_rate_2: float, **kwargs):
        v1 = SequentialView([
            EdgePerturbation(add=False, drop=True, ratio=dropE_rate_1),
            NodeAttrMask(mask_ratio=maskN_rate_1)])
        v2 = SequentialView([
            EdgePerturbation(add=False, drop=True, ratio=dropE_rate_2),
            NodeAttrMask(mask_ratio=maskN_rate_2)])
        super().__init__(objective="NCE", views_fn=[v1, v2],
                         graph_level=False, node_level=True,
                         z_n_dim=dim, proj_n="MLP", **kwargs)


class pGRACE(Contrastive):
    """GCA / probabilistic GRACE (reference pgrace.py): adaptive
    centrality-weighted edge dropping + feature masking."""

    def __init__(self, dim: int, centrality_measure: str = "degree",
                 prob_1: float = 0.3, prob_2: float = 0.4,
                 threshold: float = 0.7, dense: bool = False, **kwargs):
        v1 = SequentialView([
            AdaEdgePerturbation(centrality_measure, prob_1, threshold),
            AdaNodeAttrMask(centrality_measure, prob_1, threshold, dense)])
        v2 = SequentialView([
            AdaEdgePerturbation(centrality_measure, prob_2, threshold),
            AdaNodeAttrMask(centrality_measure, prob_2, threshold, dense)])
        super().__init__(objective="NCE", views_fn=[v1, v2],
                         graph_level=False, node_level=True,
                         z_n_dim=dim, proj_n="MLP", **kwargs)


class NodeMVGRL(MVGRL):
    """Node-level MVGRL (reference node_mvgrl.py): same two-view JSE
    contrast but with corruption negatives and subgraph-sampled diffusion
    views for large graphs."""

    def __init__(self, g_dim: int, n_dim: int, sample_size: int = 2000,
                 diffusion_type: str = "ppr", alpha: float = 0.2,
                 t: float = 5.0, **kwargs):
        super().__init__(g_dim, n_dim, diffusion_type, alpha, t,
                         neg_by_crpt=True, **kwargs)
        self.sample_size = sample_size
