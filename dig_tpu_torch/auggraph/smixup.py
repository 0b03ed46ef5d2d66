"""SMixup: structure-aware graph mixup via soft matching. Port of
``dig_tpu/auggraph/smixup.py``.

Parity with ``dig/auggraph/method/SMixup/{smixup.py:25-303,GMNET.py,
utils/sinkhorn.py}``: a graph-matching network produces node-alignment
scores between pairs of graphs, Sinkhorn normalization turns them into a
soft transport plan, and mixed graphs interpolate aligned node features
(and adjacency) with a Beta-distributed lambda; a GIN classifier trains on
mixed labels. The alignment and the plan are dense products.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.graphs import GraphClsLoader
from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from .graphaug import _GIN, _accuracy, _Cls, _made


def sinkhorn(scores, n_iters: int = 10, mask=None):
    """Sinkhorn normalization to a doubly-stochastic plan
    (reference utils/sinkhorn.py:1-212, log-domain)."""
    log_p = scores
    if mask is not None:
        log_p = torch.where(mask, log_p, -1e30)
    for _ in range(n_iters):
        log_p = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
        if mask is not None:
            log_p = torch.where(mask, log_p, -1e30)
        log_p = log_p - torch.logsumexp(log_p, dim=0, keepdim=True)
        if mask is not None:
            log_p = torch.where(mask, log_p, -1e30)
    p = torch.exp(log_p)
    return torch.where(mask, p, 0.0) if mask is not None else p


class MatchNet(nn.Module):
    """GMNET (reference GMNET.py): produces node-pair alignment scores.
    ``feat_dim`` is the node feature width (flax infers it)."""

    def __init__(self, feat_dim: int, hidden: int = 64):
        super().__init__()
        self.enc = _GIN(feat_dim, hidden)

    def forward(self, g1: GraphBatch, g2: GraphBatch):
        _, zn1 = self.enc(g1)
        _, zn2 = self.enc(g2)
        return zn1 @ zn2.T  # [N1, N2]


class SMixup:
    """The method (smixup.py:25-303). The matcher and the classifier
    are made in :meth:`train` (their input width is the data's), weights
    from a generator seeded with ``seed``, matcher first."""

    def __init__(self, num_classes: int, hidden: int = 64,
                 alpha: float = 1.0, sinkhorn_iters: int = 8):
        self.num_classes = num_classes
        self.hidden = hidden
        self.alpha = alpha
        self.sinkhorn_iters = sinkhorn_iters
        self.matcher = None
        self.cls = None
        self.params = None
        self.device = None

    def build(self, feat_dim: int, generator: torch.Generator,
              device: DeviceLike = None) -> None:
        """Make the matcher and the classifier, weights from
        ``generator``."""
        self.device = resolve_device(device)
        self.matcher = _made(MatchNet(feat_dim, self.hidden), generator,
                             self.device)
        self.cls = _made(_Cls(feat_dim, self.hidden, self.num_classes),
                         generator, self.device)

    def loss(self, g1: GraphBatch, g2: GraphBatch, lam: float):
        """Cross-entropy of the classifier on g1's nodes with g2's features
        aligned onto them by the Sinkhorn plan and mixed at ``lam``,
        against the labels mixed at ``lam``, over g1's real graphs."""
        scores = self.matcher(g1, g2)
        pair = g1.node_graph[:, None] == g2.node_graph[None, :]
        pair = pair & g1.node_mask[:, None] & g2.node_mask[None, :]
        plan = sinkhorn(scores, self.sinkhorn_iters, pair)
        # align g2's features onto g1's node set
        x2_aligned = plan @ g2.nodes["x"]
        x_mix = lam * g1.nodes["x"] + (1 - lam) * x2_aligned
        logits = self.cls(g1, x_mix)
        y1 = F.one_hot(g1.globals["y"].reshape(-1).long(), self.num_classes)
        y2 = F.one_hot(g2.globals["y"].reshape(-1).long(), self.num_classes)
        y_mix = lam * y1 + (1 - lam) * y2
        ls = -torch.sum(y_mix * torch.log_softmax(logits, -1), -1)
        m = g1.graph_mask
        return torch.sum(torch.where(m, ls, 0.0)) / torch.clamp(
            torch.sum(m), min=1)

    def train(self, dataset: Sequence[Dict], batch_size: int = 16,
              epochs: int = 10, lr: float = 1e-3, seed: int = 0,
              verbose: bool = False, device: DeviceLike = None):
        """Returns the trained weights ``{"match": ..., "cls": ...}``
        (state dicts). lambda ~ Beta(alpha, alpha) from
        ``np.random.default_rng(seed)`` a step, on the host; an epoch reads
        its mean loss once, at its end."""
        loader = GraphClsLoader(dataset, batch_size, shuffle=True, seed=seed)
        loader2 = GraphClsLoader(dataset, batch_size, shuffle=True,
                                 seed=seed + 99)
        self.build(dataset[0]["x"].shape[1],
                   torch.Generator().manual_seed(seed), device)
        dev = self.device
        opt = torch.optim.Adam(list(self.matcher.parameters())
                               + list(self.cls.parameters()), lr=lr)
        rng = np.random.default_rng(seed)
        for ep in range(epochs):
            pairs = [(a.to(dev), b.to(dev)) for a, b in zip(loader, loader2)]
            losses = []
            for g1, g2 in pairs:
                lam = float(rng.beta(self.alpha, self.alpha))
                opt.zero_grad(set_to_none=True)
                loss = self.loss(g1, g2, lam)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            epoch_loss = float(torch.stack(losses).mean())
            if verbose:
                print(f"smixup epoch {ep}: {epoch_loss:.4f}")
        self.params = {
            "match": {k: v.detach().clone()
                      for k, v in self.matcher.state_dict().items()},
            "cls": {k: v.detach().clone()
                    for k, v in self.cls.state_dict().items()}}
        return self.params

    def evaluate(self, dataset: Sequence[Dict],
                 batch_size: int = 16) -> float:
        if self.params is None:
            raise RuntimeError("SMixup.evaluate before train")
        return _accuracy(self.cls, dataset, batch_size, self.device)
