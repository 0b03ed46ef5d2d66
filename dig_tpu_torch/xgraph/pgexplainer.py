"""PGExplainer — parameterized edge-mask predictor. Port of
``dig_tpu/xgraph/pgexplainer.py``.

Parity with ``dig/xgraph/method/pgexplainer.py``: an MLP scores each edge
from concatenated endpoint embeddings (+ target-node embedding for node
tasks), trained over a dataset with the concrete-distribution
reparameterization and temperature annealing to match the model's own
predictions under masking (train phase :300-420, explain :548).

The JAX package's ``jax.random`` draws (the MLP's initial weights from
``PRNGKey(seed)``, each step's concrete uniforms) come from a
``torch.Generator`` seeded with ``seed``: :meth:`PGExplainer.init_mlp` and
:meth:`PGExplainer.draw`; :meth:`PGExplainer.step` takes the drawn noise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..graph import GraphBatch
from ..nn.init import xavier_uniform
from .base import ExplainerBase, to_numpy
from .models import apply


class _EdgeMLP(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 64):
        super().__init__()
        self.lin1 = nn.Linear(in_dim, hidden)
        self.lin2 = nn.Linear(hidden, 1)

    def forward(self, feats):
        return self.lin2(F.relu(self.lin1(feats)))[..., 0]


class PGExplainer(ExplainerBase):

    def __init__(self, model, params=None, epochs: int = 20,
                 lr: float = 3e-3, coff_size: float = 0.01,
                 coff_ent: float = 5e-4, t0: float = 5.0, t1: float = 1.0,
                 explain_graph: bool = True, hidden: int = 64):
        super().__init__(model, params, epochs, lr, explain_graph)
        self.coff_size = coff_size
        self.coff_ent = coff_ent
        self.t0, self.t1 = t0, t1
        self.hidden = hidden
        self.mlp: Optional[_EdgeMLP] = None

    def _edge_feats(self, g: GraphBatch, node_idx: Optional[int] = None):
        g = self.on_device(g)
        with torch.no_grad():
            _, acts = self.forward(g, None, return_activations=True)
        z = acts[-1]
        s, r = g.senders.long(), g.receivers.long()
        feats = torch.cat([z[s], z[r]], dim=-1)
        if node_idx is not None:
            t = z[node_idx][None, :].expand(g.num_edges, z.shape[-1])
            feats = torch.cat([feats, t], dim=-1)
        return feats

    def init_mlp(self, feat_dim: int, seed: int = 0) -> _EdgeMLP:
        """The edge scorer for ``feat_dim`` features, Glorot-uniform kernels
        and zero biases drawn from ``seed``, on the model's device."""
        mlp = _EdgeMLP(feat_dim, self.hidden)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in (mlp.lin1, mlp.lin2):
                xavier_uniform(lin.weight, gen)
                lin.bias.zero_()
        return mlp.to(self.device)

    @staticmethod
    def draw(gen: torch.Generator, num_edges: int) -> torch.Tensor:
        """A step's concrete-distribution uniforms ``[E]`` in (1e-6, 1 -
        1e-6), on the generator's device."""
        u = torch.rand(num_edges, generator=gen, device=gen.device)
        return 1e-6 + (1.0 - 2e-6) * u

    def step(self, opt, g: GraphBatch, feats, temp: float,
             u: torch.Tensor) -> torch.Tensor:
        """One Adam step of the edge scorer on ``g`` at temperature
        ``temp`` with the uniforms ``u``; the loss, detached."""
        g = self.on_device(g)
        plan = self.plan(g)
        with torch.no_grad():
            target = torch.argmax(self.forward(g, None), dim=-1)
        opt.zero_grad(set_to_none=True)
        logits = self.mlp(feats)
        u = u.to(logits)
        gumbel = torch.log(u) - torch.log(1 - u)
        ew = torch.sigmoid((logits + gumbel) / temp)
        ew = torch.where(g.edge_mask, ew, 0.0)
        out = apply(self.model, self.params, g, ew, plan=plan)
        logp = torch.log_softmax(out, dim=-1)
        ce = -torch.gather(logp, 1, target[:, None])[:, 0]
        ce = torch.sum(torch.where(g.graph_mask, ce, 0.0)) / torch.clamp(
            torch.sum(g.graph_mask), min=1)
        size = torch.sum(torch.where(g.edge_mask, ew, 0.0))
        m = torch.clamp(ew, 1e-6, 1 - 1e-6)
        ent = -m * torch.log(m) - (1 - m) * torch.log(1 - m)
        ent = torch.sum(torch.where(g.edge_mask, ent, 0.0))
        loss = ce + self.coff_size * size + self.coff_ent * ent
        loss.backward()
        opt.step()
        return loss.detach()

    def train_explanation_network(self, graphs: Sequence[GraphBatch],
                                  seed: int = 0, verbose: bool = False):
        """Train the edge scorer over a list of (single-graph) batches."""
        feats_all = [self._edge_feats(g) for g in graphs]
        self.mlp = self.init_mlp(feats_all[0].shape[-1], seed)
        opt = torch.optim.Adam(self.mlp.parameters(), lr=self.lr)
        gen = torch.Generator().manual_seed(seed)
        for epoch in range(self.epochs):
            temp = self.t0 * (self.t1 / self.t0) ** (epoch / self.epochs)
            losses = [self.step(opt, g, feats, temp,
                                self.draw(gen, g.num_edges))
                      for g, feats in zip(graphs, feats_all)]
            if verbose:
                print(f"PGExplainer epoch {epoch}: "
                      f"{float(torch.stack(losses).mean()):.4f}")

    def explain(self, g: GraphBatch, node_idx: Optional[int] = None
                ) -> np.ndarray:
        assert self.mlp is not None, "train_explanation_network first"
        feats = self._edge_feats(g, node_idx if not self.explain_graph
                                 else None)
        with torch.no_grad():
            logits = self.mlp(feats)
        return np.where(to_numpy(g.edge_mask), to_numpy(logits), -np.inf)

    def __call__(self, g: GraphBatch, num_classes: int = 2,
                 sparsity: float = 0.7, node_idx: Optional[int] = None):
        em = self.explain(g, node_idx)
        masks = [self.control_sparsity(em, sparsity)] * num_classes
        related = self.eval_related_pred(g, masks, node_idx=node_idx)
        return masks, related
