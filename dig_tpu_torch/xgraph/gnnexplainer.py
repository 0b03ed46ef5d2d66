"""GNNExplainer — learned soft edge + feature mask maximizing mutual
information with the prediction. Port of ``dig_tpu/xgraph/gnnexplainer.py``.

Parity with ``dig/xgraph/method/gnnexplainer.py`` (PyG-derived): optimize
sigmoid edge mask and feature mask against cross-entropy to the target
class plus size/entropy regularizers, with Adam. The JAX package runs the
loop as one ``lax.scan`` (and ``vmap``s it over graphs in
``explain_batch``); the port runs it as a host loop of device steps that
reads nothing until the end, over the disjoint union of the graphs
(``explain`` is a union of one). Each graph keeps its own loss terms (the
size and entropy terms over its own padded edges, padding included, as
``jnp.sum(em)`` / ``jnp.mean(ent)``; its feature mask gathered to its own
rows), and Adam is elementwise, so every graph follows the sequence it
would follow alone.

The initial masks (JAX: ``jax.random.normal`` from ``PRNGKey(seed)``;
``seed + b`` for graph ``b`` of a batch) are drawn by :meth:`GNNExplainer.draw`
from a ``torch.Generator`` seeded the same way.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph import GraphBatch
from ..ops.segment import gather_plan, gather_rows
from .base import ExplainerBase, disjoint_union, to_numpy
from .models import apply, xplan

# Deviation from the reference coefficients (edge_size 0.005 / edge_ent 1.0
# / node_feat_size 1.0, dig/xgraph/method/gnnexplainer.py): with the
# keep-init below, an entropy coefficient of 1.0 dominates the per-edge
# gradient (|d ent/d logit| ~1e-3 vs size ~2e-4 at mask 0.95) and drives
# EVERY mask to 1 before the CE term can differentiate edges — measured
# motif recall 0.0 on ba_2motifs at train acc 1.0. At edge_ent 0.1 the size
# penalty carves and CE protects important edges: recall 0.54 vs 0.09
# random (the JAX package's grid search).
_COEFFS = {
    "edge_size": 0.01,
    "node_feat_size": 0.1,
    "edge_ent": 0.1,
    "node_feat_ent": 0.1,
}


def _entropy(m: torch.Tensor) -> torch.Tensor:
    return -m * torch.log(m + 1e-12) - (1 - m) * torch.log(1 - m + 1e-12)


class GNNExplainer(ExplainerBase):

    def __init__(self, model, params=None, epochs: int = 100,
                 lr: float = 0.01, explain_graph: bool = True,
                 coffs: Optional[dict] = None):
        super().__init__(model, params, epochs, lr, explain_graph)
        self.coeffs = dict(_COEFFS)
        if coffs:
            self.coeffs.update(coffs)

    @staticmethod
    def draw(gen: torch.Generator, num_edges: int, feat_dim: int):
        """Initial mask logits ``(edge [E], feat [F])``: keep-init at 3 plus
        N(0, 0.1) noise, on the generator's device.

        Keep-init: start both masks near 1 (logit +3 => sigmoid ~0.95) and
        carve edges away from the FULL graph. PyG's N(0, 0.1) init (mask
        ~0.5) halves every message at step 0, which puts the trained model
        far off-manifold: measured on ba_2motifs, the model then predicts
        one class with p~1.0 for everything and the CE gradient wrt edge
        masks is zero/pathological, so motif edges rank dead last.
        Starting from the intact graph keeps the model on-distribution and
        the size/entropy penalties do the carving."""
        d = gen.device
        return (3.0 + 0.1 * torch.randn(num_edges, generator=gen, device=d),
                3.0 + 0.1 * torch.randn(feat_dim, generator=gen, device=d))

    def optimize(self, graphs: Sequence[GraphBatch], rows, labels,
                 edge0: torch.Tensor, feat0: torch.Tensor,
                 mask_features: bool = True):
        """Adam over the masks of ``graphs`` (the same pads) for
        ``self.epochs`` steps from the logits ``edge0 [B, E]`` and ``feat0
        [B, F]``, graph ``b`` explaining row ``rows[b]``'s class
        ``labels[b]``; returns the final logits ``(edge [B, E], feat [B,
        F])`` on the device."""
        dev = self.device
        graphs = [self.on_device(g) for g in graphs]
        B, E = len(graphs), graphs[0].num_edges
        u = graphs[0] if B == 1 else disjoint_union(graphs)
        plan = self.plan(u) if B == 1 else xplan(u)
        N = graphs[0].num_nodes
        node_b = torch.repeat_interleave(torch.arange(B, device=dev), N)
        nplan = gather_plan(node_b, B)
        R = N if self.model.model_level == "node" else graphs[0].num_graphs
        rows_u = (torch.as_tensor(np.asarray(rows), device=dev).long()
                  + torch.arange(B, device=dev) * R)
        labels = torch.as_tensor(np.asarray(labels), device=dev).long()
        e = edge0.detach().to(dev).reshape(B * E).clone().requires_grad_()
        f = feat0.detach().to(dev).reshape(B, -1).clone().requires_grad_()
        opt = torch.optim.Adam([e, f], lr=self.lr)
        c = self.coeffs
        x = u.nodes["x"]
        for _ in range(self.epochs):
            opt.zero_grad(set_to_none=True)
            em = torch.sigmoid(e)
            fm = torch.sigmoid(f)
            gx = (u.replace_nodes(x=x * gather_rows(fm, node_b, nplan))
                  if mask_features else u)
            logits = apply(self.model, self.params, gx, em, plan=plan)
            logp = torch.log_softmax(logits, dim=-1)
            per = -logp[rows_u, labels]
            em_b = em.reshape(B, E)
            per = per + c["edge_size"] * torch.sum(em_b, dim=1)
            per = per + c["edge_ent"] * torch.mean(_entropy(em_b), dim=1)
            if mask_features:
                per = per + c["node_feat_size"] * torch.mean(fm, dim=1)
                per = per + c["node_feat_ent"] * torch.mean(_entropy(fm),
                                                            dim=1)
            torch.sum(per).backward()
            opt.step()
        return e.detach().reshape(B, E), f.detach()

    def explain(self, g: GraphBatch, target_label: Optional[int] = None,
                node_idx: Optional[int] = None, seed: int = 0,
                mask_features: bool = True):
        """Returns (edge_mask_logits [E], feat_mask_logits [F])."""
        E = g.num_edges
        F = g.nodes["x"].shape[-1]
        row = 0 if node_idx is None else node_idx
        if target_label is None:
            probs = to_numpy(self.predict_proba(g))
            target_label = int(np.argmax(probs[row]))
        e0, f0 = self.draw(torch.Generator().manual_seed(seed), E, F)
        em, fm = self.optimize([g], [row], [target_label], e0[None],
                               f0[None], mask_features)
        edge_mask = np.where(to_numpy(g.edge_mask), to_numpy(em[0]),
                             -np.inf)
        return edge_mask, to_numpy(fm[0])

    def explain_batch(self, graphs: List[GraphBatch], target_labels,
                      node_idxs=None, seed: int = 0,
                      mask_features: bool = True):
        """Optimize EVERY graph's masks in one run over their disjoint
        union (graphs of the same pads: one loader). Returns a list of
        (edge_mask_logits [E], feat_mask_logits [F]) like :meth:`explain`
        and matches it sample-for-sample (graph ``b`` draws from
        ``seed + b``)."""
        B = len(graphs)
        E = graphs[0].num_edges
        F = graphs[0].nodes["x"].shape[-1]
        rows = (np.zeros(B, np.int64) if node_idxs is None
                else np.asarray(node_idxs, np.int64))
        draws = [self.draw(torch.Generator().manual_seed(seed + b), E, F)
                 for b in range(B)]
        em, fm = self.optimize(graphs, rows, np.asarray(target_labels),
                               torch.stack([d[0] for d in draws]),
                               torch.stack([d[1] for d in draws]),
                               mask_features)
        em, fm = to_numpy(em), to_numpy(fm)
        return [(np.where(to_numpy(g.edge_mask), em[b], -np.inf), fm[b])
                for b, g in enumerate(graphs)]

    def __call__(self, g: GraphBatch, num_classes: int = 2,
                 sparsity: float = 0.7, node_idx: Optional[int] = None,
                 **kwargs):
        """Reference-call surface: per-class hard masks + related preds."""
        edge_masks = []
        for label in range(num_classes):
            em, _ = self.explain(g, target_label=label, node_idx=node_idx)
            edge_masks.append(self.control_sparsity(em, sparsity))
        related = self.eval_related_pred(g, edge_masks, node_idx=node_idx)
        return edge_masks, related
