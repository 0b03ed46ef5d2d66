"""Gradient / decomposition explainers: GradCAM, GNN-GI, DeepLIFT, FlowX,
GNN-LRP. Port of ``dig_tpu/xgraph/gradient.py``.

Parity with ``dig/xgraph/method/{gradcam.py,gnn_gi.py,deeplift.py,flowx.py,
gnn_lrp.py}``. Each is a few ``torch.autograd.grad`` calls against the
forward:

* GradCAM  — class-gradient-weighted last-conv activations -> node scores,
  edge score = mean of endpoints.
* GNN_GI   — gradient x input on per-edge weights (walk-free GI).
* DeepLIFT — rescale-rule approximation: (x - baseline) * grad at the
  input, against a zero baseline.
* FlowX    — marginal-contribution flow attribution: Monte-Carlo edge
  Shapley over edge subsets (the toggled weightings of a sample run as one
  union of copies).
* GNN_LRP  — walk-level decomposition: with per-layer edge-weight
  variables, the relevance of walk (e_1 .. e_L) is the mixed partial
  derivative of the target logit. The JAX package nests ``jacfwd`` over
  ``grad``; the port takes repeated reverse-mode derivatives
  (``create_graph``), one row of the walk tensor per real edge of the
  outer levels, through the neighbour sums' closed pair of gathers and
  sorted-CSR sums. Rows of padding edges are zero in both.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import GraphBatch
from .base import ExplainerBase, to_numpy
from .models import apply_head


def _edge_scores(g: GraphBatch, node_scores: np.ndarray) -> np.ndarray:
    s, r = to_numpy(g.senders), to_numpy(g.receivers)
    edge_scores = 0.5 * (node_scores[s] + node_scores[r])
    return np.where(to_numpy(g.edge_mask), edge_scores, -np.inf)


class GradCAM(ExplainerBase):
    """reference gradcam.py (Grad-CAM on the last conv layer)."""

    def explain(self, g: GraphBatch, target_label: int,
                node_idx: Optional[int] = None) -> np.ndarray:
        row = 0 if node_idx is None else node_idx
        g = self.on_device(g)
        with torch.no_grad():
            _, acts = self.forward(g, None, return_activations=True)
        last = acts[-1].detach().requires_grad_()
        logit = apply_head(self.model, self.params, last, g)[
            row, target_label]
        (grads,) = torch.autograd.grad(logit, last)
        alpha = torch.mean(grads, dim=0)                 # [C] channel wts
        node_scores = torch.relu(torch.sum(last * alpha[None, :], dim=-1))
        return _edge_scores(g, to_numpy(node_scores))


class GNN_GI(ExplainerBase):
    """Gradient x input on edge weights (reference gnn_gi.py: walk GI
    collapsed to edges)."""

    def explain(self, g: GraphBatch, target_label: int,
                node_idx: Optional[int] = None) -> np.ndarray:
        row = 0 if node_idx is None else node_idx
        g = self.on_device(g)
        ew = torch.ones(g.num_edges, device=self.device, requires_grad=True)
        (grads,) = torch.autograd.grad(
            self.forward(g, ew)[row, target_label], ew)
        return np.where(to_numpy(g.edge_mask), to_numpy(grads), -np.inf)


class DeepLIFT(ExplainerBase):
    """Rescale-rule DeepLIFT approximation against a zero-feature baseline
    (reference deeplift.py wraps the captum fork; for ReLU networks the
    rescale rule equals (x - x0) * avg-grad along the straight path —
    approximated at the input point)."""

    def explain(self, g: GraphBatch, target_label: int,
                node_idx: Optional[int] = None,
                steps: int = 8) -> np.ndarray:
        row = 0 if node_idx is None else node_idx
        g = self.on_device(g)
        x1 = g.nodes["x"]
        x0 = torch.zeros_like(x1)
        # integrated-gradients-style average along the path (equals
        # DeepLIFT-Rescale in piecewise-linear nets), the points of the
        # path as one union of copies, summed in the JAX package's order
        alphas = np.linspace(1.0 / steps, 1.0, steps)
        xs = torch.stack([x0 + float(a) * (x1 - x0)
                          for a in alphas]).requires_grad_()
        ones = torch.ones((steps, g.num_edges), device=self.device)
        logits = self.forward_many(g, ones, x=xs)
        (grads,) = torch.autograd.grad(
            torch.sum(logits[:, row, target_label]), xs)
        total = torch.zeros_like(x1)
        for k in range(steps):
            total = total + grads[k]
        node_attr = torch.sum((x1 - x0) * total / steps, dim=-1)
        return _edge_scores(g, to_numpy(node_attr))


class FlowX(ExplainerBase):
    """Flow-based attribution via Monte-Carlo edge Shapley (reference
    flowx.py trains flow scores from marginal message-flow contributions;
    this implementation scores each edge by its expected marginal effect on
    the target prob over random edge subsets). The numpy stream is the JAX
    package's, draw for draw."""

    def explain(self, g: GraphBatch, target_label: int,
                node_idx: Optional[int] = None, sample_num: int = 32,
                seed: int = 0) -> np.ndarray:
        row = 0 if node_idx is None else node_idx
        g = self.on_device(g)
        E = g.num_edges
        em = to_numpy(g.edge_mask)
        rng = np.random.default_rng(seed)
        dev = self.device
        idxs = np.flatnonzero(em)

        scores = np.zeros(E)
        counts = np.zeros(E) + 1e-9
        for _ in range(sample_num):
            keep = (rng.random(E) < 0.5) & em
            # the sample's base weighting first, then each real edge
            # toggled, in one run over len(idxs) + 1 copies
            toggled = np.repeat(keep[None, :], len(idxs) + 1, axis=0)
            for k, e in enumerate(idxs):
                toggled[k + 1, e] = ~toggled[k + 1, e]
            with torch.no_grad():
                probs = torch.softmax(self.forward_many(
                    g, torch.as_tensor(toggled, dtype=torch.float32,
                                       device=dev)), dim=-1)
            probs = to_numpy(probs[:, row, target_label])
            base = float(probs[0])
            for k, e in enumerate(idxs):
                sign = 1.0 if not keep[e] else -1.0
                scores[e] += sign * (float(probs[k + 1]) - base)
                counts[e] += 1
        out = scores / counts
        return np.where(em, out, -np.inf)


class GNN_LRP(ExplainerBase):
    """Walk-level LRP-style decomposition (reference gnn_lrp.py): with
    per-layer edge weights w^(l), relevance of walk (e_1..e_L) is the mixed
    partial d^L f / dw^(1)_{e_1} ... dw^(L)_{e_L} evaluated at w == 1
    (exact for the 2/3-layer zoo); edge score = sum of relevances of walks
    through the edge."""

    def explain(self, g: GraphBatch, target_label: int,
                node_idx: Optional[int] = None) -> np.ndarray:
        L = self.model.num_layers
        assert L in (2, 3), "walk enumeration supported for 2/3 layers"
        row = 0 if node_idx is None else node_idx
        g = self.on_device(g)
        E = g.num_edges
        em = to_numpy(g.edge_mask)
        real = np.flatnonzero(em).tolist()
        ws = [torch.ones(E, device=self.device, requires_grad=True)
              for _ in range(L)]
        f = self.forward(g, list(ws))[row, target_label]
        (g1,) = torch.autograd.grad(f, ws[0], create_graph=True)

        def grad_row(y, w, create_graph):
            if not y.requires_grad:
                return torch.zeros(E, device=w.device)
            (d,) = torch.autograd.grad(y, w, retain_graph=True,
                                       create_graph=create_graph,
                                       allow_unused=True)
            return torch.zeros(E, device=w.device) if d is None else d

        if L == 2:
            # walk relevance matrix [E, E]
            W = torch.zeros((E, E), device=self.device)
            for i in real:
                W[i] = grad_row(g1[i], ws[1], False)
            W = np.abs(to_numpy(W))
            edge_scores = W.sum(axis=1) + W.sum(axis=0)
        else:
            H = torch.zeros((E, E, E), device=self.device)
            for i in real:
                g2 = grad_row(g1[i], ws[1], True)
                if not g2.requires_grad:
                    continue
                for j in real:
                    H[i, j] = grad_row(g2[j], ws[2], False)
            H = np.abs(to_numpy(H))
            edge_scores = (H.sum(axis=(1, 2)) + H.sum(axis=(0, 2))
                           + H.sum(axis=(0, 1)))
        return np.where(em, edge_scores, -np.inf)
