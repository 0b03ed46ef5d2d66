"""Contrastive objectives: InfoNCE / NT-Xent family and JSE family. Port of
``dig_tpu/ssl/objectives.py``.

Parity with ``dig/sslgraph/method/contrastive/objectives/infonce.py`` and
``jse.py``; masked variants so padded graphs/nodes contribute nothing. All
losses consume lists of representations exactly like the reference's
``NCE_loss(zs, zs_n, batch, sigma, tau)`` / ``JSE_loss(...)`` surface.
Plain PyTorch (dense products and reductions), as the JAX ones are plain
XLA.
"""
from __future__ import annotations

import itertools
from typing import List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_LOG2 = 0.6931471805599453


def _safe_norm(z, eps=1e-12):
    # sqrt(sum + eps): norm of an all-zero (padded) row has a well-defined
    # zero gradient; torch.linalg.norm at 0 back-propagates NaN even
    # through a clamp.
    return torch.sqrt(torch.sum(z * z, dim=-1) + eps)


def _normalize(z, eps=1e-12):
    return z / _safe_norm(z, eps)[..., None]


def _masked_mean(losses: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return torch.mean(losses)
    return torch.sum(torch.where(mask, losses, 0.0)) / torch.clamp(
        torch.sum(mask), min=1)


def nt_xent(z1: Tensor, z2: Tensor, tau: float = 0.5, norm: bool = True,
            mask: Optional[Tensor] = None) -> Tensor:
    """NT-Xent over graph embeddings (reference infonce.py:130-150):
    loss = -log(exp(s_ii/tau) / (sum_j exp(s_ij/tau) - exp(s_ii/tau)))."""
    sim = torch.einsum("ik,jk->ij", z1, z2)
    if norm:
        sim = sim / torch.einsum("i,j->ij", _safe_norm(z1), _safe_norm(z2))
    sim = torch.exp(sim / tau)
    if mask is not None:
        sim = torch.where(mask[None, :], sim, 0.0)
    pos = torch.diagonal(sim)
    denom = torch.clamp(torch.sum(sim, dim=1) - pos, min=1e-12)
    losses = -torch.log(torch.clamp(pos, min=1e-12) / denom)
    return _masked_mean(losses, mask)


def intra_node_nce(z1_n: Tensor, z2_n: Tensor, tau: float = 0.5,
                   norm: bool = True,
                   mask: Optional[Tensor] = None) -> Tensor:
    """GRACE's intra/inter node-level InfoNCE (reference
    infonce.py:72-113, unbatched branch): denominator = intra-view sims
    (minus self) + all inter-view sims."""
    if norm:
        z1, z2 = _normalize(z1_n), _normalize(z2_n)
    else:
        z1, z2 = z1_n, z2_n
    ex = lambda a, b: torch.exp(torch.einsum("ik,jk->ij", a, b) / tau)
    refl = ex(z1, z1)
    between = ex(z1, z2)
    if mask is not None:
        refl = torch.where(mask[None, :], refl, 0.0)
        between = torch.where(mask[None, :], between, 0.0)
    pos = torch.diagonal(between)
    denom = (torch.sum(refl, 1) - torch.diagonal(refl)
             + torch.sum(between, 1))
    losses = -torch.log(torch.clamp(pos, min=1e-12)
                        / torch.clamp(denom, min=1e-12))
    return _masked_mean(losses, mask)


def nce_loss(zs: Optional[List[Tensor]] = None,
             zs_n: Optional[List[Tensor]] = None,
             batch: Optional[Tensor] = None,
             sigma=None, tau: float = 0.5, norm: bool = True,
             graph_mask: Optional[Tensor] = None,
             node_mask: Optional[Tensor] = None) -> Tensor:
    """Dispatcher matching reference NCE_loss (infonce.py:6-68)."""
    if zs_n is not None and zs is None:
        if len(zs_n) != 2:
            raise ValueError(f"node-level NCE takes 2 views, got {len(zs_n)}")
        return 0.5 * (intra_node_nce(zs_n[0], zs_n[1], tau, norm, node_mask)
                      + intra_node_nce(zs_n[1], zs_n[0], tau, norm,
                                       node_mask))
    if zs is None:
        raise ValueError("nce_loss needs zs or zs_n")
    if len(zs) == 2:
        return nt_xent(zs[0], zs[1], tau, norm, graph_mask)
    loss = 0.0
    for (i, j) in itertools.combinations(range(len(zs)), 2):
        if sigma is None or sigma[i][j]:
            loss += nt_xent(zs[i], zs[j], tau, norm, graph_mask)
    return loss


def _jse_expectation(d: Tensor, positive: bool) -> Tensor:
    """f-divergence JSE scores with the -2log2 shift (jse.py:155-168)."""
    if positive:
        return _LOG2 - F.softplus(-d)
    return F.softplus(-d) + d - _LOG2


def _count(mask: Optional[Tensor], n: int, like: Tensor) -> Tensor:
    if mask is None:
        return torch.tensor(float(n), device=like.device)
    return torch.sum(mask)


def jse_local_global(z_g: Tensor, z_n: Tensor, node_graph: Tensor,
                     graph_mask: Optional[Tensor] = None,
                     node_mask: Optional[Tensor] = None) -> Tensor:
    """JSE between node and graph embeddings (jse.py:100-131): positive
    pairs (node, its graph), negatives (node, other graphs)."""
    G, N = z_g.shape[0], z_n.shape[0]
    d = z_n @ z_g.T                                   # [N, G]
    own = F.one_hot(node_graph.long(), G).bool()
    valid = torch.ones((N, G), dtype=torch.bool, device=d.device)
    if node_mask is not None:
        valid = valid & node_mask[:, None]
    if graph_mask is not None:
        valid = valid & graph_mask[None, :]
    pos_mask = own & valid
    neg_mask = (~own) & valid
    n_nodes = _count(node_mask, N, d)
    n_graphs = _count(graph_mask, G, d)
    e_pos = torch.sum(torch.where(
        pos_mask, _jse_expectation(d * pos_mask, True), 0.0))
    e_pos = e_pos / torch.clamp(n_nodes, min=1)
    e_neg = torch.sum(torch.where(
        neg_mask, _jse_expectation(d * neg_mask, False), 0.0))
    e_neg = e_neg / torch.clamp(n_nodes * (n_graphs - 1), min=1)
    return e_neg - e_pos


def jse_global_global(z1: Tensor, z2: Tensor,
                      graph_mask: Optional[Tensor] = None) -> Tensor:
    """JSE between two graph-level views (jse.py:134-152)."""
    G = z1.shape[0]
    d = z1 @ z2.T
    eye = torch.eye(G, dtype=torch.bool, device=d.device)
    valid = torch.ones((G, G), dtype=torch.bool, device=d.device)
    if graph_mask is not None:
        valid = valid & graph_mask[:, None] & graph_mask[None, :]
    pos_mask = eye & valid
    neg_mask = (~eye) & valid
    n = _count(graph_mask, G, d)
    e_pos = torch.sum(torch.where(
        pos_mask, _jse_expectation(d * pos_mask, True), 0.0))
    e_pos = e_pos / torch.clamp(n, min=1)
    e_neg = torch.sum(torch.where(
        neg_mask, _jse_expectation(d * neg_mask, False), 0.0))
    e_neg = e_neg / torch.clamp(n * (n - 1), min=1)
    return e_neg - e_pos


def jse_loss(zs: Optional[List[Tensor]] = None,
             zs_n: Optional[List[Tensor]] = None,
             batch: Optional[Tensor] = None, sigma=None,
             graph_mask: Optional[Tensor] = None,
             node_mask: Optional[Tensor] = None) -> Tensor:
    """Dispatcher matching reference JSE_loss (jse.py:8-63)."""
    if zs_n is not None:
        if zs is None or batch is None:
            raise ValueError("local-global JSE needs zs and batch")
        if len(zs) == 1:
            return jse_local_global(zs[0], zs_n[0], batch, graph_mask,
                                    node_mask)
        if len(zs) == 2:
            return (jse_local_global(zs[0], zs_n[1], batch, graph_mask,
                                     node_mask)
                    + jse_local_global(zs[1], zs_n[0], batch, graph_mask,
                                       node_mask))
        loss = 0.0
        for (i, j) in itertools.combinations(range(len(zs)), 2):
            if sigma is None or sigma[i][j]:
                loss += (jse_local_global(zs[i], zs_n[j], batch, graph_mask,
                                          node_mask)
                         + jse_local_global(zs[j], zs_n[i], batch,
                                            graph_mask, node_mask))
        return loss
    if zs is None:
        raise ValueError("jse_loss needs zs or zs_n")
    if len(zs) == 2:
        return jse_global_global(zs[0], zs[1], graph_mask)
    loss = 0.0
    for (i, j) in itertools.combinations(range(len(zs)), 2):
        if sigma is None or sigma[i][j]:
            loss += jse_global_global(zs[i], zs[j], graph_mask)
    return loss


def jse_local_global_neg_paired(z_g, z_n, node_graph,
                                graph_mask=None, node_mask=None):
    """JSE with corruption negatives (jse.py:67-97): the first halves of
    z_g / z_n are clean, the second halves corrupted; positives pair each
    graph with its own clean nodes, negatives with its corrupted nodes."""
    G, N = z_g.shape[0] // 2, z_n.shape[0] // 2
    zg = z_g[:G]
    zn, zn_c = z_n[:N], z_n[N:]
    own = F.one_hot(node_graph[:N].long(), G).bool()
    valid = torch.ones((N, G), dtype=torch.bool, device=zg.device)
    if node_mask is not None:
        valid = valid & node_mask[:N, None]
    if graph_mask is not None:
        valid = valid & graph_mask[None, :G]
    mask = own & valid
    d_pos = zn @ zg.T
    d_neg = zn_c @ zg.T
    n_pairs = torch.clamp(torch.sum(mask), min=1)
    # BCE with logits: pos label 1, neg label 0 (reference uses
    # BCEWithLogitsLoss over the concatenated scores)
    pos_ls = F.softplus(-d_pos)
    neg_ls = F.softplus(d_neg)
    loss = (torch.sum(torch.where(mask, pos_ls, 0.0))
            + torch.sum(torch.where(mask, neg_ls, 0.0))) / (2 * n_pairs)
    return 0.5 * loss
