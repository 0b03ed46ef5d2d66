"""Discrete-flow utilities + autoregressive mask schedule (port of
``dig_tpu.ggraph.models.flow_utils``).

* ``one_hot_add`` / ``one_hot_minus``: modular shifts in one-hot space
  (reference ``GraphDF/model/df_utils.py:79-133``) as a circular-shift
  matrix einsum, the JAX package's formulation.
* ``one_hot_argmax_st``: one-hot argmax with a softmax-temperature
  straight-through gradient (df_utils.py:23-29):
  ``soft + (hard - soft).detach()``.
* ``build_flow_masks`` / ``FlowMasks``: the BFS node/edge mask schedule
  (reference ``GraphDF/model/graphflow.py:230-318``), numpy, copied.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


def _shift_matrix(shift: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return shift[..., torch.as_tensor(idx, device=shift.device)]


def one_hot_add(inputs: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(inputs + shift) mod V in one-hot space: circular convolution.
    out[u] = sum_v inputs[v] * shift[(u - v) % V]."""
    V = inputs.shape[-1]
    idx = (np.arange(V)[:, None] - np.arange(V)[None, :]) % V  # [u, v]
    return torch.einsum("...v,...uv->...u", inputs, _shift_matrix(shift, idx))


def one_hot_minus(inputs: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(inputs - shift) mod V in one-hot space (reference
    df_utils.py:79-102): shift_matrix[u, v] = shift[(v - u) % V]."""
    V = inputs.shape[-1]
    idx = (np.arange(V)[None, :] - np.arange(V)[:, None]) % V  # [u, v]
    return torch.einsum("...v,...uv->...u", inputs, _shift_matrix(shift, idx))


def one_hot_argmax_st(logits: torch.Tensor,
                      temperature: float = 0.1) -> torch.Tensor:
    """Hard one-hot of argmax; gradient of softmax(logits/T)
    (df_utils.py:23-29)."""
    V = logits.shape[-1]
    hard = F.one_hot(torch.argmax(logits, dim=-1), V).to(logits.dtype)
    soft = torch.softmax(logits / temperature, dim=-1)
    return soft + (hard - soft).detach()


class FlowMasks(NamedTuple):
    node_masks: np.ndarray      # [R, N] bool      R = N + num_edge_steps
    adj_masks: np.ndarray       # [R, N, N] bool
    link_index: np.ndarray      # [R - N, 2] int   (j_source, i_new)
    edge_masks: np.ndarray      # [N, N] bool      which adj entries modeled
    num_node_steps: int
    num_edge_steps: int


def build_flow_masks(max_size: int, edge_unroll: int) -> FlowMasks:
    """Autoregressive subgraph-visibility schedule (graphflow.py:230-318):
    node step i sees nodes [0, i) and their induced adjacency; edge step
    (i, j) additionally sees node i's self-loop and previously decided
    edges of node i."""
    N, U = max_size, edge_unroll
    num_edge_steps = int((U - 1) * U / 2 + (N - U) * U)
    R = N + num_edge_steps

    node_masks = np.zeros((R, N), bool)
    adj_masks = np.zeros((R, N, N), bool)
    link_index = np.zeros((num_edge_steps, 2), np.int64)
    edge_masks = np.zeros((N, N), bool)

    cnt_node = 0
    cnt_edge = 0
    for i in range(N):
        node_masks[cnt_node, :i] = True
        adj_masks[cnt_node, :i, :i] = True
        cnt_node += 1
        start = max(i - U, 0)
        for j in range(i if i < U else U):
            k = N + cnt_edge
            node_masks[k, :i + 1] = True
            if j == 0:
                adj_masks[k] = adj_masks[cnt_node - 1]
                adj_masks[k, i, i] = True
            else:
                adj_masks[k] = adj_masks[N + cnt_edge - 1]
                adj_masks[k, i, start + j - 1] = True
                adj_masks[k, start + j - 1, i] = True
            link_index[cnt_edge] = (start + j, i)
            cnt_edge += 1
    assert cnt_edge == num_edge_steps

    for i in range(1, N):
        start = max(i - U, 0)
        edge_masks[i, start:i] = True

    return FlowMasks(node_masks=node_masks, adj_masks=adj_masks,
                     link_index=link_index, edge_masks=edge_masks,
                     num_node_steps=N, num_edge_steps=num_edge_steps)
