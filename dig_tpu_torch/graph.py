"""Static-shape padded graph batch. Port of ``dig_tpu/graph.py``.

Every tensor has a padded shape and validity is tracked with boolean
masks, as in the JAX package:

* node tensors are flat ``[N_pad, ...]``, edge tensors ``[E_pad, ...]``,
  per-graph tensors ``[G, ...]``;
* ``node_graph[n]`` is the graph of node ``n``; padding nodes carry the id
  of the last graph slot and are excluded by ``node_mask``;
* padding edges have ``senders == receivers == 0`` and ``edge_mask``
  False.

``batch_np`` builds a batch on the host with numpy and moves it to
``device`` (default: the CUDA card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device


@dataclasses.dataclass
class GraphBatch:
    """A padded batch of graphs with static shapes.

    Attributes:
      nodes: dict of per-node tensors, each ``[N_pad, ...]``.
      edges: dict of per-edge tensors, each ``[E_pad, ...]`` (may be empty).
      senders: ``[E_pad]`` int32 source node (j in the j->i convention).
      receivers: ``[E_pad]`` int32 destination node (i).
      globals: dict of per-graph tensors, each ``[G, ...]``.
      node_graph: ``[N_pad]`` int32 graph id per node.
      node_mask, edge_mask, graph_mask: bool validity masks.
      n_node, n_edge: ``[G]`` int32 real node / edge counts.
    """

    nodes: Dict[str, torch.Tensor]
    edges: Dict[str, torch.Tensor]
    senders: torch.Tensor
    receivers: torch.Tensor
    globals: Dict[str, torch.Tensor]
    node_graph: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    n_node: torch.Tensor
    n_edge: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def replace(self, **changes) -> "GraphBatch":
        return dataclasses.replace(self, **changes)

    def replace_nodes(self, **kv) -> "GraphBatch":
        return self.replace(nodes={**self.nodes, **kv})

    def replace_edges(self, **kv) -> "GraphBatch":
        return self.replace(edges={**self.edges, **kv})

    def replace_globals(self, **kv) -> "GraphBatch":
        return self.replace(globals={**self.globals, **kv})

    def with_edges(self, senders, receivers, edge_mask,
                   edges=None) -> "GraphBatch":
        """A copy with a new edge structure (e.g. after a radius graph)."""
        g = torch.where(edge_mask, self.node_graph[senders.long()],
                        self.num_graphs - 1)
        n_edge = torch.zeros(self.num_graphs, dtype=torch.int32,
                             device=g.device)
        n_edge.index_add_(0, g.long(), edge_mask.to(torch.int32))
        return self.replace(senders=senders.to(torch.int32),
                            receivers=receivers.to(torch.int32),
                            edge_mask=edge_mask,
                            edges=edges if edges is not None else {},
                            n_edge=n_edge)

    def to(self, device) -> "GraphBatch":
        mv = lambda d: {k: v.to(device) for k, v in d.items()}
        return GraphBatch(
            nodes=mv(self.nodes), edges=mv(self.edges),
            senders=self.senders.to(device),
            receivers=self.receivers.to(device), globals=mv(self.globals),
            node_graph=self.node_graph.to(device),
            node_mask=self.node_mask.to(device),
            edge_mask=self.edge_mask.to(device),
            graph_mask=self.graph_mask.to(device),
            n_node=self.n_node.to(device), n_edge=self.n_edge.to(device))


def batch_np(graphs: Sequence[Dict[str, Any]], n_node_pad: int,
             n_edge_pad: int, num_graphs: Optional[int] = None,
             slot_size: Optional[int] = None,
             device: DeviceLike = None) -> GraphBatch:
    """Host-side (numpy) batching of graph dicts into one GraphBatch.

    Each graph dict may hold per-node arrays under ``nodes``, per-edge
    arrays under ``edges``, ``senders``/``receivers`` and per-graph values
    under ``globals``. Pads nodes to ``n_node_pad``, edges to
    ``n_edge_pad`` and graphs to ``num_graphs``; raises if the content
    exceeds a cap.

    ``slot_size``: slot-aligned layout, graph ``gi``'s nodes start at row
    ``gi * slot_size`` (each graph must fit its slot), which the blocked
    radius builder (``ops.radius.radius_graph_nk_blocked``) requires.
    """
    device = resolve_device(device)
    G = num_graphs if num_graphs is not None else len(graphs)
    if len(graphs) > G:
        raise ValueError(f"{len(graphs)} graphs > num_graphs={G}")
    if slot_size is not None and G * slot_size > n_node_pad:
        raise ValueError(
            f"{G} slots x {slot_size} > n_node_pad={n_node_pad}")

    def count(g):
        return int(g.get("n_node", len(next(iter(g["nodes"].values())))))

    tot_n = sum(count(g) for g in graphs)
    tot_e = sum(int(len(g.get("senders", ()))) for g in graphs)
    if tot_n > n_node_pad:
        raise ValueError(f"{tot_n} nodes > n_node_pad={n_node_pad}")
    if tot_e > n_edge_pad:
        raise ValueError(f"{tot_e} edges > n_edge_pad={n_edge_pad}")

    def keys(field):
        return (set().union(*[g.get(field, {}).keys() for g in graphs])
                if graphs else set())

    def alloc(example, n):
        ex = np.asarray(example)
        return np.zeros((n,) + ex.shape[1:], dtype=ex.dtype)

    node_keys, edge_keys, glob_keys = keys("nodes"), keys("edges"), \
        keys("globals")
    nodes = {k: alloc(next(g["nodes"][k] for g in graphs
                           if k in g["nodes"]), n_node_pad)
             for k in node_keys}
    edges = {k: alloc(next(g["edges"][k] for g in graphs
                           if k in g.get("edges", {})), n_edge_pad)
             for k in edge_keys}
    globals_ = {}
    for k in glob_keys:
        ex = np.atleast_1d(np.asarray(next(
            g["globals"][k] for g in graphs if k in g.get("globals", {}))))
        globals_[k] = np.zeros((G,) + ex.shape, dtype=ex.dtype)

    senders = np.zeros(n_edge_pad, np.int32)
    receivers = np.zeros(n_edge_pad, np.int32)
    node_graph = np.full(n_node_pad, max(G - 1, 0), np.int32)
    node_mask = np.zeros(n_node_pad, bool)
    edge_mask = np.zeros(n_edge_pad, bool)
    graph_mask = np.zeros(G, bool)
    n_node = np.zeros(G, np.int32)
    n_edge = np.zeros(G, np.int32)

    n_off = e_off = 0
    for gi, g in enumerate(graphs):
        nn_, ne = count(g), int(len(g.get("senders", ())))
        if slot_size is not None:
            if nn_ > slot_size:
                raise ValueError(
                    f"graph {gi}: {nn_} nodes > slot_size={slot_size}")
            n_off = gi * slot_size
        for k in node_keys:
            if k in g["nodes"]:
                nodes[k][n_off:n_off + nn_] = np.asarray(g["nodes"][k])
        for k in edge_keys:
            if k in g.get("edges", {}):
                edges[k][e_off:e_off + ne] = np.asarray(g["edges"][k])
        for k in glob_keys:
            if k in g.get("globals", {}):
                globals_[k][gi] = np.asarray(g["globals"][k])
        if ne:
            senders[e_off:e_off + ne] = np.asarray(g["senders"]) + n_off
            receivers[e_off:e_off + ne] = np.asarray(g["receivers"]) + n_off
        node_graph[n_off:n_off + nn_] = gi
        node_mask[n_off:n_off + nn_] = True
        edge_mask[e_off:e_off + ne] = True
        graph_mask[gi] = True
        n_node[gi] = nn_
        n_edge[gi] = ne
        n_off += nn_
        e_off += ne

    t = torch.from_numpy
    return GraphBatch(
        nodes={k: t(v) for k, v in nodes.items()},
        edges={k: t(v) for k, v in edges.items()},
        senders=t(senders), receivers=t(receivers),
        globals={k: t(v) for k, v in globals_.items()},
        node_graph=t(node_graph), node_mask=t(node_mask),
        edge_mask=t(edge_mask), graph_mask=t(graph_mask),
        n_node=t(n_node), n_edge=t(n_edge)).to(device)


def pad_to_next_power(x: int, minimum: int = 8) -> int:
    """Bucketing helper: round up to the next power of two."""
    n = max(int(x), minimum)
    return 1 << (n - 1).bit_length()
