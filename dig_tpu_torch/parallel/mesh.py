"""Device mesh + sharding helpers. Port of ``dig_tpu/parallel/mesh.py`` on
``torch.distributed``.

The JAX package runs one controller over a ``jax.sharding.Mesh`` and
shards arrays across it. Here every rank is a process running the same
program on its own shard (multi-controller SPMD, one process a card): the
mesh is a ``DeviceMesh`` over the process group, "sharding" a batch means
taking this rank's slice, and "replicating" a tree means broadcasting it
from rank 0.

Each data shard must be a *self-contained* set of graphs: the host loader
builds per-rank sub-batches (graph ids never cross a shard boundary), so
segment reductions stay local and the only collective of a DP step is the
gradient all-reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..graph import GraphBatch


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over the whole process group with named dimensions.
    Default: 1-D ``data`` over every rank; ``shape=(dp, mp)`` with
    ``axis_names=('data', 'model')`` for 2-D. ``device_type``: ``cuda``
    under NCCL, else ``cpu`` (default: from the group's backend)."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the "
                         f"{world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def data_parallel_sharding(mesh: DeviceMesh, axis: str = "data"):
    """(batch placement, parameter placement) for a 1-D data mesh: the
    batch sharded on its leading axis, the parameters replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def _map(fn, g: GraphBatch, *rest: GraphBatch) -> GraphBatch:
    """``fn`` over every tensor field of ``g`` (and of ``rest`` alongside)."""
    out = {}
    for f in dataclasses.fields(GraphBatch):
        v = getattr(g, f.name)
        if isinstance(v, dict):
            out[f.name] = {k: fn(v[k], *(getattr(r, f.name)[k]
                                         for r in rest)) for k in v}
        else:
            out[f.name] = fn(v, *(getattr(r, f.name) for r in rest))
    return GraphBatch(**out)


def shard_graph_batch(g: GraphBatch, mesh: DeviceMesh,
                      axis: str = "data") -> GraphBatch:
    """This rank's slab of ``g`` along ``axis``, on its device: every
    tensor whose leading size divides by the axis size is cut into that
    many equal slabs (the loader builds ``num_shards`` equal sub-batches
    back to back, see :func:`concat_local_shards`), the others are kept
    whole (the JAX package replicates them)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    i = mesh.get_local_rank(axis)
    dev = mesh_device(mesh)

    def take(x):
        if x.ndim >= 1 and x.shape[0] % n == 0:
            k = x.shape[0] // n
            x = x[i * k:(i + 1) * k]
        return x.to(dev)

    return _map(take, g)


def mesh_group(mesh: DeviceMesh):
    """The process group of all of ``mesh``'s ranks: its own group when
    it is 1-D (a sub-mesh too), else the default group (a mesh of more
    dimensions spans the whole process group)."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.size() != dist.get_world_size():
        raise ValueError("a mesh of more than one dimension must span "
                         "every rank")
    return None


def replicate(tree: Any, mesh: DeviceMesh):
    """Make a module's parameters and buffers (or a dict / list of
    tensors) equal on every rank of ``mesh``: broadcast from its first
    rank, in place. Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    src, group = int(mesh.mesh.reshape(-1)[0]), mesh_group(mesh)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return tree


def local_graph_offsets(g, num_shards: int):
    """Rebase node indices per shard: when a GraphBatch built as
    ``num_shards`` contiguous sub-batches is split along axis 0, edge
    senders/receivers must index into the *local* node slab. Host-side
    (numpy) helper, as in the JAX package."""
    n_per = g.senders.shape[0] // num_shards  # edges per shard
    nodes_per = g.node_mask.shape[0] // num_shards
    graphs_per = g.graph_mask.shape[0] // num_shards
    e_shard = np.repeat(np.arange(num_shards), n_per)
    n_shard = np.repeat(np.arange(num_shards), nodes_per)
    senders = np.asarray(g.senders) - e_shard * nodes_per
    receivers = np.asarray(g.receivers) - e_shard * nodes_per
    node_graph = np.asarray(g.node_graph) - n_shard * graphs_per
    return senders, receivers, node_graph


def concat_local_shards(batches: Sequence[GraphBatch]) -> GraphBatch:
    """Concatenate per-shard GraphBatches along axis 0 WITHOUT rebasing
    indices: each slab keeps shard-local senders/receivers/node_graph,
    which is what the DP step expects of its rank's slab
    (:func:`shard_graph_batch`). All shards must have identical shapes."""
    return _map(lambda *xs: torch.cat(xs, 0), *batches)
