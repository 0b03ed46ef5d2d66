"""Graph-parallel training: partitioned models over a process group. Port of
``dig_tpu/parallel/gp.py`` on ``torch.distributed``.

A graph too big for one card is partitioned into per-rank node slabs;
each layer aggregates local edges while boundary node features move
between ranks by the precomputed all-to-all halo plan
(:mod:`dig_tpu_torch.parallel.halo`), and the only other collectives are
the gradient and count sums.

Design: a **generic engine** (:func:`make_gp_engine`) wraps any module
with the signature ``module(x_local, g: GPLocalGraph, halo_fn)`` — the
module calls ``halo_fn(h) -> [H, F]`` whenever it needs boundary rows for
the next aggregation (see :mod:`dig_tpu_torch.parallel.gp_models`: GCN,
GCNII, PNA and flat SchNet).

Multi-controller: every rank runs the engine's functions with the same
host arrays (:class:`GPGraph` and the ``[P, C, ...]`` slab arrays, or
``[D, P, C, ...]`` on a 2-D mesh) and takes its own part (and data row)
from them; it returns its own ``[C, ...]`` output slab, where the JAX
engine returns the whole sharded ``[P, C, ...]`` array.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import comm
from .halo import build_exchange_plan, halo_exchange_a2a
from .mesh import mesh_device, mesh_group, replicate
from .partition import build_partitions


class GPGraph(NamedTuple):
    """Host-side partitioned graph (numpy; every array leads with the part
    axis, ``[P, ...]``, or with ``[D, P, ...]`` on a 2-D mesh)."""

    senders: np.ndarray         # [P, E]  (index into [C + H) local space)
    receivers: np.ndarray       # [P, E]  (< C)
    edge_mask: np.ndarray       # [P, E]
    node_mask: np.ndarray       # [P, C]
    deg_out: np.ndarray         # [P, C]  global out-degree of owned nodes
    send_slot: np.ndarray       # [P, P, K]
    send_mask: np.ndarray       # [P, P, K]
    recv_pos: np.ndarray        # [P, P, K]


class GPLocalGraph(NamedTuple):
    """One rank's part (no leading part axis), on its device, handed to GP
    modules. ``plans``: the port's sorted edge sets for the neighbour sums
    (``gp_models.gp_plans``), built once; None builds them at first use."""

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    deg_out: torch.Tensor       # [C] global out-degree (sender side spans
    # parts, so it cannot be recovered from local edges alone)
    num_local: int              # C
    plans: Optional[object] = None


def prepare_gp_graph(senders, receivers, num_nodes: int,
                     num_parts: int) -> tuple:
    """Partition + build the exchange plan; returns ``(GPGraph, perm, H,
    C)`` where ``perm`` maps original node id -> (part * C + slot)
    layout."""
    pg = build_partitions(np.asarray(senders), np.asarray(receivers),
                          num_nodes, num_parts)
    plan = build_exchange_plan(pg)
    deg_out = np.bincount(np.asarray(senders),
                          minlength=num_nodes).astype(np.float32)
    deg_out_slab = slab_layout(deg_out, pg.perm, num_parts,
                               pg.nodes_per_part)
    g = GPGraph(senders=pg.senders, receivers=pg.receivers,
                edge_mask=pg.edge_mask, node_mask=pg.node_mask,
                deg_out=deg_out_slab, send_slot=plan.send_slot,
                send_mask=plan.send_mask, recv_pos=plan.recv_pos)
    return g, pg.perm, plan.halo_size, pg.nodes_per_part


def slab_layout(x: np.ndarray, perm: np.ndarray, num_parts: int,
                nodes_per_part: int) -> np.ndarray:
    """[N, ...] node array -> [P, C, ...] slab layout."""
    out = np.zeros((num_parts * nodes_per_part,) + x.shape[1:], x.dtype)
    out[perm] = np.asarray(x)
    return out.reshape((num_parts, nodes_per_part) + x.shape[1:])


def unslab_layout(xs: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """[P, C, ...] slab array -> [N, ...] original node order."""
    flat = np.asarray(xs).reshape((-1,) + xs.shape[2:])
    return flat[perm]


def node_class_loss(out, y, mask):
    """(sum of the masked nodes' softmax cross-entropies, their count)."""
    ls = F.cross_entropy(out, y.long(), reduction="none")
    return (torch.sum(torch.where(mask, ls, 0.0)),
            torch.sum(mask).to(out.dtype))


def node_reg_loss(out, y, mask):
    """(sum of the masked nodes' |out[:, 0] - y|, their count)."""
    ls = torch.abs(out[..., 0] - y)
    return (torch.sum(torch.where(mask, ls, 0.0)),
            torch.sum(mask).to(out.dtype))


def local_graph(g: GPGraph, index, nodes_per_part: int,
                device) -> GPLocalGraph:
    """The part ``index`` (``p``, or ``(d, p)`` on a 2-D mesh) of ``g`` as
    a :class:`GPLocalGraph` on ``device``, with its sum plans."""
    from .gp_models import gp_plans
    t = lambda a: torch.as_tensor(np.asarray(a)[index], device=device)
    gl = GPLocalGraph(senders=t(g.senders).long(),
                      receivers=t(g.receivers).long(),
                      edge_mask=t(g.edge_mask), node_mask=t(g.node_mask),
                      deg_out=t(g.deg_out), num_local=nodes_per_part)
    return gl._replace(plans=gp_plans(gl))


def make_gp_engine(mesh, module, opt, halo_size: int, nodes_per_part: int,
                   loss_fn: Callable = node_class_loss,
                   axis: str = "data", extra_halo_inputs: int = 0,
                   data_axis: Optional[str] = None):
    """Graph-parallel trainer for any ``module(x, g, halo_fn)``.

    ``mesh``: a ``DeviceMesh`` whose ``axis`` dimension holds the parts
    (and whose ``data_axis`` dimension, when given, the replica rows).
    ``opt``: a ``torch.optim.Optimizer`` over ``module``'s parameters.
    Returns ``(init_fn, step_fn, predict_fn)``:

      init_fn(x0, g)            -> module (on this rank's device, its
                                   weights broadcast from the first rank)
      step_fn(g, x, y, mask)    -> (loss, out [C, ...])
      predict_fn(g, x)          -> out [C, ...]

    ``g`` a :class:`GPGraph`, ``x``, ``y``, ``mask`` slab arrays ``[P, C,
    ...]`` (``[D, P, C, ...]`` with ``data_axis``); each rank takes its
    part. The module may call ``halo_fn`` any number of times (once per
    layer); each call is one all_to_all within the ``axis`` group.

    The step sums the masked nodes' losses and counts and the gradients
    over every rank of the mesh (both axes) and divides by the global
    count, as the
    JAX engine's psum over ``(axis, data_axis)`` does: D data rows with
    disjoint masks compute the single-row full-batch update. The module's
    per-layer exchange is issued before its local sum, as the JAX
    package orders it (XLA leaves the overlap to its scheduler; here the
    collectives run synchronously).
    """
    C = nodes_per_part
    H = halo_size
    group, everyone = mesh.get_group(axis), mesh_group(mesh)
    p = mesh.get_local_rank(axis)
    d = None if data_axis is None else mesh.get_local_rank(data_axis)
    idx = p if data_axis is None else (d, p)
    dev = mesh_device(mesh)
    cache = {}

    def _local(g: GPGraph) -> GPLocalGraph:
        hit = cache.get(id(g))
        if hit is None or hit[0] is not g:
            rows = lambda a: torch.as_tensor(np.asarray(a)[idx], device=dev)
            hit = (g, local_graph(g, idx, C, dev),
                   (rows(g.send_slot), rows(g.send_mask), rows(g.recv_pos)))
            cache.clear()
            cache[id(g)] = hit
        return hit[1], hit[2]

    def _halo_fn(tables):
        send_slot, send_mask, recv_pos = tables

        def halo_fn(h):
            return halo_exchange_a2a(h, send_slot, send_mask, recv_pos, H,
                                     group)
        return halo_fn

    def _mine(a, dtype=None):
        t = torch.as_tensor(np.asarray(a)[idx], device=dev)
        return t if dtype is None else t.to(dtype)

    def init_fn(x0=None, g: Optional[GPGraph] = None):
        return replicate(module.to(dev), mesh)

    def step_fn(g: GPGraph, x, y, mask):
        gl, tables = _local(g)
        opt.zero_grad(set_to_none=True)
        out = module(_mine(x, torch.float32), gl, _halo_fn(tables))
        loc, cnt = loss_fn(out, _mine(y), _mine(mask) & gl.node_mask)
        loc.backward()
        params = [q for q in module.parameters() if q.requires_grad]
        grads = [q.grad if q.grad is not None else torch.zeros_like(q)
                 for q in params]
        flat = torch.cat([gr.reshape(-1) for gr in grads]
                         + [loc.detach().reshape(1), cnt.reshape(1)])
        comm.all_reduce_(flat, everyone)
        n = torch.clamp(flat[-1], min=1)
        off = 0
        for q, gr in zip(params, grads):
            k = gr.numel()
            q.grad = (flat[off:off + k] / n).view_as(q)
            off += k
        opt.step()
        return flat[-2] / n, out.detach()

    @torch.no_grad()
    def predict_fn(g: GPGraph, x):
        gl, tables = _local(g)
        return module(_mine(x, torch.float32), gl, _halo_fn(tables))

    return init_fn, step_fn, predict_fn


def make_gp_train_step(mesh, num_layers: int, hidden: int,
                       num_classes: int, in_dim: int, halo_size: int,
                       nodes_per_part: int, lr: float = 1e-2,
                       axis: str = "data", seed: int = 0):
    """``(init_fn, step_fn, predict_fn)`` for a partitioned GCN
    (:class:`~dig_tpu_torch.parallel.gp_models.GPGCN`, weights drawn from
    ``seed``) trained with Adam: :func:`make_gp_engine`'s functions, the
    JAX ``init_fn(key, x0, g) -> (params, opt_state)`` being ``init_fn(x0,
    g) -> (module, optimizer)``."""
    from .gp_models import GPGCN

    module = GPGCN(in_dim, features=tuple([hidden] * (num_layers - 1)
                                          + [num_classes]),
                   generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    init_fn, step, predict = make_gp_engine(
        mesh, module, opt, halo_size, nodes_per_part,
        loss_fn=node_class_loss, axis=axis)

    def init_with_opt(x0=None, g=None):
        return init_fn(x0, g), opt

    return init_with_opt, step, predict
