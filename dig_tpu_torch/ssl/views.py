"""Graph augmentation views as transforms on GraphBatch. Port of
``dig_tpu/ssl/views.py``.

Reference: ``dig/sslgraph/method/contrastive/views_fn/{sample.py,
structure.py, feature.py, combination.py}``. Every view works over *masks*
with static shapes, on the batch's device, with no host synchronisation:

* node dropping flips ``node_mask`` (and incident ``edge_mask``) instead of
  relabeling;
* edge adding writes into free (padding) edge slots;
* per-graph "choose k of n" selections use an O(N^2) same-graph rank trick
  instead of per-graph randperm.

Each view is ``view(gen, g) -> g'`` (``Diffusion``: ``(g', diff)``), where
the JAX view takes a PRNG key. It is written as a draw and an apply:
``view.draw(gen, g)`` draws the view's noise from the ``torch.Generator``
``gen`` (on the generator's device; it reads only ``g``'s shapes), and
``view.apply(g, noise)`` transforms the batch with that noise, so the same
noise can be given to two devices, or the noise a JAX view draws from its
key. Semantics parity notes are on each class.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..graph import GraphBatch
from ..ops.segment import segment_max


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _on(t: torch.Tensor, g: GraphBatch) -> torch.Tensor:
    return t.to(g.node_mask.device)


def draw_noise(view, gen: torch.Generator, g: GraphBatch):
    """``view.draw(gen, g)``, or None for a view without one (a plain
    callable such as :func:`identity_view`)."""
    return view.draw(gen, g) if hasattr(view, "draw") else None


def apply_view(view, g: GraphBatch, noise, gen=None):
    """``view.apply(g, noise)``; a plain callable is called as
    ``view(gen, g)``."""
    return view.apply(g, noise) if hasattr(view, "apply") else view(gen, g)


class _View:
    """``view(gen, g) == view.apply(g, view.draw(gen, g))``."""

    def draw(self, gen: torch.Generator, g: GraphBatch):
        raise NotImplementedError

    def apply(self, g: GraphBatch, noise):
        raise NotImplementedError

    def __call__(self, gen: torch.Generator, g: GraphBatch):
        return self.apply(g, self.draw(gen, g))


def identity_view(gen, g: GraphBatch) -> GraphBatch:
    return g


def _rank_in_graph(scores, node_graph, mask):
    """rank[i] = #{j real, same graph, scores[j] < scores[i]} (O(N^2))."""
    same = node_graph[:, None] == node_graph[None, :]
    valid = mask[:, None] & mask[None, :] & same
    less = scores[None, :] < scores[:, None]
    return torch.sum(valid & less, dim=1)


def _drop_edges_for_nodes(g: GraphBatch, keep_nodes) -> GraphBatch:
    em = (g.edge_mask & keep_nodes[g.senders.long()]
          & keep_nodes[g.receivers.long()])
    return g.replace(node_mask=g.node_mask & keep_nodes, edge_mask=em)


def _count_per_graph(flags, node_graph, G):
    """Integer count of the True ``flags`` per graph."""
    cnt = torch.zeros(G, dtype=torch.int32, device=flags.device)
    return cnt.index_add_(0, node_graph.long(), flags.to(torch.int32))


def _keep_count(n_node, ratio):
    """floor(n * ratio) per graph, in float32 as the JAX views."""
    return torch.floor(n_node.to(torch.float32) * ratio).to(torch.int32)


class UniformSample(_View):
    """Uniform node dropping (reference sample.py:7-45): keeps
    floor(n*(1-ratio)) nodes per graph, drops incident edges. Noise:
    ``scores [N]`` uniform."""

    def __init__(self, ratio: float = 0.1):
        self.ratio = ratio

    def draw(self, gen, g):
        return {"scores": _uniform(gen, (g.num_nodes,))}

    def apply(self, g, noise):
        rank = _rank_in_graph(_on(noise["scores"], g), g.node_graph,
                              g.node_mask)
        keep_num = _keep_count(g.n_node, 1.0 - self.ratio)
        keep = g.node_mask & (rank < keep_num[g.node_graph.long()])
        return _drop_edges_for_nodes(g, keep)


class RWSample(_View):
    """Random-walk subgraph sampling (reference sample.py:49-109): grow a
    connected node set from a random seed until ~ratio*n nodes, keep only
    those nodes. Fixed-step frontier growth with masking (static shapes):
    ``max(N / G, 4)`` steps (``max_steps``), none of which reads a value on
    the host. Noise: ``seed [N]`` and ``walk [steps, N]`` uniform."""

    def __init__(self, ratio: float = 0.1, max_steps: Optional[int] = None):
        self.ratio = ratio
        self.max_steps = max_steps

    def steps(self, g: GraphBatch) -> int:
        return self.max_steps or max(int(g.num_nodes / max(g.num_graphs, 1)),
                                     4)

    def draw(self, gen, g):
        return {"seed": _uniform(gen, (g.num_nodes,)),
                "walk": _uniform(gen, (self.steps(g), g.num_nodes))}

    def apply(self, g, noise):
        N, G = g.num_nodes, g.num_graphs
        ng = g.node_graph.long()
        snd, rcv = g.senders.long(), g.receivers.long()
        target = torch.clamp(torch.floor(
            g.n_node.to(torch.float32) * self.ratio), min=1.0).to(torch.int32)
        # seed: random real node per graph (max of uniforms per segment)
        s0 = torch.where(g.node_mask, _on(noise["seed"], g), -1.0)
        mx = segment_max(s0, g.node_graph, G)
        selected = g.node_mask & (s0 == mx[ng])
        walk = _on(noise["walk"], g)
        for k in range(self.steps(g)):
            # frontier: unselected real neighbors of the selected set
            hit = torch.zeros(N, dtype=torch.int32, device=s0.device)
            hit.index_add_(0, rcv, (selected[snd] & g.edge_mask)
                           .to(torch.int32))
            cand = (hit > 0) & g.node_mask & ~selected
            want = _count_per_graph(selected, g.node_graph, G) < target
            sc = torch.where(cand & want[ng], walk[k], -1.0)
            m = segment_max(sc, g.node_graph, G)
            selected = selected | (cand & (sc == m[ng]) & (sc > 0))
        return _drop_edges_for_nodes(g, selected)


class EdgePerturbation(_View):
    """Edge dropping/adding (reference structure.py:7-56): drop each real
    edge w.p. ratio; add floor(ratio*E_real) random intra-graph edges into
    free (padding) slots. Noise: ``keep_u [E]`` uniform (drop); ``a_u
    [E]`` uniform, the first endpoint uniform over the real nodes of the
    batch it is applied to, and ``off [E]`` integers in [0, 2^30) for the
    second (add)."""

    def __init__(self, add: bool = True, drop: bool = False,
                 ratio: float = 0.1):
        self.add = add
        self.drop = drop
        self.ratio = ratio

    def draw(self, gen, g):
        E = g.num_edges
        noise = {}
        if self.drop:
            noise["keep_u"] = _uniform(gen, (E,))
        if self.add:
            noise["a_u"] = _uniform(gen, (E,))
            noise["off"] = torch.randint(0, 1 << 30, (E,), generator=gen,
                                         device=gen.device)
        return noise

    @staticmethod
    def _real_node(g, u):
        """The floor(u * n)-th real node (n real nodes), for uniform u."""
        cnt = torch.cumsum(g.node_mask.to(torch.int64), 0)
        k = torch.minimum(torch.floor(u * cnt[-1].to(u.dtype)).long(),
                          torch.clamp(cnt[-1] - 1, min=0))
        return torch.clamp(torch.searchsorted(cnt, k + 1), max=g.num_nodes - 1)

    def apply(self, g, noise):
        em = g.edge_mask
        senders, receivers = g.senders.long(), g.receivers.long()
        if self.drop:
            em = em & (_on(noise["keep_u"], g) >= self.ratio)
        if self.add:
            total_real = torch.sum(g.edge_mask).to(torch.float32)
            n_add = torch.floor(total_real * self.ratio).to(torch.int64)
            free = ~em
            # enumerate free slots; activate the first n_add of them
            free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
            activate = free & (free_rank < n_add)
            a = self._real_node(g, _on(noise["a_u"], g))
            # endpoint b: uniform within a's graph (contiguous layout)
            n_node = g.n_node.long()
            start = torch.cumsum(n_node, 0) - n_node
            ga = g.node_graph.long()[a]
            off = _on(noise["off"], g).long()
            b = start[ga] + off % torch.clamp(n_node[ga], min=1)
            senders = torch.where(activate, a, senders)
            receivers = torch.where(activate, b, receivers)
            em = em | activate
            senders = torch.where(em, senders, 0)
            receivers = torch.where(em, receivers, 0)
        return g.replace(senders=senders.to(torch.int32),
                         receivers=receivers.to(torch.int32), edge_mask=em)


class NodeAttrMask(_View):
    """Node attribute masking (reference feature.py:9-70). mode='whole':
    floor(n*ratio) nodes per graph get features ~ N(mean, std) (or the
    constant mean when std == 0); mode='partial': independent elementwise
    Bernoulli(ratio) replacement. Noise: ``scores [N]`` (whole) or ``sel
    x.shape`` (partial) uniform, and ``z x.shape`` standard normal."""

    def __init__(self, mode: str = "whole", mask_ratio: float = 0.1,
                 mask_mean: float = 0.5, mask_std: float = 0.5):
        if mode not in ("whole", "partial"):
            raise ValueError(f"unknown mode {mode}")
        self.mode = mode
        self.mask_ratio = mask_ratio
        self.mask_mean = mask_mean
        self.mask_std = mask_std

    def draw(self, gen, g):
        shape = tuple(g.nodes["x"].shape)
        if self.mode == "whole":
            noise = {"scores": _uniform(gen, (g.num_nodes,))}
            if self.mask_std > 0:
                noise["z"] = _normal(gen, shape)
            return noise
        return {"sel": _uniform(gen, shape), "z": _normal(gen, shape)}

    def apply(self, g, noise):
        x = g.nodes["x"]
        if self.mode == "whole":
            rank = _rank_in_graph(_on(noise["scores"], g), g.node_graph,
                                  g.node_mask)
            mask_num = _keep_count(g.n_node, self.mask_ratio)
            sel = g.node_mask & (rank < mask_num[g.node_graph.long()])
            if self.mask_std > 0:
                repl = self.mask_mean + self.mask_std * _on(noise["z"], g)
            else:
                repl = torch.full_like(x, self.mask_mean)
            x = torch.where(sel[:, None], repl, x)
        else:
            sel = _on(noise["sel"], g) < self.mask_ratio
            repl = self.mask_mean + self.mask_std * _on(noise["z"], g)
            x = torch.where(sel & g.node_mask[:, None], repl, x)
        return g.replace_nodes(x=x)


class Diffusion(_View):
    """Graph diffusion (PPR / heat kernel) used by MVGRL (reference
    structure.py:110-174). Deterministic (no noise); returns the dense
    [N, N] block-diagonal diffusion matrix alongside the (unchanged) batch:
    message passing with the diffusion view is then one masked matmul. The
    PPR inverse is ``torch.linalg.inv_ex`` (a dense inverse, as the JAX
    view's ``jnp.linalg.inv``; it reads no error flag on the host)."""

    def __init__(self, mode: str = "ppr", alpha: float = 0.2, t: float = 5.0,
                 add_self_loop: bool = True):
        if mode not in ("ppr", "heat"):
            raise ValueError(mode)
        self.mode = mode
        self.alpha = alpha
        self.t = t
        self.add_self_loop = add_self_loop

    def dense_adj(self, g: GraphBatch) -> torch.Tensor:
        N = g.num_nodes
        w = g.edge_mask.to(torch.float32)
        flat = g.receivers.long() * N + g.senders.long()
        A = torch.zeros(N * N, device=w.device).scatter_reduce(
            0, flat, w, "amax", include_self=True).reshape(N, N)
        if self.add_self_loop:
            eye = torch.eye(N, dtype=torch.bool, device=w.device)
            A = torch.where(eye & g.node_mask[:, None], 1.0, A)
        return A

    def draw(self, gen, g):
        return None

    def apply(self, g, noise=None) -> Tuple[GraphBatch, torch.Tensor]:
        A = self.dense_adj(g)
        N = A.shape[0]
        deg = torch.sum(A, dim=1)
        eye = torch.eye(N, device=A.device)
        if self.mode == "ppr":
            dinv_sqrt = torch.rsqrt(torch.clamp(deg, min=1e-12))
            # zero-degree (padding) rows: keep identity so inverse exists
            at = A * dinv_sqrt[:, None] * dinv_sqrt[None, :]
            diff = self.alpha * torch.linalg.inv_ex(
                eye - (1 - self.alpha) * at).inverse
        else:
            dinv = 1.0 / torch.clamp(deg, min=1e-12)
            # reference: elementwise exp(t*(A D^-1 - 1)) (structure.py:150)
            diff = torch.exp(self.t * (A * dinv[None, :] - 1.0))
        valid = g.node_mask[:, None] & g.node_mask[None, :]
        valid = valid & (g.node_graph[:, None] == g.node_graph[None, :])
        return g, torch.where(valid, diff, 0.0)


def _select(c: torch.Tensor, a, b):
    """``a`` where the scalar bool ``c`` holds, else ``b``, field by field
    (two batches or two tensors)."""
    if isinstance(a, torch.Tensor):
        return a if a is b else torch.where(c, a, b)
    if isinstance(a, dict):
        return {k: _select(c, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_select(c, x, y) for x, y in zip(a, b))
    return GraphBatch(**{f.name: _select(c, getattr(a, f.name),
                                         getattr(b, f.name))
                         for f in dataclasses.fields(GraphBatch)})


class RandomView(_View):
    """Pick one candidate view at random per call (reference
    combination.py:5-28). The pick stays on the device: every candidate is
    applied and the picked one's batch selected field by field (the JAX
    view runs the picked branch of a ``lax.switch``), so no host
    synchronisation reads it. Noise: ``idx`` (a scalar integer) and each
    candidate's noise."""

    def __init__(self, candidates: Sequence[Callable]):
        self.candidates = list(candidates)

    def draw(self, gen, g):
        return {"idx": torch.randint(0, len(self.candidates), (),
                                     generator=gen, device=gen.device),
                "views": [draw_noise(c, gen, g) for c in self.candidates]}

    def apply(self, g, noise):
        idx = _on(noise["idx"], g)
        out = None
        for i, (c, n) in enumerate(zip(self.candidates, noise["views"])):
            gi = apply_view(c, g, n)
            out = gi if out is None else _select(idx == i, gi, out)
        return out


class SequentialView(_View):
    """Apply views in sequence (reference combination.py:31-62). Noise: the
    views' noises in order."""

    def __init__(self, views: Sequence[Callable]):
        self.views = list(views)

    def draw(self, gen, g):
        return [draw_noise(v, gen, g) for v in self.views]

    def apply(self, g, noise):
        for v, n in zip(self.views, noise):
            g = apply_view(v, g, n)
        return g


class DiffusionWithSample(_View):
    """Subgraph sampling + diffusion for node-level MVGRL on large graphs
    (reference structure.py:178-270): sample ``sample_size`` nodes, keep
    the induced subgraph, return it with its dense diffusion matrix.
    Noise: ``scores [N]`` uniform."""

    def __init__(self, sample_size: int = 2000, mode: str = "ppr",
                 alpha: float = 0.2, t: float = 5.0,
                 add_self_loop: bool = True):
        self.sample_size = sample_size
        self.diffusion = Diffusion(mode, alpha, t, add_self_loop)

    def draw(self, gen, g):
        return {"scores": _uniform(gen, (g.num_nodes,))}

    def apply(self, g, noise):
        rank = _rank_in_graph(_on(noise["scores"], g), g.node_graph,
                              g.node_mask)
        keep = g.node_mask & (rank < self.sample_size)
        return self.diffusion.apply(_drop_edges_for_nodes(g, keep))
