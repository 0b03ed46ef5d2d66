"""Generic contrastive pretraining engine. Port of
``dig_tpu/ssl/contrastive.py``.

Parity with ``dig/sslgraph/method/contrastive/model/contrastive.py:86-220``:
views_fn list -> shared (or per-view) encoders -> projection heads ->
objective; yields the trained encoder per epoch (``per_epoch_out``) or after
the last epoch; graph-level / node-level / joint modes; JSE
corruption-negatives.

The step (views -> encode -> project -> loss -> backward -> Adam) runs on
the device with the views' noise drawn from a ``torch.Generator`` there.
The JAX package runs a whole epoch as one ``lax.scan``; here an epoch is a
per-batch loop that reads nothing on the host until it ends: the epoch's
batches are moved to the device before it, the losses stay on the device
and are read once an epoch.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from .encoders import init_weights
from .objectives import jse_local_global_neg_paired, jse_loss, nce_loss
from .views import apply_view, draw_noise


class ProjHead(nn.Module):
    """Projection head: ``linear`` (one Dense) or ``MLP`` (Dense, relu,
    Dense); ``in_dim`` is the embedding width (flax infers it)."""

    def __init__(self, in_dim: int, out_dim: int, kind: str = "MLP"):
        super().__init__()
        self.kind = kind
        self.lin1 = nn.Linear(in_dim, out_dim)
        self.lin2 = nn.Linear(out_dim, out_dim) if kind != "linear" else None

    def forward(self, z):
        if self.lin2 is None:
            return self.lin1(z)
        return self.lin2(torch.relu(self.lin1(z)))


def corrupt_graph(gen: torch.Generator, g: GraphBatch,
                  perm: Optional[torch.Tensor] = None) -> GraphBatch:
    """Shuffle node features across the batch (JSE negative sampling,
    reference contrastive.py:378-389); ``perm`` drawn from ``gen`` unless
    given."""
    if perm is None:
        perm = torch.randperm(g.num_nodes, generator=gen, device=gen.device)
    return g.replace_nodes(x=g.nodes["x"][perm.to(g.node_mask.device)])


def _snapshot(module: Optional[nn.Module]):
    if module is None:
        return None
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


class Contrastive:
    """Pretrain engine. ``objective``: 'NCE' | 'JSE' | callable."""

    def __init__(self, objective, views_fn: Sequence[Callable],
                 graph_level: bool = True, node_level: bool = False,
                 z_dim: Optional[int] = None, z_n_dim: Optional[int] = None,
                 proj: Optional[str] = None, proj_n: Optional[str] = None,
                 neg_by_crpt: bool = False, tau: float = 0.5,
                 choice_model: str = "last", model_path: str = "models",
                 seed: int = 12345):
        if not (graph_level or node_level):
            raise ValueError("graph_level or node_level must be set")
        if objective == "NCE" and neg_by_crpt:
            raise ValueError("neg_by_crpt needs the JSE objective")
        self.objective = objective
        self.views_fn = list(views_fn)
        self.graph_level = graph_level
        self.node_level = node_level
        self.z_dim = z_dim
        self.z_n_dim = z_n_dim
        self.proj = proj
        self.proj_n = proj_n
        self.neg_by_crpt = neg_by_crpt
        self.tau = tau
        self.choice_model = choice_model
        self.model_path = model_path
        self.seed = seed

    # -- loss dispatch ---------------------------------------------------
    def _loss(self, zs, zs_n, batch, graph_mask, node_mask):
        if callable(self.objective):
            return self.objective(zs=zs, zs_n=zs_n, batch=batch)
        if self.objective == "NCE":
            return nce_loss(zs, zs_n, batch, tau=self.tau,
                            graph_mask=graph_mask, node_mask=node_mask)
        if self.objective == "JSE":
            if self.neg_by_crpt and zs is not None and zs_n is not None:
                loss = 0.0
                for zg, zn in zip(zs, zs_n):
                    loss += jse_local_global_neg_paired(
                        zg, zn, batch, graph_mask, node_mask)
                return loss
            return jse_loss(zs, zs_n, batch, graph_mask=graph_mask,
                            node_mask=node_mask)
        raise ValueError(self.objective)

    # -- the pieces of a step ---------------------------------------------
    def make_heads(self, generator: torch.Generator,
                   device: DeviceLike = None) -> Dict[str, Optional[nn.Module]]:
        """The projection heads ``{"pg": ..., "pn": ...}`` (None where the
        engine has none), weights drawn from ``generator`` (graph head
        first): the graph head projects z_dim -> z_n_dim (or z_dim), the
        node head z_n_dim -> z_n_dim (reference contrastive.py:105-125)."""
        out = self.z_n_dim if self.z_n_dim is not None else self.z_dim
        heads = {"pg": (ProjHead(self.z_dim, out, self.proj)
                        if self.graph_level and self.proj else None),
                 "pn": (ProjHead(out, out, self.proj_n)
                        if self.node_level and self.proj_n else None)}
        dev = resolve_device(device)
        for h in heads.values():
            if h is not None:
                init_weights(h, generator)
                h.to(dev)
        return heads

    def draw(self, gen: torch.Generator, g: GraphBatch):
        """One step's noise: each view's (``views.draw_noise``) and the
        corruption permutation (``neg_by_crpt``)."""
        noise = {"views": [draw_noise(v, gen, g) for v in self.views_fn]}
        if self.neg_by_crpt:
            noise["crpt"] = torch.randperm(g.num_nodes, generator=gen,
                                           device=gen.device)
        return noise

    def _encode(self, enc, heads, g):
        out = enc(g)
        if self.graph_level and self.node_level:
            zg, zn = out
        elif self.graph_level:
            zg, zn = out, None
        else:
            zg, zn = None, out
        if zg is not None and heads["pg"] is not None:
            zg = heads["pg"](zg)
        if zn is not None and heads["pn"] is not None:
            zn = heads["pn"](zn)
        return zg, zn

    def loss_of(self, encoders: Sequence[nn.Module], heads, g: GraphBatch,
                noise, gen: Optional[torch.Generator] = None):
        """The step's loss: one encoder per view (the same module when
        shared), the heads of :meth:`make_heads`, the batch and the noise
        of :meth:`draw` (``gen`` serves plain callable views)."""
        zs, zs_n = [], []
        for vfn, enc, n in zip(self.views_fn, encoders, noise["views"]):
            out = apply_view(vfn, g, n, gen)
            gv = out[0] if isinstance(out, tuple) else out
            zg, zn = self._encode(enc, heads, gv)
            if self.neg_by_crpt:
                zg_c, zn_c = self._encode(
                    enc, heads, corrupt_graph(gen, gv, noise["crpt"]))
                zg = torch.cat([zg, zg_c]) if zg is not None else None
                zn = torch.cat([zn, zn_c]) if zn is not None else None
            if zg is not None:
                zs.append(zg)
            if zn is not None:
                zs_n.append(zn)
        return self._loss(zs or None, zs_n or None, g.node_graph,
                          g.graph_mask, g.node_mask)

    def make_step(self, encoders, heads, opt: torch.optim.Optimizer,
                  gen: torch.Generator):
        """``step(g) -> loss``: one training step on a batch on the device
        (the views' noise drawn from ``gen``, the loss, its backward, the
        optimizer's step); the loss stays on the device."""
        def step(g):
            noise = self.draw(gen, g)
            opt.zero_grad(set_to_none=True)
            loss = self.loss_of(encoders, heads, g, noise, gen)
            loss.backward()
            opt.step()
            return loss.detach()
        return step

    # -- training --------------------------------------------------------
    def train(self, encoder, data_loader, optimizer=None, epochs: int = 20,
              per_epoch_out: bool = False, lr: float = 1e-3,
              device: DeviceLike = None):
        """Generator yielding dict(encoder_params, proj_params, apply,
        loss) per epoch (``per_epoch_out``) or once at the end.

        ``encoder``: a module (shared across views) or a list of modules,
        one per view (reference supports both, contrastive.py:143-157).
        The encoders train from their current weights, moved to
        ``device`` (None: the card); the JAX engine draws fresh ones from
        ``seed``. The projection heads are :meth:`make_heads`' from a
        generator seeded with ``seed``. ``optimizer``: a callable
        ``params -> torch.optim.Optimizer``, or None for
        ``torch.optim.Adam(params, lr)`` (the JAX engine's
        ``optax.adam(lr)``). The views' noise comes from a generator on the
        device seeded with ``seed``. ``encoder_params`` / ``proj_params``
        are state-dict snapshots; ``apply(g)`` embeds a batch with the
        first encoder at the snapshot's weights.
        """
        dev = resolve_device(device)
        shared = not isinstance(encoder, (list, tuple))
        encoders = ([encoder] * len(self.views_fn) if shared
                    else list(encoder))
        if len(encoders) != len(self.views_fn):
            raise ValueError(f"{len(encoders)} encoders for "
                             f"{len(self.views_fn)} views")
        unique = encoders[:1] if shared else encoders
        for e in unique:
            e.to(dev)
        heads = self.make_heads(torch.Generator().manual_seed(self.seed), dev)
        params = [p for m in unique + [h for h in heads.values() if h]
                  for p in m.parameters()]
        opt = (optimizer(params) if optimizer is not None
               else torch.optim.Adam(params, lr=lr))
        step = self.make_step(encoders, heads, opt, torch.Generator(
            device=dev).manual_seed(self.seed))
        best_loss = float("inf")
        best = None
        epoch_loss = float("nan")
        for _ in range(epochs):
            batches = [b.to(dev) for b in data_loader]
            losses = [step(g) for g in batches]
            epoch_loss = float(torch.stack(losses).mean())
            if epoch_loss < best_loss:
                best_loss = epoch_loss
                if self.choice_model == "best":
                    best = self._result(unique, heads, epoch_loss)
            if per_epoch_out:
                yield self._result(unique, heads, epoch_loss)
        if self.choice_model == "best":
            yield (best if best is not None
                   else self._result(unique, heads, best_loss))
        elif not per_epoch_out:
            yield self._result(unique, heads, epoch_loss)

    def _result(self, encoders, heads, loss):
        enc_params = [_snapshot(e) for e in encoders]
        enc = encoders[0]

        def apply(g: GraphBatch):
            return functional_call(enc, enc_params[0], (g,))

        return {"encoder_params": enc_params,
                "proj_params": {k: _snapshot(h) for k, h in heads.items()},
                "apply": apply, "loss": loss}
