"""Graphair: automated fair augmentation + contrastive encoder + adversary.
Port of ``dig_tpu/fairgraph/graphair.py``.

* ``AugModule`` g — GCN body -> (edge-probability logits Z Z^T with
  straight-through relaxed-Bernoulli sampling; feature-mask logits).
* ``GCNBody`` f — dense-adjacency GCN encoder.
* ``SensAdv`` k — adversary predicting the sensitive attribute from the
  representation of the *augmented* graph.
* ``Graphair.fit_whole`` — warmup on reconstruction, alternating adversary
  maximization and (contrastive + reconstruction - alpha * adversary)
  minimization; ``test`` trains a logistic classifier on frozen embeddings
  and reports accuracy / DP / EO.

Dense ``[N, N]`` adjacency throughout, as in the JAX package: every conv
is a ``torch.matmul`` (no kernel of the port's; the JAX package computes
these products outside Pallas too). One float32 ``[N, N]`` matrix at
67,000 nodes (POKEC) is 18 GB and a step keeps dozens, so the layout is
for graphs of a few thousand nodes.

Randomness: the JAX package draws the relaxed-Bernoulli uniforms from
split keys, two draws a step (edges ``[N, N]``, feature mask ``[N, F]``).
Here each step takes them as an argument, :meth:`Graphair.draw` draws them
from a ``torch.Generator`` and :meth:`Graphair.fit_whole` calls it once a
step (the tests replay the JAX draws through it).

The optimisers are optax's, written out (:class:`OptaxAdamW`): one AdamW
over ``{aug, enc, proj}`` with a single step count, and the warm-up steps
advance every moment and the count while applying only ``aug``'s update,
as the JAX ``warm_step`` feeds zero gradients to ``enc`` and ``proj`` and
keeps ``aug``'s update alone. ``torch.optim.AdamW`` keeps a count per
parameter and would decay ``enc`` and ``proj`` during the warm-up.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..nn.init import xavier_uniform

Noise = Tuple[torch.Tensor, torch.Tensor]


def _dense(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    xavier_uniform(lin.weight, gen)
    nn.init.zeros_(lin.bias)
    return lin


def normalize_adj(adj: torch.Tensor) -> torch.Tensor:
    """A <- D^-1/2 (A + I) D^-1/2 (the diagonal set to 1)."""
    n = adj.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    adj = torch.where(eye, 1.0, adj)
    d = torch.sum(adj, dim=1)
    dinv = torch.rsqrt(torch.clamp(d, min=1e-12))
    return adj * dinv[:, None] * dinv[None, :]


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax ``sigmoid_binary_cross_entropy``, elementwise."""
    return F.binary_cross_entropy_with_logits(logits, labels,
                                              reduction="none")


class GCNBody(nn.Module):
    """``nlayer`` dense GCN layers: relu(adj @ W h) between, adj @ W h
    last (flax ``Dense_i`` in layer order)."""

    def __init__(self, in_dim: int, hidden: int = 64, out: int = 64,
                 nlayer: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dims = [in_dim] + [hidden] * (nlayer - 1) + [out]
        self.layers = nn.ModuleList(_dense(a, b, gen)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, adj, x):
        h = x
        for lin in self.layers[:-1]:
            h = torch.relu(adj @ lin(h))
        return adj @ self.layers[-1](h)


def relaxed_bernoulli_st(u: torch.Tensor, probs: torch.Tensor,
                         temperature: float = 1.0) -> torch.Tensor:
    """RelaxedBernoulliStraightThrough on the uniforms ``u`` (in [1e-6,
    1 - 1e-6)): the concrete sample rounded to {0, 1} forward, the
    gradient through the relaxation."""
    logistic = torch.log(u) - torch.log(1 - u)
    logits = torch.log(probs + 1e-12) - torch.log1p(-probs + 1e-12)
    soft = torch.sigmoid((logits + logistic) / temperature)
    hard = (soft > 0.5).to(soft.dtype)
    return soft + (hard - soft).detach()


class AugModule(nn.Module):
    """The augmenter: a one-layer GCN body, an edge MLP (``z z^T`` edge
    logits), a feature-mask MLP. Flax names: ``GCNBody_0``, the edge MLP's
    outer ``Dense_0`` and inner ``Dense_1``, the mask MLP's outer
    ``Dense_2`` and inner ``Dense_3`` (flax numbers a nested call's
    callee before its argument)."""

    def __init__(self, feat_dim: int, hidden: int = 64,
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.temperature = temperature
        self.body = GCNBody(feat_dim, hidden, hidden, nlayer=1, generator=gen)
        self.edge_in = _dense(hidden, hidden, gen)
        self.edge_out = _dense(hidden, hidden, gen)
        self.mask_in = _dense(hidden, hidden, gen)
        self.mask_out = _dense(hidden, feat_dim, gen)

    def forward(self, adj, x, noise: Noise, alpha: float = 0.5,
                adj_orig=None):
        u_edge, u_mask = noise
        h = self.body(adj, x)
        z = self.edge_out(torch.relu(self.edge_in(h)))
        adj_logits = z @ z.T
        edge_probs = torch.sigmoid(adj_logits)
        if adj_orig is not None:
            edge_probs = alpha * edge_probs + (1 - alpha) * adj_orig
        a = relaxed_bernoulli_st(u_edge, edge_probs, self.temperature)
        a = torch.triu(a, 1)
        a = normalize_adj(a + a.T)
        mask_logits = self.mask_out(torch.relu(self.mask_in(h)))
        mask = relaxed_bernoulli_st(u_mask, torch.sigmoid(mask_logits),
                                    self.temperature)
        return a, x * mask, adj_logits


class SensAdv(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.lin1 = _dense(in_dim, hidden, gen)
        self.lin2 = _dense(hidden, 1, gen)

    def forward(self, h):
        return self.lin2(torch.relu(self.lin1(h)))[:, 0]


class Classifier(nn.Module):
    def __init__(self, in_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = _dense(in_dim, 1,
                          generator or torch.Generator().manual_seed(0))

    def forward(self, h):
        return self.lin(h)[:, 0]


class Projection(nn.Module):
    """elu MLP head; flax ``Dense_0`` is the outer (second) layer."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        self.lin_in = _dense(in_dim, hidden, gen)
        self.lin_out = _dense(hidden, out, gen)

    def forward(self, z):
        return self.lin_out(F.elu(self.lin_in(z)))


def _simclr_loss(feats: torch.Tensor, temperature: float = 0.07):
    """SimCLR InfoNCE over 2N stacked views."""
    n2 = feats.shape[0]
    n = n2 // 2
    f = feats / torch.clamp(
        torch.sqrt(torch.sum(feats * feats, -1, keepdim=True) + 1e-12),
        min=1e-12)
    sim = f @ f.T / temperature
    eye = torch.eye(n2, dtype=torch.bool, device=feats.device)
    ar = torch.arange(n, device=feats.device)
    pos_idx = torch.cat([ar + n, ar])
    pos = sim[torch.arange(n2, device=feats.device), pos_idx]
    denom = torch.sum(torch.where(eye, 0.0, torch.exp(sim)), dim=1)
    return -torch.mean(pos - torch.log(torch.clamp(denom, min=1e-12)))



class OptaxAdamW:
    """optax ``adamw(lr, b1, b2, eps, weight_decay)`` over a list of
    parameters with one step count: ``u = -lr (m^/(sqrt(v^) + eps) + wd
    p)``, m^ and v^ bias-corrected at the shared count. ``step(apply)``
    updates every moment from the parameters' ``.grad`` (None: zero) and
    applies the update to the parameters whose ``apply`` entry is True
    (all when None)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        b1, b2, eps)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, apply: Optional[Sequence[bool]] = None) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for i, p in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[i].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[i].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            if apply is not None and not apply[i]:
                continue
            upd = (self.m[i] / c1) / (torch.sqrt(self.v[i] / c2) + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))


class Graphair:
    """The training loop and its steps. Entry points run on ``device``
    (default: the card)."""

    def __init__(self, feat_dim: int, num_hidden: int = 64,
                 num_proj_hidden: int = 64, alpha: float = 20.0,
                 beta: float = 0.9, gamma: float = 0.7, lam: float = 1.0,
                 lr: float = 1e-4, weight_decay: float = 1e-5,
                 temperature: float = 1.0, device: DeviceLike = None):
        self.alpha, self.beta, self.gamma, self.lam = alpha, beta, gamma, lam
        self.feat_dim, self.num_hidden = feat_dim, num_hidden
        self.num_proj_hidden, self.temperature = num_proj_hidden, temperature
        self.lr = lr
        self.wd = weight_decay
        self.device = resolve_device(device)
        self.params = None
        self.init(0)

    def init(self, seed: int) -> None:
        """Draw every weight from ``seed`` (Glorot-uniform kernels, zero
        biases): the augmenter, encoder, adversary and projection, in that
        order, from one ``torch.Generator``."""
        gen = torch.Generator().manual_seed(seed)
        H = self.num_hidden
        self.aug = AugModule(self.feat_dim, H, self.temperature, gen)
        self.enc = GCNBody(self.feat_dim, H, H, nlayer=2, generator=gen)
        self.adv = SensAdv(H, H, gen)
        self.proj = Projection(H, self.num_proj_hidden, H, gen)
        for m in (self.aug, self.enc, self.adv, self.proj):
            m.to(self.device)

    @staticmethod
    def draw(gen: torch.Generator, n: int, feat_dim: int) -> Noise:
        """One step's uniforms in [1e-6, 1 - 1e-6): the edges' ``[n, n]``
        and the feature mask's ``[n, feat_dim]``, on ``gen``'s device."""
        lo, hi = 1e-6, 1 - 1e-6
        u = lambda *s: lo + (hi - lo) * torch.rand(
            s, generator=gen, device=gen.device)
        return u(n, n), u(n, feat_dim)

    # -- the step functions of fit_whole, on the data set by prepare --

    def prepare(self, adj, x, sens, idx_sens) -> None:
        """Move the graph to the device and set the optimisers' state to
        optax's initial one."""
        dev = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.adj, self.x, self.sens = t(adj), t(x), t(sens)
        n = self.x.shape[0]
        self.sens_mask = torch.zeros(n, dtype=torch.bool, device=dev)
        self.sens_mask[torch.as_tensor(np.asarray(idx_sens), device=dev)
                       .long()] = True
        self.adj_norm = normalize_adj(self.adj)
        e = torch.sum(self.adj)
        self.pos_weight = (n * n - e) / torch.clamp(e, min=1)
        self.norm_w = n * n / (2 * torch.clamp(n * n - e, min=1))
        self.main_params = [*self.aug.parameters(), *self.enc.parameters(),
                            *self.proj.parameters()]
        self.n_aug = len(list(self.aug.parameters()))
        self.opt_main = OptaxAdamW(self.main_params, self.lr, self.wd)
        self.opt_adv = OptaxAdamW(list(self.adv.parameters()), 1e-4, 1e-5)

    def _recons_loss(self, noise: Noise):
        a_new, x_new, adj_logits = self.aug(self.adj_norm, self.x, noise,
                                            adj_orig=self.adj)
        w = torch.where(self.adj > 0, self.pos_weight, 1.0)
        edge_loss = self.norm_w * torch.mean(
            w * sigmoid_bce(adj_logits, self.adj))
        feat_loss = torch.mean((x_new - self.x) ** 2)
        return edge_loss + self.lam * feat_loss, (a_new, x_new)

    def _sens_loss(self, h_prime):
        ls = sigmoid_bce(self.adv(h_prime), self.sens)
        return (torch.sum(torch.where(self.sens_mask, ls, 0.0))
                / torch.clamp(torch.sum(self.sens_mask), min=1))

    def warm_step(self, noise: Noise) -> torch.Tensor:
        """A reconstruction step of the augmenter; ``enc`` and ``proj``
        take zero gradients into the shared optimiser and keep their
        weights."""
        self.opt_main.zero_grad()
        loss, _ = self._recons_loss(noise)
        loss.backward(inputs=list(self.aug.parameters()))
        self.opt_main.step([i < self.n_aug
                            for i in range(len(self.main_params))])
        return loss.detach()

    def adv_step(self, noise: Noise) -> torch.Tensor:
        """A step of the adversary on the augmented graph's encoding."""
        with torch.no_grad():
            a_new, x_new, _ = self.aug(self.adj_norm, self.x, noise,
                                       adj_orig=self.adj)
            h_prime = self.enc(a_new, x_new)
        self.opt_adv.zero_grad()
        loss = self._sens_loss(h_prime)
        loss.backward()
        self.opt_adv.step()
        return loss.detach()

    def main_step(self, noise: Noise):
        """``beta * contrastive + gamma * reconstruction - alpha *
        adversary`` minimised over ``{aug, enc, proj}``; returns ``(loss,
        (closs, recons, sloss))``."""
        self.opt_main.zero_grad()
        rl, (a_new, x_new) = self._recons_loss(noise)
        h = self.enc(self.adj_norm, self.x)
        h_prime = self.enc(a_new, x_new)
        zs = torch.cat([self.proj(h), self.proj(h_prime)], 0)
        closs = _simclr_loss(zs)
        sloss = self._sens_loss(h_prime)
        total = self.beta * closs + self.gamma * rl - self.alpha * sloss
        total.backward(inputs=self.main_params)
        self.opt_main.step()
        return total.detach(), (closs.detach(), rl.detach(), sloss.detach())

    def fit_whole(self, epochs: int, adj: np.ndarray, x: np.ndarray,
                  sens: np.ndarray, idx_sens: np.ndarray,
                  warmup: int = 0, adv_epoches: int = 1, seed: int = 0,
                  verbose: bool = False):
        """Train as the JAX ``fit_whole``: ``warmup`` reconstruction steps,
        then per epoch ``adv_epoches`` adversary steps (ten times that at
        epoch 0) and one main step. Weights are drawn from ``seed``; the
        noise comes from a generator on the device seeded with ``seed``.
        Returns the four modules by name."""
        self.init(seed)
        self.prepare(adj, x, sens, idx_sens)
        n, f = self.x.shape
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for _ in range(warmup):
            self.warm_step(self.draw(gen, n, f))
        for ep in range(epochs):
            for _ in range(adv_epoches * (10 if ep == 0 else 1)):
                self.adv_step(self.draw(gen, n, f))
            loss, aux = self.main_step(self.draw(gen, n, f))
            if verbose and ep % max(epochs // 5, 1) == 0:
                closs, rl, sloss = (float(a) for a in aux)
                print(f"epoch {ep}: total {float(loss):.4f} "
                      f"cont {closs:.4f} recons {rl:.4f} sens {sloss:.4f}")
        self.params = {"aug": self.aug, "enc": self.enc, "adv": self.adv,
                       "proj": self.proj}
        return self.params

    @torch.no_grad()
    def embed(self) -> np.ndarray:
        return self.enc(self.adj_norm, self.x).cpu().numpy()

    def test(self, y: np.ndarray, sens: np.ndarray, idx_train, idx_test,
             epochs: int = 500, lr: float = 1e-2) -> Dict[str, float]:
        """Linear classifier on frozen embeddings (Adam, optax's); accuracy
        / DP / EO. The classifier's weights are drawn from seed 0, where
        the JAX package draws them from ``PRNGKey(0)``."""
        dev = self.device
        h = self.embed()
        clf = Classifier(h.shape[1]).to(dev)
        opt = torch.optim.Adam(clf.parameters(), lr=lr)
        y = np.asarray(y).astype(np.float32)
        htr = torch.as_tensor(h[idx_train], device=dev)
        ytr = torch.as_tensor(y[idx_train], device=dev)
        for _ in range(epochs):
            opt.zero_grad()
            torch.mean(sigmoid_bce(clf(htr), ytr)).backward()
            opt.step()
        with torch.no_grad():
            logits = clf(torch.as_tensor(h[idx_test], device=dev))
        pred = logits.cpu().numpy() > 0
        yt = y[idx_test] > 0.5
        st_ = np.asarray(sens)[idx_test] > 0.5
        acc = float(np.mean(pred == yt))
        dp = abs(pred[~st_].mean() - pred[st_].mean()) \
            if st_.any() and (~st_).any() else 0.0
        eo = 0.0
        if (yt & st_).any() and (yt & ~st_).any():
            eo = abs(pred[yt & ~st_].mean() - pred[yt & st_].mean())
        return {"accuracy": acc, "dp": float(dp * 100),
                "eo": float(eo * 100)}
