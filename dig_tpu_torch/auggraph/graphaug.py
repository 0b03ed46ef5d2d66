"""GraphAug: learned label-invariant augmentation. Port of
``dig_tpu/auggraph/graphaug.py``.

Parity with ``dig/auggraph/method/GraphAug/{aug/augmenter.py:15-97,
model/gmnet.py,runner_reward_gen.py,runner_generator.py:15-171,
runner_aug_cls.py}``:

* ``Augmenter`` — per step, an encoder summarizes the graph and a policy
  head picks an augmentation category (NodeDrop / NodeFM / EdgePer) and a
  per-element keep/drop Bernoulli (straight-through), applied as mask
  transforms on the GraphBatch. Its noise is drawn apart
  (``Augmenter.draw``) and given to ``forward``, as the ssl views do.
* ``RewardGMNet`` — graph matching network scoring whether an augmented
  graph preserved the original's label (trained on same/different-label
  pairs).
* Runners — one class for each of the three training phases.

The GIN encoders sum through the sorted-CSR segment sum
(``ssl.encoders``), their pooling is ``readout_sum``, and the edge
features' row gathers are ``gather_rows``; the cross attention is a dense
product.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..datasets.graphs import GraphClsLoader
from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..ops.segment import gather_rows, readout_sum
from ..ssl.encoders import GINConv, edge_plan, init_weights

AUG_TYPES = ("node_drop", "node_fm", "edge_per")


def _bernoulli_st(u, probs):
    hard = (u < probs).to(torch.float32)
    return probs + (hard - probs).detach()


def _detached(module: nn.Module, params=None):
    """``module``'s parameters (or ``params``), detached: the weights of a
    model that a step uses but does not train."""
    src = params if params is not None else dict(module.named_parameters())
    return {k: v.detach() for k, v in src.items()}


def _masked_mean(ls, m):
    return torch.sum(torch.where(m, ls, 0.0)) / torch.clamp(torch.sum(m),
                                                            min=1)


class _GIN(nn.Module):
    def __init__(self, feat_dim: int, hidden: int = 64, layers: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            GINConv(feat_dim if i == 0 else hidden, hidden)
            for i in range(layers))

    def forward(self, g: GraphBatch, x=None):
        plan = edge_plan(g)
        x = g.nodes["x"] if x is None else x
        for conv in self.convs:
            x = torch.relu(conv(x, g, plan=plan))
            x = torch.where(g.node_mask[:, None], x, 0.0)
        zg = readout_sum(x, g.node_graph, g.num_graphs, g.node_mask)
        return zg, x


class _Cls(nn.Module):
    """GIN + linear classifier (the runners' and SMixup's ``Cls``)."""

    def __init__(self, feat_dim: int, hidden: int, num_classes: int):
        super().__init__()
        self.gin = _GIN(feat_dim, hidden)
        self.out = nn.Linear(hidden, num_classes)

    def forward(self, g, x=None):
        return self.out(self.gin(g, x)[0])


def _made(module: nn.Module, seed_or_gen, device: DeviceLike) -> nn.Module:
    gen = (seed_or_gen if isinstance(seed_or_gen, torch.Generator)
           else torch.Generator().manual_seed(int(seed_or_gen)))
    init_weights(module, gen)
    return module.to(resolve_device(device))


def _accuracy(model, dataset, batch_size, dev):
    correct = total = 0
    with torch.no_grad():
        for g in GraphClsLoader(dataset, batch_size):
            g = g.to(dev)
            pred = torch.argmax(model(g), -1)
            y = g.globals["y"].reshape(-1).long()
            correct = correct + torch.sum((pred == y) & g.graph_mask)
            total = total + torch.sum(g.graph_mask)
    return int(correct) / max(int(total), 1)


class Augmenter(nn.Module):
    """Sequential augmentation policy (augmenter.py:15-97). ``feat_dim`` is
    the node feature width (flax infers it); weights from ``generator``
    (None: seed 0), on ``device`` (None: the card)."""

    def __init__(self, feat_dim: int, hidden: int = 64, max_steps: int = 2,
                 magnitude: float = 0.15,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.max_steps, self.magnitude = max_steps, magnitude
        self.gins = nn.ModuleList(_GIN(feat_dim, hidden)
                                  for _ in range(max_steps))
        self.cat = nn.ModuleList(nn.Linear(hidden, len(AUG_TYPES))
                                 for _ in range(max_steps))
        self.node = nn.ModuleList(nn.Linear(hidden, 1)
                                  for _ in range(max_steps))
        self.edge = nn.ModuleList(nn.Linear(hidden, 1)
                                  for _ in range(max_steps))
        _made(self, generator or 0, device)

    def draw(self, gen: torch.Generator, g: GraphBatch) -> List[Dict]:
        """Each step's noise: ``u_cat [G, 3]`` uniform in (1e-6, 1 - 1e-6)
        (the Gumbel draw), ``u_node [N]``, ``u_edge [E]`` uniform, ``z``
        standard normal of the features' shape."""
        d = gen.device
        out = []
        for _ in range(self.max_steps):
            u = torch.rand((g.num_graphs, len(AUG_TYPES)), generator=gen,
                           device=d)
            out.append({
                "u_cat": 1e-6 + u * (1 - 2e-6),
                "u_node": torch.rand((g.num_nodes,), generator=gen, device=d),
                "u_edge": torch.rand((g.num_edges,), generator=gen, device=d),
                "z": torch.randn(tuple(g.nodes["x"].shape), generator=gen,
                                 device=d)})
        return out

    def forward(self, g: GraphBatch, noise: List[Dict]):
        """Returns (augmented batch, log-prob of the taken actions)."""
        dev = g.node_mask.device
        logp_total = 0.0
        for s in range(self.max_steps):
            n = {k: v.to(dev) for k, v in noise[s].items()}
            snd, rcv = g.senders.long(), g.receivers.long()
            zg, zn = self.gins[s](g)
            cat_logits = self.cat[s](zg)
            cat_probs = torch.softmax(cat_logits, -1)          # [G, 3]
            # per-node / per-edge keep probabilities from the policy
            node_keep_p = torch.sigmoid(self.node[s](zn))[:, 0]
            node_keep_p = 1.0 - self.magnitude * (1 - node_keep_p)
            edge_feat = gather_rows(zn, snd) + gather_rows(zn, rcv)
            edge_keep_p = torch.sigmoid(self.edge[s](edge_feat))[:, 0]
            edge_keep_p = 1.0 - self.magnitude * (1 - edge_keep_p)
            # straight-through choice of category per graph
            gumbel = -torch.log(-torch.log(n["u_cat"]))
            cat = torch.argmax(cat_logits + gumbel, dim=-1)    # [G]
            ng = g.node_graph.long()
            cat_n = cat[ng]
            cat_e = cat[ng[snd]]
            keep_n = _bernoulli_st(n["u_node"], node_keep_p)
            keep_e = _bernoulli_st(n["u_edge"], edge_keep_p)
            # apply selected transform per graph
            node_mask = g.node_mask & ((cat_n != 0) | (keep_n > 0.5))
            edge_ok = (keep_e > 0.5) | (cat_e != 2)
            edge_mask = (g.edge_mask & edge_ok & node_mask[snd]
                         & node_mask[rcv])
            fm_sel = (cat_n == 1) & (keep_n < 0.5) & g.node_mask
            x = torch.where(fm_sel[:, None], n["z"] * 0.5, g.nodes["x"])
            g = g.replace(nodes={**g.nodes, "x": x}, node_mask=node_mask,
                          edge_mask=edge_mask)
            logp_total = logp_total + torch.mean(torch.log(
                torch.gather(cat_probs, 1, cat[:, None])[:, 0] + 1e-12))
        return g, logp_total


class RewardGMNet(nn.Module):
    """Graph matching reward model (gmnet/genet): siamese GIN + cross-graph
    attention -> match probability. ``feat_dim``, ``generator`` and
    ``device`` as :class:`Augmenter`'s."""

    def __init__(self, feat_dim: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        self.enc = _GIN(feat_dim, hidden)
        self.lin1 = nn.Linear(4 * hidden, hidden)
        self.lin2 = nn.Linear(hidden, 1)
        _made(self, generator or 0, device)

    def forward(self, g1: GraphBatch, g2: GraphBatch):
        zg1, zn1 = self.enc(g1)
        zg2, zn2 = self.enc(g2)
        # cross attention between node sets of paired graphs
        sim = zn1 @ zn2.T                                   # [N1, N2]
        pair = g1.node_graph[:, None] == g2.node_graph[None, :]
        pair = pair & g1.node_mask[:, None] & g2.node_mask[None, :]
        att12 = torch.softmax(torch.where(pair, sim, -1e30), dim=1)
        att12 = torch.where(pair, att12, 0.0)
        match1 = att12 @ zn2                                # [N1, h]
        cross1 = readout_sum(zn1 * match1, g1.node_graph, g1.num_graphs,
                             g1.node_mask)
        feats = torch.cat([zg1, zg2, torch.abs(zg1 - zg2), cross1], -1)
        return self.lin2(torch.relu(self.lin1(feats)))[:, 0]


def reward_loss(model: RewardGMNet, g1, g2, y):
    """Sigmoid cross-entropy of the match logits over the real pairs."""
    ls = F.binary_cross_entropy_with_logits(model(g1, g2), y,
                                            reduction="none")
    return _masked_mean(ls, g1.graph_mask)


def generator_loss(augmenter: Augmenter, reward_model: RewardGMNet,
                   reward_params, g, noise):
    """The augmenter's loss: minus the mean reward of the augmented batch
    (``reward_model`` at ``reward_params``, not trained), plus a REINFORCE
    term on the category log-prob."""
    g_aug, logp = augmenter(g, noise)
    score = functional_call(reward_model,
                            _detached(reward_model, reward_params),
                            (g, g_aug))
    r = _masked_mean(torch.sigmoid(score), g.graph_mask)
    # maximize reward; ST paths carry gradients, plus a REINFORCE term on
    # the category log-prob
    return -(r + r.detach() * logp)


def classifier_loss(model, g_aug, y, graph_mask):
    ls = F.cross_entropy(model(g_aug), y.reshape(-1).long(),
                         reduction="none")
    return _masked_mean(ls, graph_mask)


class RunnerRewardGen:
    """Train the reward model on same-label vs different-label pairs
    (runner_reward_gen.py)."""

    def __init__(self, hidden: int = 64):
        self.hidden = hidden
        self.model = None
        self.params = None

    def train(self, dataset: Sequence[Dict], batch_size: int = 16,
              epochs: int = 5, lr: float = 1e-3, seed: int = 0,
              verbose: bool = False, device: DeviceLike = None):
        """Returns the trained weights (a state dict); the model is
        ``self.model``. Pairs are drawn on the host from
        ``np.random.default_rng(seed)`` as in the JAX runner, the weights
        from a generator seeded with ``seed``."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        by_label: Dict[int, List[int]] = {}
        for i, g in enumerate(dataset):
            by_label.setdefault(int(g["y"]), []).append(i)
        labels = list(by_label)

        def sample_pairs(n):
            g1s, g2s, ys = [], [], []
            for _ in range(n):
                same = rng.random() < 0.5
                la = labels[rng.integers(len(labels))]
                i = rng.choice(by_label[la])
                if same or len(labels) == 1:
                    j = rng.choice(by_label[la])
                    ys.append(1.0)
                else:
                    lb = labels[rng.integers(len(labels))]
                    while lb == la and len(labels) > 1:
                        lb = labels[rng.integers(len(labels))]
                    j = rng.choice(by_label[lb])
                    ys.append(float(lb == la))
                g1s.append(dataset[i])
                g2s.append(dataset[j])
            return (next(iter(GraphClsLoader(g1s, n))).to(dev),
                    next(iter(GraphClsLoader(g2s, n))).to(dev),
                    torch.tensor(ys, dtype=torch.float32, device=dev))

        sample_pairs(batch_size)       # the JAX runner's init batch
        model = RewardGMNet(dataset[0]["x"].shape[1], self.hidden,
                            torch.Generator().manual_seed(seed), dev)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        for ep in range(epochs):
            losses = []
            for _ in range(max(len(dataset) // batch_size, 1)):
                g1, g2, y = sample_pairs(batch_size)
                opt.zero_grad(set_to_none=True)
                loss = reward_loss(model, g1, g2, y)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            if verbose:
                print(f"reward-gen epoch {ep}: "
                      f"{float(torch.stack(losses).mean()):.4f}")
        self.model = model
        self.params = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}
        return self.params


class RunnerGenerator:
    """Train the augmenter to maximize reward-model label-invariance
    (runner_generator.py:15-171)."""

    def __init__(self, hidden: int = 64, max_steps: int = 2,
                 magnitude: float = 0.15):
        self.hidden, self.max_steps, self.magnitude = (hidden, max_steps,
                                                       magnitude)
        self.augmenter = None
        self.params = None

    def train(self, dataset: Sequence[Dict], reward_model: RewardGMNet,
              reward_params, batch_size: int = 16, epochs: int = 5,
              lr: float = 1e-3, seed: int = 0, verbose: bool = False,
              device: DeviceLike = None):
        """Returns the trained augmenter's weights (a state dict); the
        module is ``self.augmenter``. ``reward_params``: the reward model's
        state dict (None: its current weights); it is not trained. An epoch
        reads nothing on the host (``verbose`` reads its mean loss)."""
        dev = resolve_device(device)
        loader = GraphClsLoader(dataset, batch_size, shuffle=True, seed=seed)
        aug = Augmenter(dataset[0]["x"].shape[1], self.hidden,
                        self.max_steps, self.magnitude,
                        torch.Generator().manual_seed(seed), dev)
        reward_model.to(dev)
        rp = (None if reward_params is None
              else {k: v.to(dev) for k, v in reward_params.items()})
        opt = torch.optim.Adam(aug.parameters(), lr=lr)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for ep in range(epochs):
            losses = []
            for g in [b.to(dev) for b in loader]:
                opt.zero_grad(set_to_none=True)
                loss = generator_loss(aug, reward_model, rp, g,
                                      aug.draw(gen, g))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            if verbose:
                print(f"generator epoch {ep}: "
                      f"{float(torch.stack(losses).mean()):.4f}")
        self.augmenter = aug
        self.params = {k: v.detach().clone()
                       for k, v in aug.state_dict().items()}
        return self.params


class RunnerAugCls:
    """Train a classifier with learned augmentations
    (runner_aug_cls.py)."""

    def __init__(self, num_classes: int, hidden: int = 64):
        self.hidden = hidden
        self.num_classes = num_classes
        self.model = None
        self.params = None

    def train(self, dataset: Sequence[Dict], augmenter: Augmenter,
              aug_params, batch_size: int = 16, epochs: int = 10,
              lr: float = 1e-3, seed: int = 0, verbose: bool = False,
              device: DeviceLike = None):
        """Trains ``self.model`` (GIN + linear) on batches augmented by
        ``augmenter`` at ``aug_params`` (a state dict; None: its current
        weights; no gradient reaches it); returns the accuracy on
        ``dataset``, read once at the end."""
        dev = resolve_device(device)
        model = _Cls(dataset[0]["x"].shape[1], self.hidden,
                     self.num_classes)
        _made(model, seed, dev)
        loader = GraphClsLoader(dataset, batch_size, shuffle=True, seed=seed)
        augmenter.to(dev)
        ap = _detached(augmenter, None if aug_params is None else
                       {k: v.to(dev) for k, v in aug_params.items()})
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for ep in range(epochs):
            losses = []
            for g in [b.to(dev) for b in loader]:
                with torch.no_grad():
                    g_aug, _ = functional_call(augmenter, ap,
                                               (g, augmenter.draw(gen, g)))
                opt.zero_grad(set_to_none=True)
                loss = classifier_loss(model, g_aug, g.globals["y"],
                                       g.graph_mask)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            if verbose:
                print(f"aug-cls epoch {ep}: "
                      f"{float(torch.stack(losses).mean()):.4f}")
        self.model = model
        self.params = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}
        return _accuracy(model, dataset, batch_size, dev)
