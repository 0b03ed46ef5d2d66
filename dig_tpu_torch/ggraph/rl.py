"""PPO fine-tuning for the molecular flow generators (port of
``dig_tpu.ggraph.rl``).

Replicates the reference's RL fine-tune semantics
(``dig/ggraph/method/GraphDF/model/graphflow_rl.py:166-608`` for
property optimization, ``graphflow_con_rl.py:382-1100`` for constrained
optimization; the GraphAF variants share the recipe):

* Rollouts are generated by a frozen *old-policy* snapshot with
  exploration temperatures (node logits * T_node, edge logits / T_edge),
  valency-checked bond resampling, and a -1 per-step penalty for invalid
  bond attempts (``penalty``).
* The final molecular reward ``R = reward_valid + reward_property`` with
  reward_valid = 2 minus filter penalties (steric strain, ZINC
  functional groups) and reward_property per ``reward_type``: ``exp``
  (exp(score/exp_temperature) - exp_bias), ``linear``
  (linear_coeff * score) or ``imp`` (score - seed score, constrained
  task).
* Per-step shaped reward ``R * reward_decay^(T - 1 - t)`` where t is the
  trajectory step counter at record time; invalid-bond records keep
  their -1.
* Baseline: per-step-index batch average, blended with the running
  baseline by ``moving_coeff`` (disabled by ``no_baseline``); advantage
  = shaped reward - baseline[step].
* The update is the PPO clipped surrogate on the action log-likelihoods
  (ratio vs the old policy, log-ratio clamped to +-10, eps = 0.2),
  normalized by the total action dimensionality, with grad-norm clip 1.0
  and linear learning-rate warm-up; the old policy refreshes every
  ``update_iters`` iterations.

Rollouts are generation's lockstep loop (``methods.lockstep_generate``)
around the flow's reverse steps on the device, with a recorder of the
trajectories; the records are collated at their true counts (the JAX
package pads them to static caps for jit and truncates what overflows)
and the PPO loss and update run on the device. The optimiser is optax's chain written out: the gradients
clipped to global norm 1.0 as optax clips them (no epsilon), Adam(W), and
the warm-up schedule (linear from 0 to 1 over ``warm_up`` updates, so the
first update is zero) as a factor on the learning rate. Batch norm runs
on running statistics throughout (the reference puts BN in eval mode for
RL)."""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chem import Mol
from .environment import (calculate_min_plogp, check_chemical_validity,
                          qed_score, steric_strain_filter,
                          zinc_molecule_filter)
from .methods import (CategoricalLatents, GaussianLatents, ReverseSteps,
                      _adam, lockstep_generate)
from .models.graphdf import base_logits


@dataclass
class RLConfig:
    """Mirror of the reference ``rl_conf_dict``
    (examples/ggraph/GraphDF/config/prop_opt_*.json)."""

    property_type: str = "plogp"          # 'plogp' | 'qed'
    reward_type: str = "linear"           # 'exp' | 'linear' | 'imp'
    reward_decay: float = 0.9
    exp_temperature: float = 3.0
    exp_bias: float = 4.0
    linear_coeff: float = 2.0
    penalty: bool = True
    update_iters: int = 4
    moving_coeff: float = 0.99
    no_baseline: bool = False
    batch_size: int = 8
    temperature: Tuple[float, float] = (0.8, 0.1)
    atom_list: Sequence[int] = (6, 7, 8, 9)
    max_size_rl: Optional[int] = None
    clip_eps: float = 0.2
    warm_up: int = 0
    modify_size: int = 3                  # constrained task: max atoms cut
    min_action_node: int = 1


class _Traj:
    """Per-trajectory record lists (node and edge actions with canvases)."""

    def __init__(self):
        self.nx, self.nadj, self.nact, self.nstep, self.nrew = \
            [], [], [], [], []
        self.ex, self.eadj, self.eact, self.eei, self.ecnt, self.estep, \
            self.erew = [], [], [], [], [], [], []

    def add_node(self, x, adj, act, node_step, step_cnt):
        self.nx.append(x.copy())
        self.nadj.append(adj.copy())
        self.nact.append(act)
        self.nstep.append(node_step)
        self.nrew.append(float(step_cnt))          # >0: shaped later

    def add_edge(self, x, adj, act, ei, edge_cnt, step_cnt, reward=None):
        self.ex.append(x.copy())
        self.eadj.append(adj.copy())
        self.eact.append(act)
        self.eei.append(ei)
        self.ecnt.append(edge_cnt)
        self.estep.append(step_cnt)
        self.erew.append(float(step_cnt) if reward is None else reward)

    def pop_node(self):
        for lst in (self.nx, self.nadj, self.nact, self.nstep, self.nrew):
            lst.pop()

    def pop_edges(self, k):
        for _ in range(k):
            for lst in (self.ex, self.eadj, self.eact, self.eei, self.ecnt,
                        self.estep, self.erew):
                lst.pop()


def _shape_rewards(traj: _Traj, R: float, decay: float, T: int):
    """In-place: positive placeholders (= step counters) become
    R * decay^(T-1-t); explicit penalties (-1) stay."""
    def shape(rews):
        out = []
        for r in rews:
            out.append(R * decay ** (T - 1.0 - r) if r > 0 else r)
        return out
    traj.nrew = shape(traj.nrew)
    traj.erew = shape(traj.erew)


class _Rollouts:
    """The PPO rollouts' recorder for ``methods.lockstep_generate``: per
    lane a ``_Traj`` of node and edge records with their canvases, the
    trajectory step counter, and the records of the atom being grown,
    dropped with it when it connects to nothing. A rejected bond leaves a
    -1 penalty record when ``penalty`` is on."""

    def __init__(self, B: int, penalty: bool, node_dim: int, bond_dim: int):
        self.trajs = [_Traj() for _ in range(B)]
        self.step_cnt = np.ones(B, np.int64)
        self.edges = np.zeros(B, np.int64)
        self.penalty = penalty
        self.node_dim, self.bond_dim = node_dim, bond_dim

    def node(self, b, i, x, adj, fid):
        act = np.zeros(self.node_dim, np.float32)
        act[fid] = 1.0
        self.trajs[b].add_node(x, adj, act, i, self.step_cnt[b])
        self.edges[b] = 0

    def edge(self, b, x, adj, eid, ei, edge_idx, valid):
        if not valid and not self.penalty:
            return
        act = np.zeros(self.bond_dim, np.float32)
        act[eid] = 1.0
        self.trajs[b].add_edge(x, adj, act, np.asarray(ei, np.int32),
                               edge_idx, self.step_cnt[b],
                               reward=None if valid else -1.0)
        self.edges[b] += 1

    def end_node(self, b, connected):
        if connected:
            self.step_cnt[b] += 1
        else:
            self.trajs[b].pop_node()
            self.trajs[b].pop_edges(int(self.edges[b]))


def _stack(arrs, shape, dtype=np.float32):
    """The records as one array [len(arrs), *shape] (empty: zero rows)."""
    return np.asarray(arrs, dtype).reshape((len(arrs),) + shape)


class PPOFineTuner:
    """Shared PPO fine-tuner for GraphDF / GraphAF prop-opt and const-opt.
    Trains ``model`` in place; ``old_model`` is the frozen old policy,
    refreshed every ``update_iters`` iterations."""

    def __init__(self, model, cfg: RLConfig, lr: float = 1e-4,
                 wd: float = 0.0):
        self.model = model
        self.cfg = cfg
        self.lr = lr
        self.opt = _adam(model.parameters(), lr, wd)
        self.updates = 0                  # the warm-up schedule's count
        self.old_model = copy.deepcopy(model).eval()
        self.moving_baseline = None

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    # -- the update -------------------------------------------------------

    def _schedule(self) -> float:
        """optax ``linear_schedule(0, 1, max(warm_up, 1))`` at this
        update's count; 1 without warm-up."""
        w = self.cfg.warm_up
        if not w:
            return 1.0
        T = max(w, 1)
        return (0.0 - 1.0) * (1.0 - min(self.updates, T) / T) + 1.0

    def update(self, batch: Dict[str, np.ndarray]) -> float:
        """One PPO update from a collated batch (``_collate``): the old
        policy's log-likelihoods, the clipped surrogate on the current
        one, the gradients clipped to global norm 1.0 (optax's
        ``clip_by_global_norm``), then Adam(W) at the scheduled rate.
        Returns the loss."""
        dev = next(self.model.parameters()).device
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            nll_old, ell_old = rl_lls(self.old_model, b)
        params = [p for p in self.model.parameters()]
        self.opt.zero_grad(set_to_none=True)
        loss = ppo_loss(self.model, b, nll_old, ell_old, self.cfg.clip_eps)
        loss.backward()
        clip_global_norm_([p.grad for p in params if p.grad is not None],
                          1.0)
        scale = self._schedule()
        for group in self.opt.param_groups:
            group["lr"] = self.lr * scale
        self.opt.step()
        self.updates += 1
        return float(loss.detach())

    # -- rewards ----------------------------------------------------------

    def _final_reward(self, mol, seed_score: Optional[float] = None):
        cfg = self.cfg
        reward_valid = 2.0
        reward_property = 0.0
        score = None
        if mol is None or mol.num_atoms == 0 or \
                not check_chemical_validity(mol):
            reward_valid -= 5.0
        else:
            if not steric_strain_filter(mol):
                reward_valid -= 1.0
            if not zinc_molecule_filter(mol):
                reward_valid -= 1.0
            prop_fn = (calculate_min_plogp if cfg.property_type == "plogp"
                       else qed_score)
            try:
                score = float(prop_fn(mol))
                if cfg.reward_type == "exp":
                    reward_property = (np.exp(score / cfg.exp_temperature)
                                       - cfg.exp_bias)
                elif cfg.reward_type == "linear":
                    reward_property = score * cfg.linear_coeff
                elif cfg.reward_type == "imp":
                    reward_property = score - float(seed_score or 0.0)
            except Exception:
                pass
        return reward_valid + reward_property, reward_property, score

    # -- one PPO iteration ------------------------------------------------

    def collect(self, cur_iter: int, rng, seeds: Optional[List] = None):
        """The rollouts of one iteration and their collated batch (numpy).
        ``seeds``: list of (x, adj, mol, keep_size, edge_idx, seed_score)
        canvases for the constrained task; None for plain property
        optimization. Returns (batch, rewards, scores, metas)."""
        cfg = self.cfg
        model = self.model
        if cur_iter % cfg.update_iters == 0:
            self.old_model.load_state_dict(self.model.state_dict())
        logits = base_logits(self.old_model)
        N, U = model.max_size, model.edge_unroll
        node_dim, bond_dim = model.node_dim, model.bond_dim

        B = cfg.batch_size
        seed_canvases = None
        seed_scores = [None] * B
        if seeds is not None:
            seed_canvases = []
            for b in range(B):
                x0, adj0, mol0, keep, _eidx0, seed_scores[b] = \
                    seeds[b % len(seeds)]
                seed_canvases.append(
                    (x0.copy(), adj0.copy(), mol0.copy(), keep))
        tnode, tedge = cfg.temperature
        latents = (GaussianLatents(node_dim, bond_dim, tnode, tedge,
                                   per_lane=True) if logits is None else
                   CategoricalLatents(*logits, tnode, tedge,
                                      divide_edge=True))
        steps = ReverseSteps(self.old_model)
        rec = _Rollouts(B, cfg.penalty, node_dim, bond_dim)
        mols, _ = lockstep_generate(
            steps.node, steps.edge, latents, rng, B, N, U, node_dim, bond_dim,
            list(cfg.atom_list), seed_canvases, rec)
        trajs, Ts = rec.trajs, rec.step_cnt
        rewards, scores, metas = [], [], []
        max_step = 0
        for b in range(B):
            R, rp, score = self._final_reward(mols[b], seed_scores[b])
            _shape_rewards(trajs[b], R, cfg.reward_decay, int(Ts[b]))
            rewards.append(R)
            scores.append(rp)
            metas.append((mols[b], score, seed_scores[b]))
            max_step = max(max_step, int(Ts[b]))

        # per-step-index baseline over the batch: the baseline index is the
        # trajectory step counter recorded at collection time (kept in
        # estep for edge records; node records are 1, 2, ... in order)
        counts = np.zeros(max_step + 6)
        sums = np.zeros(max_step + 6)
        nb_idx, eb_idx = [], []
        for traj in trajs:
            n_idx = [min(t, max_step + 5) for t in
                     self._node_step_counters(traj)]
            e_idx = [min(t, max_step + 5) for t in traj.estep]
            nb_idx.append(n_idx)
            eb_idx.append(e_idx)
            for t, r in zip(n_idx, traj.nrew):
                counts[t] += 1.0
                sums[t] += r
            for t, r in zip(e_idx, traj.erew):
                counts[t] += 1.0
                sums[t] += r
        baseline = sums / np.maximum(counts, 1.0)
        if self.moving_baseline is None or \
                len(self.moving_baseline) != len(baseline):
            self.moving_baseline = baseline
        else:
            mc = cfg.moving_coeff
            self.moving_baseline = (1 - mc) * baseline + \
                mc * self.moving_baseline
        base = (np.zeros_like(self.moving_baseline) if cfg.no_baseline
                else self.moving_baseline)
        batch = self._collate(trajs, nb_idx, eb_idx, base, node_dim,
                              bond_dim, N)
        return batch, rewards, scores, metas

    def step(self, cur_iter: int, rng, seeds: Optional[List] = None):
        """One collect+update iteration. Returns (mean_reward,
        mean_property_score, loss, metas) where metas carries per-molecule
        (mol, score, seed_score)."""
        batch, rewards, scores, metas = self.collect(cur_iter, rng, seeds)
        loss = self.update(batch)
        return (float(np.mean(rewards)), float(np.mean(scores)), loss,
                metas)

    @staticmethod
    def _node_step_counters(traj: _Traj):
        # node records were appended once per grown atom, in order; the
        # trajectory step counter at record time is 1, 2, ...
        return list(range(1, len(traj.nx) + 1))

    def _collate(self, trajs, nb_idx, eb_idx, baseline, node_dim, bond_dim,
                 N):
        nx, nadj, nact, nstep, nrew, nbase = [], [], [], [], [], []
        ex, eadj, eact, eei, ecnt, erew, ebase = [], [], [], [], [], [], []
        for traj, nidx, eidx in zip(trajs, nb_idx, eb_idx):
            nx += traj.nx
            nadj += traj.nadj
            nact += traj.nact
            nstep += traj.nstep
            nrew += traj.nrew
            nbase += [baseline[t] for t in nidx]
            ex += traj.ex
            eadj += traj.eadj
            eact += traj.eact
            eei += traj.eei
            ecnt += traj.ecnt
            erew += traj.erew
            ebase += [baseline[t] for t in eidx]
        nadv = np.asarray(nrew) - np.asarray(nbase)
        eadv = np.asarray(erew) - np.asarray(ebase)
        return {"nx": _stack(nx, (N, node_dim)),
                "nadj": _stack(nadj, (bond_dim, N, N)),
                "nact": _stack(nact, (node_dim,)),
                "nstep": _stack(nstep, (), np.int32),
                "nadv": _stack(nadv, ()),
                "ex": _stack(ex, (N, node_dim)),
                "eadj": _stack(eadj, (bond_dim, N, N)),
                "eact": _stack(eact, (bond_dim,)),
                "eei": _stack(eei, (2,), np.int32),
                "ecnt": _stack(ecnt, (), np.int32),
                "eadv": _stack(eadv, ())}


def rl_lls(model, b):
    """The node and edge action log-likelihoods of a collated batch."""
    ll_n = model.rl_node_ll(b["nx"], b["nadj"], b["nact"], b["nstep"])
    ll_e = model.rl_edge_ll(b["ex"], b["eadj"], b["eact"], b["eei"],
                            b["ecnt"])
    return ll_n, ll_e


def ppo_loss(model, b, nll_old, ell_old, eps: float):
    """The clipped surrogate, normalized by the total action
    dimensionality (the JAX ``ppo_step``'s ``loss_fn``)."""
    ll_n, ll_e = rl_lls(model, b)
    ratio_n = torch.exp((ll_n - nll_old).clamp(-10.0, 10.0))
    ratio_e = torch.exp((ll_e - ell_old).clamp(-10.0, 10.0))
    adv_n, adv_e = b["nadv"], b["eadv"]
    surr_n = torch.minimum(ratio_n * adv_n,
                           ratio_n.clamp(1 - eps, 1 + eps) * adv_n)
    surr_e = torch.minimum(ratio_e * adv_e,
                           ratio_e.clamp(1 - eps, 1 + eps) * adv_e)
    total_len = b["nact"].numel() + b["eact"].numel()
    s = surr_n.sum() + surr_e.sum()
    return -(s / max(total_len, 1) - 1.0)


@torch.no_grad()
def clip_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: g / ||g|| * max_norm where the
    global norm reaches max_norm (``clip_grad_norm_`` divides by
    norm + 1e-6 instead)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_seed_canvas(mol: Mol, keep_size: int, atom_list, N, U, node_dim,
                     bond_dim, prop_fn=calculate_min_plogp):
    """Constrained-opt seed: the generation canvas of the first
    ``keep_size`` atoms of a dataset molecule in BFS order (reference
    graphflow_con_rl.py:47-140 keeps a subgraph and regrows the rest).

    Returns the 6-tuple the tuner's ``seeds`` argument expects:
    (x, adj, sub_mol, keep_size, edge_idx, seed_score)."""
    from ..chem.mol import bfs_order

    perm = bfs_order(mol)
    keep = list(perm)[:keep_size]
    remap = {old: k for k, old in enumerate(keep)}
    x = np.zeros((1, N, node_dim), np.float32)
    adj = np.zeros((1, bond_dim, N, N), np.float32)
    sub = Mol()
    atom_list = list(atom_list)
    zmap = {int(z): i for i, z in enumerate(atom_list)}
    for k, old in enumerate(keep):
        z = mol.atoms[old].z
        fid = zmap.get(int(z), 0)
        x[0, k, fid] = 1.0
        adj[0, :, k, k] = 1.0          # generation-canvas self-loops
        sub.add_atom(int(z))
    for (a, b), order in mol.bonds.items():
        if a in remap and b in remap:
            i, j = remap[a], remap[b]
            sub.add_bond(i, j, float(order))
            eid = min(int(order) - 1, bond_dim - 2)
            adj[0, eid, i, j] = 1.0
            adj[0, eid, j, i] = 1.0
    edge_idx = sum(min(i, U) for i in range(keep_size))
    seed_score = float(prop_fn(mol))
    return (x, adj, sub, keep_size, edge_idx, seed_score)
