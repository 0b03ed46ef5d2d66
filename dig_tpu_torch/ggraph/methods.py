"""Generation methods: GraphDF, GraphAF, GraphEBM (port of
``dig_tpu.ggraph.methods``).

Parity with ``dig/ggraph/method/{GraphDF/graphdf.py,GraphAF/graphaf.py,
GraphEBM/graphebm.py}``: the Generator contract (train_rand_gen /
run_rand_gen / train_prop_opt / run_prop_opt / train_const_prop_opt /
run_const_prop_opt).

Training is dense-tensor work on the device; the autoregressive
generation loop lives on the host: each node/edge reverse-flow step runs
on the device over the ``[B, N, d]`` canvases of the whole lockstep batch
and returns its output to the host, where the valency-feedback resampling
runs between steps (the weights stay on the device). The host draws
(``rng.choice`` / ``rng.normal`` on ``np.random.default_rng(seed)``) are
the JAX package's, call for call, so both packages consume the same
stream.

Deviations from the JAX package:
* checkpoints are ``torch.save`` state dicts (``rand_gen_ckpt_<epoch>.pt``)
  where the JAX package pickles its variables; ``dig_tpu_torch.convert``
  carries JAX weights across;
* the JAX ``jax.random`` draws (GraphAF's dequantization, GraphEBM's data
  noise and Langevin draws) come from a ``torch.Generator`` seeded with
  ``seed`` on the CPU, through the models' ``draw`` functions, and the
  step functions take the drawn noise.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chem import Mol, check_valency
from ..device import DeviceLike, resolve_device
from .environment import (check_chemical_validity,
                          reward_target_molecule_similarity)
from .generator import Generator
from .models.graphaf import GraphFlowModelAF
from .models.graphdf import GraphFlowModelDF, base_logits
from .models.graphebm import (EnergyFunc, draw_langevin, langevin_sample,
                              rescale_adj)


def _np_softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _adam(params, lr: float, wd: float = 0.0):
    """optax ``adamw(lr, weight_decay=wd)`` if wd else ``adam(lr)``."""
    if wd:
        return torch.optim.AdamW(params, lr, weight_decay=wd)
    return torch.optim.Adam(params, lr)


def _mean_loss(losses: List[torch.Tensor]) -> float:
    """The epoch's mean loss, read once (the JAX method reads each step's
    loss as a float and averages them in float64)."""
    return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))


def flow_train_step(model, opt):
    """One NLL step of a flow model: its batch norm runs on batch
    statistics and updates its running ones (``train()`` mode); returns
    the loss, detached. ``step(x, adj, *noise)``."""
    def step(x, adj, *noise):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, adj, *noise)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


class ReverseSteps:
    """A flow's reverse steps on its device: host canvases in, host
    outputs out (``node(x, adj, latent)``, ``edge(x, adj, latent, ei)``)."""

    def __init__(self, model):
        self.model = model
        self.dev = _device_of(model)

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    @torch.no_grad()
    def node(self, x, adj, latent):
        return self.model.reverse_node(self._t(x), self._t(adj),
                                       self._t(latent)).cpu().numpy()

    @torch.no_grad()
    def edge(self, x, adj, latent, ei):
        return self.model.reverse_edge(self._t(x), self._t(adj),
                                       self._t(latent),
                                       self._t(ei)).cpu().numpy()


class CategoricalLatents:
    """GraphDF's latents: one-hot draws (``rng.choice``) from the
    categorical base logits times the temperatures (``divide_edge``: the
    edge logits divided by theirs, as the PPO rollouts explore). A
    rejected bond type is masked out of its lane's edge logits before the
    next draw; the decode is the output's argmax."""

    def __init__(self, node_logits, edge_logits, t_node: float,
                 t_edge: float, divide_edge: bool = False):
        self.node_logits, self.edge_logits = node_logits, edge_logits
        self.t_node, self.t_edge = t_node, t_edge
        self.divide_edge = divide_edge

    def node(self, rng, i, B):
        p = _np_softmax(self.node_logits[i] * self.t_node)
        latent = np.zeros((B, len(p)), np.float32)
        latent[np.arange(B), rng.choice(len(p), size=B, p=p)] = 1.0
        return latent

    def new_edge(self, edge_idx, B):
        self.dis = np.tile(self.edge_logits[edge_idx], (B, 1))
        self.lid = np.zeros(B, np.int64)

    def edge(self, rng, draw):
        latent = np.zeros(self.dis.shape, np.float32)
        for b in np.flatnonzero(draw):
            # generation MULTIPLIES the base logits by the temperature
            # (reference graphflow.py:100-105)
            pe = _np_softmax(self.dis[b] / self.t_edge if self.divide_edge
                             else self.dis[b] * self.t_edge)
            self.lid[b] = rng.choice(len(pe), p=pe)
            latent[b, self.lid[b]] = 1.0
        return latent

    def decode(self, b, out, invalid):
        return int(np.argmax(out))

    def reject(self, b):
        self.dis[b, self.lid[b]] = -np.inf


class GaussianLatents:
    """GraphAF's latents: normals times the temperatures; the decode masks
    the lane's rejected bond types out of the output before its argmax.
    Generation draws every lane's edge latent in one call; ``per_lane``
    draws only for the lanes still choosing, one call each (the PPO
    rollouts' stream)."""

    def __init__(self, node_dim: int, bond_dim: int, t_node: float,
                 t_edge: float, per_lane: bool = False):
        self.node_dim, self.bond_dim = node_dim, bond_dim
        self.t_node, self.t_edge = t_node, t_edge
        self.per_lane = per_lane

    def node(self, rng, i, B):
        return rng.normal(0, self.t_node,
                          (B, self.node_dim)).astype(np.float32)

    def new_edge(self, edge_idx, B):
        pass

    def edge(self, rng, draw):
        if not self.per_lane:
            return rng.normal(0, self.t_edge,
                              (len(draw), self.bond_dim)).astype(np.float32)
        latent = np.zeros((len(draw), self.bond_dim), np.float32)
        for b in np.flatnonzero(draw):
            latent[b] = rng.normal(0, self.t_edge, self.bond_dim)
        return latent

    def decode(self, b, out, invalid):
        row = out.copy()
        for bad in invalid:
            row[bad] = -np.inf
        return int(np.argmax(row))

    def reject(self, b):
        pass


def lockstep_generate(rev_node, rev_edge, latents, rng, B, N, U, node_dim,
                      bond_dim, atom_list, seed_canvases=None, record=None):
    """Lockstep batched sampling (reference graphflow.py:58-229, minus the
    'demon edit' random-growth patch applied on disconnect): the flow's
    reverse steps run once per atom index and once per (i, j,
    resample-round) for ALL ``B`` lanes; the valency check, the
    backtracking and the resampling stay per lane on the host (chem
    kernel). A lane gives up on a bond (no bond) once every bond type is
    rejected (the reference's 3 distinct types, at its bond_dim 4) or
    after 50 resamples, and stops growing when a new atom connects to
    nothing (the atom is dropped).

    ``latents``: ``CategoricalLatents`` or ``GaussianLatents`` (the draws
    and the decode). ``seed_canvases``: per-lane (x[1,N,nd], adj[1,bd,N,N],
    mol, keep_size) to grow from (the constrained task), None for empty
    canvases. ``record``: the PPO rollouts' trajectory recorder, or None.
    Returns (mols, per-lane count of resamples)."""
    x = np.zeros((B, N, node_dim), np.float32)
    adj = np.zeros((B, bond_dim, N, N), np.float32)
    mols = [Mol() for _ in range(B)]
    start_atoms = np.zeros(B, np.int64)
    for b, (x0, adj0, mol0, keep) in enumerate(seed_canvases or ()):
        x[b], adj[b], mols[b], start_atoms[b] = x0[0], adj0[0], mol0, keep
    backup = [m.copy() for m in mols]
    total_resample = np.zeros(B, np.int64)
    alive = np.ones(B, bool)
    edge_idx = 0  # global (i, j) pointer: sum(min(t, U) for t < i) + j
    for i in range(N):
        if not alive.any():
            break
        # a seeded lane joins at its first free atom; its edge pointer
        # stays aligned because make_seed_canvas follows the same formula
        active = alive & (start_atoms <= i)
        if active.any():
            fid = np.argmax(rev_node(x, adj, latents.node(rng, i, B)), axis=1)
            for b in np.flatnonzero(active):
                if record is not None:
                    record.node(b, i, x[b], adj[b], fid[b])
                x[b, i, fid[b]] = 1.0
                adj[b, :, i, i] = 1.0
                mols[b].add_atom(atom_list[fid[b]])
        is_connect = active & (i == 0)
        start = max(i - U, 0)
        for j in range(min(i, U)):
            if active.any():
                latents.new_edge(edge_idx, B)
                resolved = ~active
                invalid = [set() for _ in range(B)]
                resample = np.zeros(B, np.int64)
                a = j + start
                ei = np.broadcast_to(np.asarray([[a, i]], np.int64), (B, 2))
                while not resolved.all():
                    give_up = np.array([len(invalid[b]) >= bond_dim - 1
                                        or resample[b] > 50
                                        for b in range(B)])
                    out = rev_edge(x, adj,
                                   latents.edge(rng, ~resolved & ~give_up),
                                   ei)
                    for b in np.flatnonzero(~resolved):
                        e = (bond_dim - 1 if give_up[b]
                             else latents.decode(b, out[b], invalid[b]))
                        adj[b, e, i, a] = adj[b, e, a, i] = 1.0
                        valid = True
                        if e != bond_dim - 1:
                            mols[b].add_bond(i, a, float(e + 1))
                            valid = check_valency(mols[b])
                            if not valid:      # backtrack and resample
                                mols[b].remove_bond(i, a)
                                adj[b, e, i, a] = adj[b, e, a, i] = 0.0
                        if record is not None:
                            record.edge(b, x[b], adj[b], e, (a, i),
                                        edge_idx, valid)
                        if valid:
                            is_connect[b] |= e != bond_dim - 1
                            resolved[b] = True
                        else:
                            latents.reject(b)
                            invalid[b].add(e)
                            resample[b] += 1
                            total_resample[b] += 1
            edge_idx += 1
        for b in np.flatnonzero(active):
            if record is not None:
                record.end_node(b, is_connect[b])
            if is_connect[b]:
                backup[b] = mols[b].copy()
            else:
                mols[b] = backup[b]
                alive[b] = False
    return mols, total_resample


def _batch_to(batch, dev):
    return (torch.from_numpy(batch["x"]).to(dev),
            torch.from_numpy(batch["adj"]).to(dev))


class GraphDF(Generator):
    """Discrete-flow generator (reference GraphDF/graphdf.py:10-392)."""

    model_class = GraphFlowModelDF

    def __init__(self):
        self.model: Optional[torch.nn.Module] = None
        self.params = None
        self.conf = None

    def get_model(self, task, config: Dict, ckpt=None,
                  device: DeviceLike = None, seed: int = 0):
        """Build the model on ``device`` (initial weights drawn from
        ``seed``); ``ckpt`` a state dict or a checkpoint path."""
        self.conf = config
        kw = dict(max_size=config["max_size"],
                  edge_unroll=config["edge_unroll"],
                  node_dim=config["node_dim"], bond_dim=config["bond_dim"],
                  num_flow_layer=config.get("num_flow_layer", 12),
                  num_rgcn_layer=config.get("num_rgcn_layer", 3),
                  nhid=config.get("nhid", 128), nout=config.get("nout", 128))
        if self.model_class is GraphFlowModelAF:
            kw["deq_coeff"] = config.get("deq_coeff", 0.9)
        self.model = self.model_class(
            generator=torch.Generator().manual_seed(seed), **kw).to(
            resolve_device(device))
        self.params = None
        if ckpt is not None:
            if isinstance(ckpt, (str, os.PathLike)):
                ckpt = torch.load(ckpt, map_location=_device_of(self.model))
            self.model.load_state_dict(ckpt)
            self.params = self.model.state_dict()

    # -- training ---------------------------------------------------------
    def train_rand_gen(self, loader, lr: float, wd: float, max_epochs: int,
                       model_conf_dict: Dict, save_interval: int = 1,
                       save_dir: Optional[str] = None, verbose: bool = True,
                       seed: int = 0, device: DeviceLike = None):
        """NLL training (optax ``adam`` / ``adamw``) from the weights
        ``get_model`` draws from ``seed``."""
        next(iter(loader))     # the JAX method's init batch: it advances a
        # shuffling loader's epoch, so both packages see the same orders
        self.get_model("rand_gen", model_conf_dict, device=device, seed=seed)
        model = self.model
        dev = _device_of(model)
        opt = _adam(model.parameters(), lr, wd)
        step = flow_train_step(model, opt)
        gen = torch.Generator().manual_seed(seed)
        gauss = isinstance(model, GraphFlowModelAF)
        history = []
        for epoch in range(max_epochs):
            losses = []
            for batch in loader:
                x, adj = _batch_to(batch, dev)
                noise = (model.draw(gen, x),) if gauss else ()
                losses.append(step(x, adj, *noise))
            avg = _mean_loss(losses)
            history.append(avg)
            if verbose:
                print(f"Epoch {epoch + 1} | loss {avg:.5f}")
            if save_dir and (epoch + 1) % save_interval == 0:
                self._save(save_dir, epoch + 1)
        model.eval()
        self.params = model.state_dict()
        return history

    def _save(self, save_dir, epoch):
        os.makedirs(save_dir, exist_ok=True)
        torch.save(self.model.state_dict(),
                   os.path.join(save_dir, f"rand_gen_ckpt_{epoch}.pt"))

    def load_ckpt(self, path: str, model_conf_dict: Optional[Dict] = None,
                  device: DeviceLike = None):
        """Restore a ``_save`` checkpoint; pass the model config when the
        model was not yet built."""
        if model_conf_dict is not None:
            self.get_model("rand_gen", model_conf_dict, path, device)
        else:
            self.model.load_state_dict(
                torch.load(path, map_location=_device_of(self.model)))
            self.params = self.model.state_dict()
        return self.params

    def _ready(self, model_conf_dict, checkpoint_path, device):
        if model_conf_dict is not None and self.model is None:
            self.get_model("rand_gen", model_conf_dict, checkpoint_path,
                           device)
        assert self.params is not None, "train or load a checkpoint first"
        self.model.eval()
        return self.model

    # -- generation -------------------------------------------------------
    def run_rand_gen(self, model_conf_dict: Optional[Dict] = None,
                     checkpoint_path=None, n_mols: int = 100,
                     atomic_num_list: Sequence[int] = (6, 7, 8, 9),
                     temperature: Sequence[float] = (0.3, 0.3),
                     min_atoms: int = 2, seed: int = 0,
                     device: DeviceLike = None
                     ) -> Tuple[List[Mol], List[int]]:
        """Sample molecules via reverse flow + valency-checked bond
        resampling (reference graphflow.py:58-229, minus the 'demon edit'
        random-growth patch applied on disconnect), in lockstep batches of
        up to 64."""
        model = self._ready(model_conf_dict, checkpoint_path, device)
        steps = ReverseSteps(model)
        if not isinstance(temperature, (tuple, list)):
            temperature = (temperature, temperature)
        latents = self._latents(model, tuple(temperature))
        rng = np.random.default_rng(seed)
        mols, pure_valids = [], []
        B = min(64, n_mols)
        done = 0
        while done < n_mols:
            b = min(B, n_mols - done)
            ms, resampled = lockstep_generate(
                steps.node, steps.edge, latents, rng, b, model.max_size,
                model.edge_unroll, model.node_dim, model.bond_dim,
                list(atomic_num_list))
            mols.extend(ms)
            pure_valids.extend(1 if r == 0 else 0 for r in resampled)
            done += b
        return mols, pure_valids

    def _latents(self, model, temperature):
        return CategoricalLatents(*base_logits(model), *temperature)

    # -- property optimization (PPO fine-tune) ----------------------------
    def train_prop_opt(self, prop: str = "plogp",
                       model_conf_dict: Optional[Dict] = None,
                       init_params=None, n_iters: int = 10,
                       batch_size: int = 8, lr: float = 1e-4,
                       wd: float = 0.0,
                       atomic_num_list: Sequence[int] = (6, 7, 8, 9),
                       temperature=(0.8, 0.1), rl_conf: Optional[Dict] = None,
                       seed: int = 0, verbose: bool = False,
                       device: DeviceLike = None):
        """PPO fine-tune of the pretrained flow toward a property score
        (reference graphflow_rl.py:166-608: old-policy rollouts with
        exploration temperature and valency penalties, decayed reward
        shaping, per-step moving baseline, clipped surrogate)."""
        from .rl import PPOFineTuner, RLConfig
        if model_conf_dict is not None and self.model is None:
            self.get_model("prop_opt", model_conf_dict, init_params, device)
        assert self.params is not None
        if not isinstance(temperature, (tuple, list)):
            temperature = (temperature, temperature)
        cfg = RLConfig(property_type=prop, batch_size=batch_size,
                       temperature=tuple(temperature),
                       atom_list=tuple(atomic_num_list),
                       **(rl_conf or {}))
        tuner = PPOFineTuner(self.model, cfg, lr=lr, wd=wd)
        rng = np.random.default_rng(seed)
        history = []
        for it in range(n_iters):
            reward, score, loss, _ = tuner.step(it, rng)
            history.append({"iter": it, "reward": reward, "score": score,
                            "loss": loss})
            if verbose:
                print(f"iter {it}: reward {reward:.3f} score {score:.3f} "
                      f"loss {loss:.4f}")
        self.params = self.model.state_dict()
        self.rl_history = history
        return self.params

    def run_prop_opt(self, n_mols: int = 100, prop: str = "plogp",
                     **kwargs):
        mols, _ = self.run_rand_gen(n_mols=n_mols, **kwargs)
        return mols

    # -- constrained property optimization --------------------------------
    def run_const_prop_opt(self, seed_mols: Sequence[Mol],
                           atomic_num_list: Sequence[int] = (6, 7, 8, 9),
                           temperature=(0.8, 0.8), n_extra_atoms: int = 3,
                           seed: int = 0) -> List[Mol]:
        """Modify seed molecules by continuing autoregressive generation
        from their BFS prefix (the reference's const-opt RL modifies seeds
        under a similarity constraint, ``graphflow_con_rl.py``)."""
        from ..chem import mol_to_dense
        from ..chem.mol import bfs_order
        model = self._ready(None, None, None)
        steps = ReverseSteps(model)
        N, U = model.max_size, model.edge_unroll
        node_dim, bond_dim = model.node_dim, model.bond_dim
        node_logits, edge_logits = base_logits(model)
        rng = np.random.default_rng(seed)
        out = []
        for seed_mol in seed_mols:
            mol = seed_mol.copy()
            k0 = mol.num_atoms
            if k0 >= N:
                out.append(mol)
                continue
            x_, adj_ = mol_to_dense(mol, list(atomic_num_list), N,
                                    bfs_order(mol))
            x = x_[None]
            adj = adj_[None]
            for slot in range(k0, N):
                adj[0, :, slot, slot] = 1.0
            edge_idx = sum(min(i, U) for i in range(k0))
            for i in range(k0, min(k0 + n_extra_atoms, N)):
                p = _np_softmax(node_logits[i] * temperature[0])
                fid = rng.choice(node_dim, p=p)
                x[0, i, fid] = 1.0
                mol.add_atom(list(atomic_num_list)[fid])
                start = max(i - U, 0)
                connected = False
                for j in range(i if i < U else U):
                    pe = _np_softmax(edge_logits[edge_idx]
                                     * temperature[1])
                    latent = np.zeros((1, bond_dim), np.float32)
                    lid = rng.choice(bond_dim, p=pe)
                    latent[0, lid] = 1.0
                    o = steps.edge(x, adj, latent,
                                   np.asarray([[j + start, i]], np.int64))
                    eid = int(np.argmax(o[0]))
                    if eid < bond_dim - 1:
                        mol.add_bond(i, j + start, float(eid + 1))
                        if check_valency(mol):
                            adj[0, eid, i, j + start] = 1.0
                            adj[0, eid, j + start, i] = 1.0
                            connected = True
                        else:
                            mol.remove_bond(i, j + start)
                    edge_idx += 1
                if not connected:
                    # drop the dangling atom
                    mol.atoms.pop()
                    x[0, i] = 0.0
                    break
            out.append(mol)
        return out

    def train_const_prop_opt(self, seed_mols: Sequence[Mol],
                             n_iters: int = 5, batch_size: int = 8,
                             lr: float = 1e-4, sim_threshold: float = 0.4,
                             atomic_num_list: Sequence[int] = (6, 7, 8, 9),
                             temperature=(0.8, 0.1),
                             rl_conf: Optional[Dict] = None, seed: int = 0,
                             verbose: bool = False):
        """Constrained PPO fine-tune: keep a BFS subgraph of each seed
        molecule, regrow the rest, reward = plogp improvement when the
        result stays similar enough (reference graphflow_con_rl.py:
        reward_type 'imp', random modify_size cut per rollout). Tracks the
        best (improvement, similarity) per seed in ``self.const_results``."""
        from .rl import PPOFineTuner, RLConfig, make_seed_canvas
        assert self.params is not None
        model = self.model
        cfg = RLConfig(property_type="plogp", reward_type="imp",
                       batch_size=batch_size,
                       temperature=tuple(temperature),
                       atom_list=tuple(atomic_num_list),
                       **(rl_conf or {}))
        tuner = PPOFineTuner(model, cfg, lr=lr)
        rng = np.random.default_rng(seed)
        best = {i: (0.0, None) for i in range(len(seed_mols))}
        for it in range(n_iters):
            seeds = []
            for sm in seed_mols:
                cut = int(rng.integers(0, cfg.modify_size + 1))
                keep = max(sm.num_atoms - cut, 1)
                seeds.append(make_seed_canvas(
                    sm, keep, cfg.atom_list, model.max_size,
                    model.edge_unroll, model.node_dim, model.bond_dim))
            reward, score, loss, metas = tuner.step(it, rng, seeds=seeds)
            for b, (mol, sc, seed_sc) in enumerate(metas):
                i = b % len(seed_mols)
                if mol is None or sc is None or \
                        not check_chemical_validity(mol):
                    continue
                sim = reward_target_molecule_similarity(mol, seed_mols[i])
                imp = sc - (seed_sc or 0.0)
                if sim >= sim_threshold and imp > best[i][0]:
                    best[i] = (imp, mol)
            if verbose:
                print(f"const-opt iter {it}: reward {reward:.3f} "
                      f"loss {loss:.4f}")
        self.params = self.model.state_dict()
        self.const_results = best
        return self.params


class GraphAF(GraphDF):
    """Continuous-flow generator (reference GraphAF/graphaf.py:10-395).
    Shares GraphDF's training and generation; swaps the flow model and latent sampling
    (Gaussian latents, argmax decode). Each training step draws its
    dequantization uniforms from a ``torch.Generator`` seeded with
    ``seed``."""

    model_class = GraphFlowModelAF

    def run_rand_gen(self, model_conf_dict: Optional[Dict] = None,
                     checkpoint_path=None, n_mols: int = 100,
                     atomic_num_list: Sequence[int] = (6, 7, 8, 9),
                     temperature=0.75, min_atoms: int = 2, seed: int = 0,
                     device: DeviceLike = None):
        return super().run_rand_gen(model_conf_dict, checkpoint_path, n_mols,
                                    atomic_num_list, temperature, min_atoms,
                                    seed, device)

    def _latents(self, model, temperature):
        return GaussianLatents(model.node_dim, model.bond_dim, *temperature)


class GraphEBM(Generator):
    """Energy-based generator (reference GraphEBM/graphebm.py:19-).
    Contrastive-divergence training + Langevin sampling, with
    goal-directed and compositional variants. The noise of a step comes
    from ``draw`` (a ``torch.Generator`` seeded with ``seed``) and goes
    into ``loss_of``."""

    def __init__(self, n_atom_type: int, hidden: int = 64, depth: int = 2,
                 max_size: int = 9, atom_list: Sequence[int] = (6, 7, 8, 9)):
        self.hidden, self.depth = hidden, depth
        self.model = EnergyFunc(n_atom_type, hidden=hidden, depth=depth)
        self.params = None
        self.n_atom_type = n_atom_type
        self.max_size = max_size
        self.atom_list = list(atom_list)

    @staticmethod
    def draw(gen: torch.Generator, shape_x, shape_adj, ld_step: int,
             device: DeviceLike = None):
        """One training step's noise: the data uniforms (x, adj) and the
        Langevin run's draws."""
        gd = gen.device
        dev = gd if device is None else torch.device(device)
        u_x = torch.rand(tuple(shape_x), generator=gen, device=gd).to(dev)
        u_adj = torch.rand(tuple(shape_adj), generator=gen, device=gd).to(dev)
        return u_x, u_adj, draw_langevin(gen, shape_x, shape_adj, ld_step,
                                         dev)

    def loss_of(self, x, adj, noise, c: float = 0.0, ld_noise: float = 0.005,
                ld_step_size: float = 30.0, clamp: bool = True,
                alpha: float = 1.0):
        """One contrastive-divergence loss: positives are the data plus
        c * uniform noise, negatives a Langevin run from ``noise``."""
        model = self.model
        u_x, u_adj, ld = noise
        pos_x = x + c * u_x
        pos_adj = rescale_adj(adj + c * u_adj)
        neg_x, neg_adj = langevin_sample(
            model, ld, ld_noise=ld_noise, ld_step_size=ld_step_size,
            clamp=0.01 if clamp else 1e9, c=c)
        pos = model(pos_adj, pos_x)
        neg = model(neg_adj, neg_x)
        loss_en = pos.mean() - neg.mean()
        loss_reg = (pos ** 2).mean() + (neg ** 2).mean()
        return loss_en + alpha * loss_reg

    def train_rand_gen(self, loader, lr: float = 1e-4, wd: float = 0.0,
                       max_epochs: int = 10, c: float = 0.0,
                       ld_step: int = 30, ld_noise: float = 0.005,
                       ld_step_size: float = 30.0, clamp: bool = True,
                       alpha: float = 1.0, save_interval: int = 1,
                       save_dir: Optional[str] = None,
                       verbose: bool = True, seed: int = 0,
                       device: DeviceLike = None):
        next(iter(loader))     # the JAX method's init batch
        dev = resolve_device(device)
        self.model = EnergyFunc(
            self.n_atom_type, hidden=self.hidden, depth=self.depth,
            generator=torch.Generator().manual_seed(seed)).to(dev)
        model = self.model
        # optax.adam(lr, b1=0.0, b2=0.999)
        opt = torch.optim.Adam(model.parameters(), lr, betas=(0.0, 0.999))
        gen = torch.Generator().manual_seed(seed)
        history = []
        for epoch in range(max_epochs):
            losses = []
            for batch in loader:
                x, adj = _batch_to(batch, dev)
                noise = self.draw(gen, x.shape, adj.shape, ld_step, dev)
                opt.zero_grad(set_to_none=True)
                loss = self.loss_of(x, adj, noise, c, ld_noise, ld_step_size,
                                    clamp, alpha)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            avg = _mean_loss(losses)
            history.append(avg)
            if verbose:
                print(f"Epoch {epoch + 1} | loss {avg:.5f}")
        self.params = model.state_dict()
        return history

    def _sample(self, energy, n_mols, c, ld_step, ld_noise, ld_step_size,
                seed, batch_size, dev):
        gen = torch.Generator().manual_seed(seed)
        mols = []
        remaining = n_mols
        while remaining > 0:
            b = min(batch_size, remaining)
            noise = draw_langevin(
                gen, (b, self.max_size, self.n_atom_type),
                (b, 4, self.max_size, self.max_size), ld_step, dev)
            neg_x, neg_adj = langevin_sample(
                energy, noise, ld_noise=ld_noise, ld_step_size=ld_step_size,
                c=c)
            xs, adjs = neg_x.cpu().numpy(), neg_adj.cpu().numpy()
            for k in range(b):
                mols.append(self._decode(xs[k], adjs[k]))
            remaining -= b
        return mols

    def run_rand_gen(self, n_mols: int = 100, c: float = 0.0,
                     ld_step: int = 150, ld_noise: float = 0.005,
                     ld_step_size: float = 30.0, seed: int = 0,
                     batch_size: int = 100) -> List[Mol]:
        assert self.params is not None
        return self._sample(self.model, n_mols, c, ld_step, ld_noise,
                            ld_step_size, seed, batch_size,
                            _device_of(self.model))

    def _decode(self, x, adj) -> Mol:
        """Dense continuous tensors -> Mol: argmax per node/pair, drop
        no-edge channel, keep valency-feasible bonds greedily (the
        reference decodes via its one-shot tensor->mol path,
        ``gen_mol_from_one_shot_tensor.py:12-133``)."""
        n = x.shape[0]
        mol = Mol()
        active = []
        for i in range(n):
            if x[i].max() > 0.5:
                active.append(i)
                mol.add_atom(self.atom_list[int(np.argmax(x[i]))])
        idx = {v: k for k, v in enumerate(active)}
        pairs = []
        for a in range(n):
            for b in range(a + 1, n):
                ch = int(np.argmax(adj[:, a, b]))
                score = adj[ch, a, b]
                if ch < 3 and a in idx and b in idx:
                    pairs.append((score, a, b, ch))
        for score, a, b, ch in sorted(pairs, reverse=True):
            if score < 0.5:
                continue
            mol.add_bond(idx[a], idx[b], float(ch + 1))
            if not check_valency(mol):
                mol.remove_bond(idx[a], idx[b])
        return mol

    def train_goal_directed(self, loader, prop: str = "plogp", **kwargs):
        """Goal-directed variant (reference graphebm.py goal-directed
        training); trains as ``train_rand_gen``, as the JAX package does."""
        return self.train_rand_gen(loader, **kwargs)

    def run_goal_directed(self, prop_fn=None, n_mols: int = 100,
                          guidance: float = 0.02, **kwargs) -> List[Mol]:
        """Goal-directed sampling; samples as ``run_rand_gen``, as the JAX
        package does."""
        return self.run_rand_gen(n_mols=n_mols, **kwargs)

    def run_compositional(self, other: "GraphEBM", n_mols: int = 100,
                          c: float = 0.0, ld_step: int = 150,
                          ld_noise: float = 0.005,
                          ld_step_size: float = 30.0, seed: int = 0,
                          batch_size: int = 100) -> List[Mol]:
        """Compositional generation: sample from the SUM of two trained
        energies (reference graphebm.py two-energy composition)."""
        assert self.params is not None and other.params is not None
        m1, m2 = self.model, other.model

        def energy(adj, x):
            return m1(adj, x) + m2(adj, x)

        return self._sample(energy, n_mols, c, ld_step, ld_noise,
                            ld_step_size, seed, batch_size, _device_of(m1))
