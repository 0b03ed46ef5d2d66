"""JTVAE — junction-tree variational autoencoder for molecules (port of
``dig_tpu.ggraph.jtvae``).

Parity with ``dig/ggraph/method/JTVAE/`` (``jtvae.py:20-293``,
``fast_jtnn/{chemutils.py,jtnn_enc.py,jtnn_dec.py,mpn.py,jtnn_vae.py}``):

* tree decomposition, the fragment vocabulary, the teacher-forcing DFS
  trace, batching and greedy assembly are host code, copied (``batch_trees``
  returns CPU tensors);
* encoders — GRU message passing over the junction tree (jtnn_enc.py) and
  an atom-level MPN over the molecular graph (mpn.py), both padded and
  masked, with flax's GRU parametrization (``models.layers.GRUCell``);
* VAE — mean/logvar heads on [tree ; graph] embeddings, KL-annealed ELBO;
  the reparameterisation normals are drawn apart (``JTVAEModel.draw``)
  and passed in, so a test can feed the JAX side's draws;
* decoder — topological expand/backtrack prediction + fragment-label
  prediction, teacher-forced at training time (jtnn_dec.py);
* the property head's latent ascent is a plain loop of
  ``torch.autograd.grad`` (the JAX package scans it).

All chemistry runs on the chem kernel (RDKit-free).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..chem import Mol, canonical_hash, check_valency, mol_from_smiles
from ..chem.descriptors import _ring_info
from ..device import DeviceLike, resolve_device
from .generator import Generator
from .models.layers import GRUCell, default_generator, embedding, linear


# ---------------------------------------------------------------------------
# tree decomposition (chemutils.py:tree_decomp)
# ---------------------------------------------------------------------------

@dataclass
class MolTree:
    mol: Mol
    cliques: List[List[int]]          # atom ids per tree node
    edges: List[Tuple[int, int]]      # tree edges (clique idx pairs)
    labels: List[str]                 # canonical fragment hash per node


def _fragment(mol: Mol, atoms: Sequence[int]) -> Mol:
    idx = {a: i for i, a in enumerate(atoms)}
    frag = Mol()
    for a in atoms:
        at = mol.atoms[a]
        frag.add_atom(at.z, at.charge)
    for (a, b), o in mol.bonds.items():
        if a in idx and b in idx:
            frag.add_bond(idx[a], idx[b], o)
    return frag


def tree_decomp(mol: Mol) -> MolTree:
    """Cliques = rings + non-ring bonds (+ singleton atoms at junctions of
    >= 3 cliques), spanning tree over clique-overlap graph."""
    n = mol.num_atoms
    rings = [sorted(c) for c in _ring_info(mol)]
    ring_atoms = set(a for r in rings for a in r)
    cliques: List[List[int]] = [list(r) for r in rings]
    for (a, b), o in sorted(mol.bonds.items()):
        in_ring = any(a in r and b in r for r in rings)
        if not in_ring:
            cliques.append([a, b])
    if not cliques and n:
        cliques = [[0]]
    # merge rings sharing >= 3 atoms (bridged systems, chemutils.py)
    merged = True
    while merged:
        merged = False
        for i in range(len(cliques)):
            for j in range(i + 1, len(cliques)):
                if (len(cliques[i]) > 2 and len(cliques[j]) > 2 and
                        len(set(cliques[i]) & set(cliques[j])) >= 3):
                    cliques[i] = sorted(set(cliques[i]) | set(cliques[j]))
                    cliques.pop(j)
                    merged = True
                    break
            if merged:
                break
    # spanning tree: connect cliques sharing atoms (max-overlap first)
    K = len(cliques)
    cand = []
    for i in range(K):
        for j in range(i + 1, K):
            ov = len(set(cliques[i]) & set(cliques[j]))
            if ov > 0:
                cand.append((-ov, i, j))
    cand.sort()
    parent = list(range(K))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = []
    for _, i, j in cand:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            edges.append((i, j))
    labels = [canonical_hash(_fragment(mol, c)) for c in cliques]
    return MolTree(mol=mol, cliques=cliques, edges=edges, labels=labels)


class Vocab:
    """Fragment vocabulary over canonical clique hashes (fast_jtnn Vocab)."""

    def __init__(self):
        self.hash_to_id: Dict[str, int] = {}
        self.fragments: List[Mol] = []

    @classmethod
    def build(cls, mols: Sequence[Mol]) -> "Vocab":
        v = cls()
        for mol in mols:
            t = tree_decomp(mol)
            for c, h in zip(t.cliques, t.labels):
                if h not in v.hash_to_id:
                    v.hash_to_id[h] = len(v.fragments)
                    v.fragments.append(_fragment(mol, c))
        return v

    def __len__(self):
        return len(self.fragments)

    def index(self, h: str) -> int:
        return self.hash_to_id.get(h, 0)


# ---------------------------------------------------------------------------
# encoders / decoder networks
# ---------------------------------------------------------------------------

class TreeGRUEncoder(nn.Module):
    """GRU message passing over padded junction trees
    (jtnn_enc.py:8-132). Inputs: node label ids [T, Nn], adjacency
    [T, Nn, Nn], node mask [T, Nn]; returns [root ; mean] embeddings."""

    def __init__(self, vocab_size: int, hidden: int = 128, depth: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.hidden, self.depth = hidden, depth
        self.emb = embedding(vocab_size, hidden, gen)
        self.gru = GRUCell(hidden, hidden, gen)

    def forward(self, labels, adj, mask):
        m3 = mask[..., None]
        x = torch.where(m3, self.emb(labels.long()), 0.0)     # [T, Nn, h]
        h = torch.zeros_like(x)
        for _ in range(self.depth):
            m = torch.einsum("tij,tjh->tih", adj, h)           # neighbor sum
            h = self.gru(h.reshape(-1, self.hidden),
                         (x + m).reshape(-1, self.hidden)).reshape(x.shape)
            h = torch.where(m3, h, 0.0)
        root = h[:, 0]                                          # root = node 0
        pooled = h.sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp_min(1)
        return torch.cat([root, pooled], dim=-1)


class GraphMPN(nn.Module):
    """Atom-level message passing (mpn.py:94) over dense per-mol
    adjacency."""

    def __init__(self, hidden: int = 128, depth: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.emb = embedding(64, hidden, gen)
        self.lin0 = linear(hidden, hidden, gen)
        self.lins = nn.ModuleList(linear(hidden, hidden, gen)
                                  for _ in range(depth))

    def forward(self, z, adj, mask):
        m3 = mask[..., None]
        x = torch.where(m3, self.emb(z.long()), 0.0)          # [B, Na, h]
        h = torch.relu(self.lin0(x))
        for lin in self.lins:
            m = torch.einsum("bij,bjh->bih", adj, h)
            h = torch.where(m3, torch.relu(x + lin(m)), 0.0)
        return h.sum(dim=1)


def _sigmoid_bce(logits, labels):
    """optax ``sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(
        -logits)


class JTVAEModel(nn.Module):
    """Encoder pair + VAE heads + teacher-forced tree decoder
    (jtnn_vae.py:20-258 + jtnn_dec.py). With ``predict_prop=True`` this is
    the property-predicting variant (jtprop_vae.py:49-56 propNN): a
    tanh-MLP head on the latent, trained jointly with MSE."""

    def __init__(self, vocab_size: int, hidden: int = 128, latent: int = 56,
                 depth_t: int = 4, depth_g: int = 3,
                 predict_prop: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.vocab_size, self.hidden, self.latent = vocab_size, hidden, latent
        self.predict_prop = predict_prop
        half = latent // 2
        self.tree_enc = TreeGRUEncoder(vocab_size, hidden, depth_t, gen)
        self.graph_enc = GraphMPN(hidden, depth_g, gen)
        self.t_mean = linear(2 * hidden, half, gen)
        self.t_logvar = linear(2 * hidden, half, gen)
        self.g_mean = linear(hidden, half, gen)
        self.g_logvar = linear(hidden, half, gen)
        self.dec_gru = GRUCell(hidden, hidden, gen)
        self.dec_label = linear(hidden, vocab_size, gen)
        self.dec_topo = linear(hidden, 1, gen)
        self.dec_init = linear(2 * half, hidden, gen)
        self.dec_emb = embedding(vocab_size, hidden, gen)
        if predict_prop:
            self.prop_nn1 = linear(2 * half, hidden, gen)
            self.prop_nn2 = linear(hidden, 1, gen)

    def predict_property(self, latent):
        """propNN(latent) — jtprop_vae.py:49-53 (Linear-Tanh-Linear)."""
        return self.prop_nn2(torch.tanh(self.prop_nn1(latent)))[:, 0]

    def encode(self, batch):
        zt = self.tree_enc(batch["labels"], batch["tree_adj"],
                           batch["tree_mask"])
        zg = self.graph_enc(batch["z"], batch["mol_adj"], batch["mol_mask"])
        return (self.t_mean(zt), self.t_logvar(zt),
                self.g_mean(zg), self.g_logvar(zg))

    def decode_train(self, latent, batch):
        """Teacher-forced DFS decoding: at each step predict
        (expand-vs-backtrack, next fragment label)."""
        steps_label = batch["dec_label"].long()   # [B, S] target labels
        steps_topo = batch["dec_topo"]            # [B, S] 1=expand 0=back
        steps_mask = batch["dec_mask"]            # [B, S]
        prev_label = batch["dec_prev"].long()     # [B, S] current node
        S = steps_label.shape[1]
        h = torch.relu(self.dec_init(latent))
        label_ll = 0.0
        topo_ll = 0.0
        for s in range(S):
            inp = self.dec_emb(prev_label[:, s]) + torch.relu(
                self.dec_init(latent))
            h = self.dec_gru(h, inp)
            topo_logit = self.dec_topo(h)[:, 0]
            topo_ll = topo_ll + torch.where(
                steps_mask[:, s],
                -_sigmoid_bce(topo_logit, steps_topo[:, s].float()), 0.0)
            lab_lp = F.log_softmax(self.dec_label(h), -1)
            pick = lab_lp.gather(1, steps_label[:, s][:, None])[:, 0]
            label_ll = label_ll + torch.where(
                steps_mask[:, s] & (steps_topo[:, s] > 0), pick, 0.0)
        denom = steps_mask.sum(dim=1).clamp_min(1)
        return (label_ll + topo_ll) / denom

    def draw(self, gen: torch.Generator, B: int, device: DeviceLike = None):
        """The reparameterisation normals of one forward: (tree, graph),
        each [B, latent // 2], drawn on the generator's device."""
        half = self.latent // 2
        gd = gen.device
        dev = gd if device is None else torch.device(device)
        return tuple(torch.randn((B, half), generator=gen, device=gd).to(dev)
                     for _ in range(2))

    def forward(self, batch, noise, beta: float = 0.005):
        tm, tv, gm, gv = self.encode(batch)
        eps_t, eps_g = noise
        zt = tm + torch.exp(0.5 * tv) * eps_t
        zg = gm + torch.exp(0.5 * gv) * eps_g
        latent = torch.cat([zt, zg], dim=-1)
        rec_ll = self.decode_train(latent, batch)
        kl = -0.5 * (1 + tv - tm ** 2 - torch.exp(tv)).sum(-1) \
            - 0.5 * (1 + gv - gm ** 2 - torch.exp(gv)).sum(-1)
        loss = (-rec_ll + beta * kl).mean()
        aux = {"rec": (-rec_ll).mean(), "kl": kl.mean()}
        if self.predict_prop and "props" in batch:
            pred = self.predict_property(latent)
            prop_mse = ((pred - batch["props"]) ** 2).mean()
            loss = loss + prop_mse      # jtprop_vae.py forward: + prop_loss
            aux["prop_mse"] = prop_mse
        return loss, aux

    def decode_steps(self, latent, max_steps: int = 12):
        """Greedy decoding: returns (labels, topo) per step."""
        h = torch.relu(self.dec_init(latent))
        labels, topos = [], []
        prev = torch.zeros(latent.shape[0], dtype=torch.long,
                           device=latent.device)
        for _ in range(max_steps):
            inp = self.dec_emb(prev) + torch.relu(self.dec_init(latent))
            h = self.dec_gru(h, inp)
            topos.append(torch.sigmoid(self.dec_topo(h)[:, 0]))
            prev = torch.argmax(self.dec_label(h), -1)
            labels.append(prev)
        return torch.stack(labels, 1), torch.stack(topos, 1)


# ---------------------------------------------------------------------------
# batching + the method
# ---------------------------------------------------------------------------

def _dfs_steps(tree: MolTree, vocab: Vocab, max_steps: int):
    """Teacher-forcing DFS trace: (prev_label, target_label, topo)."""
    adj: Dict[int, List[int]] = {i: [] for i in range(len(tree.cliques))}
    for a, b in tree.edges:
        adj[a].append(b)
        adj[b].append(a)
    prev, target, topo = [], [], []
    visited = {0}

    def dfs(u):
        for v in sorted(adj[u]):
            if v in visited:
                continue
            visited.add(v)
            prev.append(vocab.index(tree.labels[u]))
            target.append(vocab.index(tree.labels[v]))
            topo.append(1)
            dfs(v)
        prev.append(vocab.index(tree.labels[u]))
        target.append(0)
        topo.append(0)

    dfs(0)
    return prev[:max_steps], target[:max_steps], topo[:max_steps]


def batch_trees(trees: List[MolTree], vocab: Vocab, max_nodes: int = 12,
                max_atoms: int = 24, max_steps: int = 12) -> Dict:
    B = len(trees)
    labels = np.zeros((B, max_nodes), np.int32)
    tadj = np.zeros((B, max_nodes, max_nodes), np.float32)
    tmask = np.zeros((B, max_nodes), bool)
    z = np.zeros((B, max_atoms), np.int32)
    madj = np.zeros((B, max_atoms, max_atoms), np.float32)
    mmask = np.zeros((B, max_atoms), bool)
    dl = np.zeros((B, max_steps), np.int32)
    dt = np.zeros((B, max_steps), np.int32)
    dm = np.zeros((B, max_steps), bool)
    dp = np.zeros((B, max_steps), np.int32)
    for b, t in enumerate(trees):
        K = min(len(t.cliques), max_nodes)
        for i in range(K):
            labels[b, i] = vocab.index(t.labels[i])
            tmask[b, i] = True
        for a, bb in t.edges:
            if a < max_nodes and bb < max_nodes:
                tadj[b, a, bb] = tadj[b, bb, a] = 1.0
        n = min(t.mol.num_atoms, max_atoms)
        for i in range(n):
            z[b, i] = min(t.mol.atoms[i].z, 63)
            mmask[b, i] = True
        for (a, bb), o in t.mol.bonds.items():
            if a < max_atoms and bb < max_atoms:
                madj[b, a, bb] = madj[b, bb, a] = 1.0
        pv, tg, tp = _dfs_steps(t, vocab, max_steps)
        S = len(pv)
        dp[b, :S] = pv
        dl[b, :S] = tg
        dt[b, :S] = tp
        dm[b, :S] = True
    t = torch.from_numpy
    return {"labels": t(labels), "tree_adj": t(tadj), "tree_mask": t(tmask),
            "z": t(z), "mol_adj": t(madj), "mol_mask": t(mmask),
            "dec_label": t(dl), "dec_topo": t(dt), "dec_mask": t(dm),
            "dec_prev": t(dp)}


def assemble(fragments: List[Mol]) -> Optional[Mol]:
    """Greedy stitching of decoded fragments: attach each next fragment at
    the first valency-feasible atom pair (compact substitute for the
    reference's JTMPN candidate scoring)."""
    if not fragments:
        return None
    mol = fragments[0].copy()
    for frag in fragments[1:]:
        base = mol.num_atoms
        attach_done = False
        for a in range(mol.num_atoms):
            for fa in range(frag.num_atoms):
                trial = mol.copy()
                off = {}
                for i, at in enumerate(frag.atoms):
                    off[i] = trial.add_atom(at.z, at.charge)
                for (x, y), o in frag.bonds.items():
                    trial.add_bond(off[x], off[y], o)
                trial.add_bond(a, off[fa], 1.0)
                if check_valency(trial):
                    mol = trial
                    attach_done = True
                    break
            if attach_done:
                break
        if not attach_done:
            break
    return mol


def _to(batch: Dict[str, torch.Tensor], dev) -> Dict[str, torch.Tensor]:
    return {k: v.to(dev) for k, v in batch.items()}


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.tensor(
        np.asarray(a, np.float32))


class JTVAE(Generator):
    """The method (reference jtvae.py:20-293). Training draws its
    reparameterisation normals from a ``torch.Generator`` seeded with
    ``seed`` (``JTVAEModel.draw``); sampling draws the prior latents from
    one seeded with ``seed``, or takes them (``latents``)."""

    def __init__(self, vocab: Optional[Vocab] = None, hidden: int = 128,
                 latent: int = 56):
        self.vocab = vocab
        self.hidden = hidden
        self.latent = latent
        self.model = None
        self.params = None

    def build_vocab(self, smiles: Sequence[str]):
        mols = []
        for s in smiles:
            try:
                mols.append(mol_from_smiles(s))
            except Exception:
                pass
        self.vocab = Vocab.build(mols)
        self._mols = mols
        return self.vocab

    def _device(self):
        return next(self.model.parameters()).device

    def _train(self, smiles: Sequence[str], props: Optional[Sequence[float]],
               batch_size: int, epochs: int, lr: float, beta: float,
               seed: int, verbose: bool, device: DeviceLike):
        if self.vocab is None:
            self.build_vocab(smiles)
        mols = getattr(self, "_mols", None) or [
            mol_from_smiles(s) for s in smiles]
        trees = [tree_decomp(m) for m in mols]
        predict_prop = props is not None
        if predict_prop:
            props = np.asarray(props, np.float32)
            assert len(props) == len(trees)
        dev = resolve_device(device)
        self.model = JTVAEModel(
            vocab_size=max(len(self.vocab), 1), hidden=self.hidden,
            latent=self.latent, predict_prop=predict_prop,
            generator=torch.Generator().manual_seed(seed)).to(dev)
        model = self.model

        def make_batch(idx):
            batch = batch_trees([trees[j] for j in idx], self.vocab)
            if predict_prop:
                batch["props"] = torch.from_numpy(props[np.asarray(idx)])
            return _to(batch, dev)

        opt = torch.optim.Adam(model.parameters(), lr)
        gen = torch.Generator().manual_seed(seed)
        rng = np.random.default_rng(seed)
        history = []
        for ep in range(epochs):
            order = rng.permutation(len(trees))
            losses = []
            for i in range(0, len(trees) - batch_size + 1, batch_size):
                batch = make_batch(order[i:i + batch_size])
                opt.zero_grad(set_to_none=True)
                loss, _ = model(batch, model.draw(gen, batch_size, dev), beta)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            avg = (float(np.mean(torch.stack(losses).cpu().numpy()
                                 .astype(np.float64)))
                   if losses else float("nan"))
            history.append(avg)
            if verbose:
                print(f"Epoch {ep + 1} | elbo-loss {avg:.4f}")
        self.params = model.state_dict()
        return history

    def train_rand_gen(self, smiles: Sequence[str], batch_size: int = 16,
                       epochs: int = 5, lr: float = 1e-3,
                       beta: float = 0.005, seed: int = 0,
                       verbose: bool = True, device: DeviceLike = None):
        return self._train(smiles, None, batch_size, epochs, lr, beta,
                           seed, verbose, device)

    def train_prop_opt(self, smiles: Sequence[str],
                       props: Optional[Sequence[float]] = None,
                       batch_size: int = 16, epochs: int = 5,
                       lr: float = 1e-3, beta: float = 0.005,
                       seed: int = 0, verbose: bool = True,
                       device: DeviceLike = None):
        """Train the property-predicting variant (jtprop_vae.py): joint
        ELBO + MSE(propNN(latent), prop). ``props`` defaults to the
        chem-kernel plogp PROXY of each training molecule."""
        if self.vocab is None:
            self.build_vocab(smiles)
        if props is None:
            from .environment import calculate_min_plogp
            mols = getattr(self, "_mols", None) or [
                mol_from_smiles(s) for s in smiles]
            props = [calculate_min_plogp(m) for m in mols]
        return self._train(smiles, props, batch_size, epochs, lr, beta,
                           seed, verbose, device)

    def train_assembler(self, smiles: Optional[Sequence[str]] = None,
                        epochs: int = 30, verbose: bool = False,
                        device: DeviceLike = None):
        """Train the JTMPN candidate scorer on junction fixtures from the
        training molecules (the reference's assm loss; see jtmpn.py)."""
        from .jtmpn import build_assembly_fixtures, train_assembler
        mols = getattr(self, "_mols", None)
        if mols is None:
            mols = [mol_from_smiles(s) for s in (smiles or [])]
        fixtures = build_assembly_fixtures(mols)
        if not fixtures:
            self.scorer = None
            return None
        self.scorer = train_assembler(
            fixtures, epochs=epochs, verbose=verbose, device=device)
        self._assembly_fixtures = fixtures
        return fixtures

    def _assemble(self, frags):
        from .jtmpn import assemble_scored
        return assemble_scored(frags, getattr(self, "scorer", None))

    @torch.no_grad()
    def _decode_latents(self, latents, max_steps: int = 8,
                        empty_fallback: bool = True) -> List[Optional[Mol]]:
        """Batch-decode latent vectors [B, latent] -> host-assembled mols."""
        labels, topos = self.model.decode_steps(
            _tensor(latents).to(self._device()), max_steps)
        labels = labels.cpu().numpy()
        topos = topos.cpu().numpy()
        out = []
        for b in range(labels.shape[0]):
            frags = []
            for s in range(max_steps):
                if topos[b, s] < 0.5 and s > 0:
                    break
                frags.append(self.vocab.fragments[int(labels[b, s])])
            mol = self._assemble(frags)
            if mol is None and empty_fallback:
                mol = Mol()
            out.append(mol)
        return out

    def _prior(self, n_mols: int, seed: int, latents):
        if latents is not None:
            return _tensor(latents)
        return torch.randn((n_mols, self.latent),
                           generator=torch.Generator().manual_seed(seed))

    def run_rand_gen(self, n_mols: int = 20, seed: int = 0,
                     max_steps: int = 8, latents=None) -> List[Mol]:
        assert self.params is not None
        return self._decode_latents(self._prior(n_mols, seed, latents),
                                    max_steps)

    # -- property optimization (jtprop_vae.py:215-263 optimize) ----------

    @torch.no_grad()
    def encode_latent_mean(self, smiles_list: Sequence[str]):
        """[tree_mean ; graph_mean] per molecule
        (jtprop_vae.py:66-74 encode_latent_mean)."""
        trees = [tree_decomp(mol_from_smiles(s)) for s in smiles_list]
        batch = _to(batch_trees(trees, self.vocab), self._device())
        tm, _, gm, _ = self.model.encode(batch)
        return torch.cat([tm, gm], dim=-1)

    def _ascend(self, latents, lr: float, num_iter: int):
        """Gradient ascent on propNN wrt the latent; returns every visited
        latent [num_iter, B, latent] (a loop where the JAX package scans,
        decoded in one batch as there)."""
        assert self.model.predict_prop, "train_prop_opt first"
        z = _tensor(latents).to(self._device()).detach()
        visited = []
        for _ in range(num_iter):
            z = z.requires_grad_()
            with torch.enable_grad():
                (g,) = torch.autograd.grad(
                    self.model.predict_property(z).sum(), z)
            z = (z + lr * g).detach()
            visited.append(z)
        return torch.stack(visited)

    def optimize(self, smiles: str, sim_cutoff: float = 0.0,
                 lr: float = 2.0, num_iter: int = 20,
                 max_steps: int = 8) -> Tuple[Optional[Mol], float]:
        """Constrained latent-space optimization of one molecule: ascend
        the property head, return the furthest decodable point whose
        Morgan-Tanimoto similarity to the input is >= ``sim_cutoff``
        (jtprop_vae.py:215-263)."""
        from .environment import morgan_fingerprint, tanimoto_similarity
        mol_in = mol_from_smiles(smiles)
        fp_in = morgan_fingerprint(mol_in)
        latent0 = self.encode_latent_mean([smiles])[0]
        visited = self._ascend(latent0[None], lr, num_iter)[:, 0]
        mols = self._decode_latents(visited, max_steps, empty_fallback=False)
        # walk from the furthest point back (every point is decoded)
        for m in reversed(mols):
            if m is None or m.num_atoms == 0 or not check_valency(m):
                continue
            sim = tanimoto_similarity(fp_in, morgan_fingerprint(m))
            if sim >= sim_cutoff:
                return m, float(sim)
        return None, 0.0

    def run_prop_opt(self, n_mols: int = 20, seed: int = 0,
                     lr: float = 2.0, num_iter: int = 20,
                     max_steps: int = 8, latents=None) -> List[Mol]:
        """Unconstrained property optimization: ascend prior samples and
        decode the trajectory tails (Generator.run_prop_opt surface)."""
        assert self.model is not None and self.model.predict_prop, \
            "train_prop_opt first"
        visited = self._ascend(self._prior(n_mols, seed, latents), lr,
                               num_iter)
        return self._decode_latents(visited[-1], max_steps)

    def run_const_prop_opt(self, smiles_list: Sequence[str],
                           lr: float = 2.0, num_iter: int = 20) -> Dict:
        """Optimize each input at the four reference similarity cutoffs;
        returns the ConstPropOptEvaluator input_dict."""
        out: Dict = {"inp_smiles": list(smiles_list)}
        for key_name, thr in (("mols_0", 0.0), ("mols_2", 0.2),
                              ("mols_4", 0.4), ("mols_6", 0.6)):
            out[key_name] = [self.optimize(s, sim_cutoff=thr, lr=lr,
                                           num_iter=num_iter)[0]
                             for s in smiles_list]
        return out

    @torch.no_grad()
    def reconstruct(self, smiles: str, seed: int = 0) -> Optional[Mol]:
        """Encode-decode one molecule (jtvae.py reconstruct surface)."""
        tree = tree_decomp(mol_from_smiles(smiles))
        batch = _to(batch_trees([tree], self.vocab), self._device())
        tm, tv, gm, gv = self.model.encode(batch)
        labels, topos = self.model.decode_steps(torch.cat([tm, gm], -1), 8)
        labels = labels.cpu().numpy()[0]
        topos = topos.cpu().numpy()[0]
        frags = [self.vocab.fragments[int(labels[0])]]
        for l, t in zip(labels[1:], topos[1:]):
            if t < 0.5:
                break
            frags.append(self.vocab.fragments[int(l)])
        return self._assemble(frags)
