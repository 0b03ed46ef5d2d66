"""G-SphereNet: autoregressive flow for 3D molecular geometry. Port of
``dig_tpu/ggraph3d/gspherenet.py``.

Parity with ``dig/ggraph3D/method/G_SphereNet/{gspherenet.py:8-128,
model/sphgen.py:10-203}``: a SphereNet-style encoder embeds the partial
molecule; a focus MLP scores which atom grows next; conditional affine
flows (exp-ST nets) model the new atom's type (dequantized one-hot),
distance to the focus, angle at (focus, c1) and torsion at (focus, c1, c2),
with masked multi-head attention providing global context. Generation
places atoms via the local spherical frame.

Routes. The encoder's edge->node sum is ``segment_sum_sorted`` over the
radius graph's receivers (ascending, as ``radius_graph_flat`` emits them):
the sorted-CSR kernel on a CUDA tensor, its plain version on the CPU. Its
row gathers (``h[senders]`` and the type embedding gathered per node) are
``gather_rows``, whose adjoint is the same sum; the sender table is built
once a pass and shared by the layers. Invalid attention keys hold -1e30,
so a query whose graph has no valid key gets a uniform softmax, as in the
JAX package.

Generation is a loop on the host over the atom steps (the JAX package's
``lax.scan`` body), on batched tensors on the device: the ``alive`` and
``stop`` masks stay there and the host reads the batch once, at its end.
The encoder runs once a step; the JAX body calls ``step_features`` three
times on the same partial molecules (the same encoder output).

Deviation from the JAX package: its ``jax.random`` draws (the
dequantization noise of a training step; a generation batch's latents,
Gumbel noise and first types) come from a ``torch.Generator`` seeded with
``seed`` on the CPU (``SphGenModel.draw``, ``GSphereNet.draw_batch``) and
the step functions take the drawn noise.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch
from ..nn.init import xavier_uniform
from ..ops.basis import gaussian_rbf
from ..ops.radius import radius_graph_flat
from ..ops.segment import gather_plan, gather_rows, segment_sum_sorted
from ..ops.segment_csr import full_window
from ..ops.triplets import edge_distances

_NEG = -1e30


class SphereEncoder(nn.Module):
    """Compact SchNet/SphereNet-style encoder -> node embeddings [N, d]
    (role of ``model/spherenet.py`` in the reference)."""

    def __init__(self, cutoff: float = 5.0, num_layers: int = 3,
                 hidden: int = 128, num_gaussians: int = 32,
                 max_edges: int = 2048):
        super().__init__()
        self.cutoff = cutoff
        self.num_gaussians = num_gaussians
        self.max_edges = max_edges
        self.emb = nn.Embedding(32, hidden)
        self.filters = nn.ModuleList(
            [nn.Linear(num_gaussians, hidden) for _ in range(num_layers)])
        self.upd1 = nn.ModuleList(
            [nn.Linear(hidden, hidden) for _ in range(num_layers)])
        self.upd2 = nn.ModuleList(
            [nn.Linear(hidden, hidden) for _ in range(num_layers)])

    def forward(self, g: GraphBatch) -> torch.Tensor:
        pos = g.nodes["pos"]
        N = g.num_nodes
        senders, receivers, edge_mask = radius_graph_flat(
            pos, g.node_graph, g.node_mask, self.cutoff, self.max_edges)
        dist = edge_distances(pos, senders, receivers, edge_mask)
        rbf = gaussian_rbf(dist, 0.0, self.cutoff, self.num_gaussians)
        send_plan = gather_plan(senders, N)
        eb = full_window(senders.shape[0])
        h = self.emb(g.nodes["z"].long())
        h = torch.where(g.node_mask[:, None], h, 0.0)
        for lin_w, lin1, lin2 in zip(self.filters, self.upd1, self.upd2):
            w = F.silu(lin_w(rbf))
            msg = gather_rows(h, senders, send_plan) * w
            agg = segment_sum_sorted(msg, receivers, N, mask=edge_mask,
                                     max_edges_per_block=eb)
            upd = lin2(F.silu(lin1(agg)))
            h = h + torch.where(g.node_mask[:, None], upd, 0.0)
        return h


class MaskedMHA(nn.Module):
    """Multi-head attention of one query per step over its graph's nodes
    (reference att.py MH_ATT with batch masking)."""

    def __init__(self, q_dim: int, kv_dim: int, heads: int = 4,
                 out_dim: int = 128):
        super().__init__()
        self.heads = heads
        d = out_dim // heads
        self.q = nn.Linear(q_dim, heads * d)
        self.k = nn.Linear(kv_dim, heads * d)
        self.v = nn.Linear(kv_dim, heads * d)
        self.out = nn.Linear(heads * d, out_dim)

    def forward(self, q, kv, q_graph, kv_graph, kv_mask):
        d = self.q.out_features // self.heads
        S, N = q.shape[0], kv.shape[0]
        Q = self.q(q).reshape(S, self.heads, d)
        K = self.k(kv).reshape(N, self.heads, d)
        V = self.v(kv).reshape(N, self.heads, d)
        logits = torch.einsum("shd,nhd->shn", Q, K) / math.sqrt(d)
        valid = (q_graph[:, None] == kv_graph[None, :]) & kv_mask[None, :]
        logits = torch.where(valid[:, None, :], logits, _NEG)
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("shn,nhd->shd", att, V).reshape(S, -1)
        return self.out(out)


class STExp(nn.Module):
    """Affine flow conditioner: (s, t) with s = exp(tanh-bounded)
    (reference net_utils ST_Net_Exp)."""

    def __init__(self, in_dim: int, out_dim: int, hid: int = 128):
        super().__init__()
        self.out_dim = out_dim
        self.lin1 = nn.Linear(in_dim, hid)
        self.lin2 = nn.Linear(hid, out_dim * 2)

    def forward(self, cond):
        out = self.lin2(torch.tanh(self.lin1(cond)))
        s = torch.tanh(out[..., :self.out_dim])
        return torch.exp(s), out[..., self.out_dim:]


def flow_forward(st_nets, x, cond):
    log_jacob = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for net in st_nets:
        s, t = net(cond)
        x = (x + t) * s
        log_jacob = log_jacob + torch.sum(torch.log(torch.abs(s) + 1e-12),
                                          dim=-1)
    return x, log_jacob


def flow_reverse(st_nets, latent, cond):
    for net in reversed(st_nets):
        s, t = net(cond)
        latent = latent / s - t
    return latent


class SphGenModel(nn.Module):
    """Per-step flows over (type, dist, angle, torsion) (sphgen.py).

    Weights are drawn from ``generator`` (Glorot-uniform linears with zero
    biases, the last layer of each ST net at 1e-10 as flax's constant
    initialiser, N(0, 1/hidden) embeddings) on ``device``."""

    def __init__(self, num_node_types: int = 4, cutoff: float = 5.0,
                 hidden: int = 128, num_flow_layers: int = 6,
                 deq_coeff: float = 0.9, n_att_heads: int = 4,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        h = hidden
        self.num_node_types = num_node_types
        self.deq_coeff = deq_coeff
        self.encoder = SphereEncoder(cutoff, 3, h)
        self.type_emb = nn.Embedding(32, h)
        self.focus_mlp = nn.ModuleList([nn.Linear(h, h), nn.Linear(h, 1)])
        self.node_att = MaskedMHA(h, h, n_att_heads, h)
        self.dist_att = MaskedMHA(h, h, n_att_heads, h)
        self.angle_att = MaskedMHA(2 * h, h, n_att_heads, h)
        self.torsion_att = MaskedMHA(3 * h, h, n_att_heads, h)
        L = num_flow_layers
        self.node_flow = nn.ModuleList(
            [STExp(2 * h, num_node_types, h) for _ in range(L)])
        self.dist_flow = nn.ModuleList([STExp(2 * h, 1, h) for _ in range(L)])
        self.angle_flow = nn.ModuleList(
            [STExp(3 * h, 1, h) for _ in range(L)])
        self.torsion_flow = nn.ModuleList(
            [STExp(4 * h, 1, h) for _ in range(L)])
        self._init(generator or torch.Generator().manual_seed(0), h)
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init(self, gen: torch.Generator, h: int) -> None:
        last = {id(st.lin2) for flows in (self.node_flow, self.dist_flow,
                                          self.angle_flow, self.torsion_flow)
                for st in flows}
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if id(m) in last:
                    m.weight.fill_(1e-10)
                else:
                    xavier_uniform(m.weight, gen)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(h))

    def draw(self, gen: torch.Generator, num_steps: int) -> torch.Tensor:
        """A training step's dequantization uniforms ``[S, T]`` (the JAX
        ``jax.random.uniform(rng, x_z.shape)``), on the generator's
        device."""
        return torch.rand((num_steps, self.num_node_types), generator=gen,
                          device=gen.device)

    def _focus_score(self, node_feat):
        h = F.relu(self.focus_mlp[0](node_feat))
        return self.focus_mlp[1](h)[..., 0]

    def _conditioners(self, g, node_feat, focus, c1, c2, new_type):
        qg = g.node_graph[focus]
        local_nt = node_feat[focus]
        global_nt = self.node_att(local_nt, node_feat, qg, g.node_graph,
                                  g.node_mask)
        nt_feat = torch.cat([local_nt, global_nt], -1)
        t_emb = self.type_emb(new_type.long())             # [S, h]
        # node_emb conditioned on the new atom's type per its graph
        node_emb = node_feat * gather_rows(t_emb, g.node_graph)
        local_d = node_emb[focus]
        global_d = self.dist_att(local_d, node_emb, qg, g.node_graph,
                                 g.node_mask)
        d_feat = torch.cat([local_d, global_d], -1)
        local_a = torch.cat([node_emb[c1], node_emb[focus]], -1)
        global_a = self.angle_att(local_a, node_emb, qg, g.node_graph,
                                  g.node_mask)
        a_feat = torch.cat([local_a, global_a], -1)
        local_t = torch.cat([node_emb[c2], node_emb[c1], node_emb[focus]], -1)
        global_t = self.torsion_att(local_t, node_emb, qg, g.node_graph,
                                    g.node_mask)
        t_feat = torch.cat([local_t, global_t], -1)
        return nt_feat, d_feat, a_feat, t_feat

    def forward(self, g: GraphBatch, step: Dict, noise: torch.Tensor):
        """Training forward over a batch of placement steps.

        ``g``: partial molecules (one per step). ``step`` dict of tensors:
        focus/c1/c2 [S] node indices (into the flat batch), new_atom_type
        [S], new_dist/new_angle/new_torsion [S], has_angle/has_torsion [S]
        masks, focus_label [N] (1 for the true focus atom rows),
        step_mask [S]. ``noise``: the dequantization uniforms [S, T]
        (:meth:`draw`).
        """
        node_feat = self.encoder(g)
        focus_score = self._focus_score(node_feat)
        focus, c1, c2 = (step[k].long() for k in ("focus", "c1", "c2"))
        x_z = F.one_hot(step["new_atom_type"].long(),
                        self.num_node_types).to(node_feat.dtype)
        x_z = x_z + self.deq_coeff * noise.to(x_z)
        nt_feat, d_feat, a_feat, t_feat = self._conditioners(
            g, node_feat, focus, c1, c2, step["new_atom_type"])
        return {"node": flow_forward(self.node_flow, x_z, nt_feat),
                "dist": flow_forward(self.dist_flow,
                                     step["new_dist"][:, None], d_feat),
                "angle": flow_forward(self.angle_flow,
                                      step["new_angle"][:, None], a_feat),
                "torsion": flow_forward(self.torsion_flow,
                                        step["new_torsion"][:, None], t_feat),
                "focus_score": focus_score}

    def loss(self, g: GraphBatch, step: Dict, noise: torch.Tensor):
        out = self.forward(g, step, noise)
        sm = step["step_mask"]

        def nll(latent, lj, extra_mask=None):
            ll = -0.5 * (math.log(2 * math.pi) + latent ** 2).sum(-1) + lj
            m = sm if extra_mask is None else sm & extra_mask
            return -torch.sum(torch.where(m, ll, 0.0)) / torch.clamp(
                torch.sum(m), min=1)

        l_node = nll(*out["node"])
        l_dist = nll(*out["dist"])
        l_angle = nll(*out["angle"], step.get("has_angle"))
        l_torsion = nll(*out["torsion"], step.get("has_torsion"))
        # focus BCE over real nodes (optax's sigmoid_binary_cross_entropy)
        x = out["focus_score"]
        lab = step["focus_label"].to(x.dtype)
        fl = -lab * F.logsigmoid(x) - (1.0 - lab) * F.logsigmoid(-x)
        l_focus = torch.sum(torch.where(g.node_mask, fl, 0.0)) / torch.clamp(
            torch.sum(g.node_mask), min=1)
        total = l_node + l_dist + l_angle + l_torsion + l_focus
        return total, {"node": l_node, "dist": l_dist, "angle": l_angle,
                       "torsion": l_torsion, "focus": l_focus}

    # -- generation-time single-step conditioners -------------------------
    def step_features(self, g: GraphBatch, focus, c1, c2, new_type,
                      node_feat: Optional[torch.Tensor] = None):
        """``(focus_score, nt_feat, d_feat, a_feat, t_feat)``; ``node_feat``
        the encoder's output for ``g`` where the caller has it."""
        if node_feat is None:
            node_feat = self.encoder(g)
        return (self._focus_score(node_feat),) + self._conditioners(
            g, node_feat, focus.long(), c1.long(), c2.long(), new_type)

    def reverse_node(self, feat, latent):
        return flow_reverse(self.node_flow, latent, feat)

    def reverse_dist(self, feat, latent):
        return flow_reverse(self.dist_flow, latent, feat)

    def reverse_angle(self, feat, latent):
        return flow_reverse(self.angle_flow, latent, feat)

    def reverse_torsion(self, feat, latent):
        return flow_reverse(self.torsion_flow, latent, feat)


def place_atom(pos_f, pos_c1, pos_c2, d, theta, phi):
    """New atom position from the local frame at the focus
    (reference geometric_computing.py position update)."""
    b1 = pos_c1 - pos_f
    b1 = b1 / max(np.linalg.norm(b1), 1e-9)
    b2 = pos_c2 - pos_c1
    n = np.cross(b1, b2)
    if np.linalg.norm(n) < 1e-6:
        n = np.cross(b1, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(n) < 1e-6:
            n = np.cross(b1, np.array([0.0, 1.0, 0.0]))
    n = n / max(np.linalg.norm(n), 1e-9)
    m = np.cross(n, b1)
    # direction at angle theta from b1, rotated phi about b1
    dvec = (np.cos(theta) * b1
            + np.sin(theta) * (np.cos(phi) * m + np.sin(phi) * n))
    return pos_f + d * dvec


def place_atom_batched(pos_f, pos_c1, pos_c2, d, theta, phi, eps=1e-9):
    """Batched branchless :func:`place_atom` ([B, 3] inputs, [B] scalars):
    degenerate normals fall back to cross products with the x then y axes
    by selection, so the placement runs on the device without a branch
    (the JAX ``_place_atom_jnp``)."""
    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=eps)

    def small(v):
        return torch.linalg.norm(v, dim=-1, keepdim=True) < 1e-6

    b1 = unit(pos_c1 - pos_f)
    n = torch.linalg.cross(b1, pos_c2 - pos_c1, dim=-1)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=b1.dtype, device=b1.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=b1.dtype, device=b1.device)
    n_x = torch.linalg.cross(b1, ex.expand_as(b1), dim=-1)
    n_y = torch.linalg.cross(b1, ey.expand_as(b1), dim=-1)
    n = unit(torch.where(small(n), torch.where(small(n_x), n_y, n_x), n))
    m = torch.linalg.cross(n, b1, dim=-1)
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    cp, sp = torch.cos(phi)[:, None], torch.sin(phi)[:, None]
    dvec = ct * b1 + st * (cp * m + sp * n)
    return pos_f + d[:, None] * dvec


def _to(step: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev) for k, v in step.items()}


class GSphereNet:
    """The method (reference gspherenet.py:8-128). ``train`` builds the
    model on ``device`` (the card unless the CPU is asked for); later
    calls run on the model's device."""

    def __init__(self, num_node_types: int = 4, cutoff: float = 5.0,
                 hidden: int = 64, num_flow_layers: int = 4):
        self.conf = dict(num_node_types=num_node_types, cutoff=cutoff,
                         hidden=hidden, num_flow_layers=num_flow_layers)
        self.model: Optional[SphGenModel] = None
        self.params = None

    def init_model(self, seed: int = 0,
                   device: DeviceLike = None) -> SphGenModel:
        """A model with weights drawn from ``seed`` on ``device``."""
        return SphGenModel(**self.conf,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)

    def train(self, loader, lr: float = 1e-3, wd: float = 0.0,
              max_epochs: int = 10, seed: int = 0, verbose: bool = True,
              device: DeviceLike = None):
        """NLL training (optax ``adam`` / ``adamw``); each step's
        dequantization noise drawn by ``model.draw`` from a generator
        seeded with ``seed``. The loss is read once an epoch."""
        next(iter(loader))    # the JAX method's init batch: it advances a
        # shuffling loader's stream, so both packages see the same orders
        model = self.init_model(seed, device)
        dev = next(model.parameters()).device
        opt = (torch.optim.AdamW(model.parameters(), lr, weight_decay=wd)
               if wd else torch.optim.Adam(model.parameters(), lr))
        gen = torch.Generator().manual_seed(seed)
        history = []
        for epoch in range(max_epochs):
            losses = []
            for g, step in loader:
                g, st = g.to(dev), _to(step, dev)
                noise = model.draw(gen, st["focus"].shape[0])
                opt.zero_grad(set_to_none=True)
                loss, _ = model.loss(g, st, noise)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            avg = float(np.mean(torch.stack(losses).cpu().numpy()
                                .astype(np.float64)))
            history.append(avg)
            if verbose:
                print(f"Epoch {epoch + 1} | loss {avg:.4f}")
        self.model = model
        self.params = model.state_dict()
        return history

    @staticmethod
    def draw_batch(gen: torch.Generator, B: int, num_types: int, pad: int,
                   max_atoms: int, temperature=(1.0, 1.0, 1.0, 1.0)
                   ) -> Dict[str, torch.Tensor]:
        """One generation batch's draws (the JAX ``run_batch``'s): the
        four latents ``[L, B, T]`` / ``[L, B, 1]`` scaled by
        ``temperature``, the Gumbel noise ``[L, B, pad]`` and the first
        types ``[B]``, L = max_atoms - 1, on the generator's device."""
        L, d = max_atoms - 1, gen.device
        nrm = lambda s: torch.randn(s, generator=gen, device=d)
        u = torch.rand((L, B, pad), generator=gen, device=d)
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        return {"lz": temperature[0] * nrm((L, B, num_types)),
                "ld": temperature[1] * nrm((L, B, 1)),
                "la": temperature[2] * nrm((L, B, 1)),
                "lt": temperature[3] * nrm((L, B, 1)),
                "gumbel": -torch.log(-torch.log(u)),
                "first": torch.randint(0, num_types, (B,), generator=gen,
                                       device=d)}

    @torch.no_grad()
    def run_batch(self, draws: Dict[str, torch.Tensor], pad: int,
                  max_atoms: int, min_atoms: int = 2, focus_th: float = 0.5):
        """One lockstep batch on the model's device from ``draws``
        (:meth:`draw_batch`): ``(z [B, pad] type ids, pos [B, pad, 3],
        n_atoms [B])`` on the device, nothing read on the host."""
        model = self.model
        dev = next(model.parameters()).device
        dr = {k: v.to(dev) for k, v in draws.items()}
        B = dr["first"].shape[0]
        N = B * pad
        bb = torch.arange(B, device=dev)
        base = bb * pad
        slots = torch.arange(pad, device=dev)[None, :]
        node_graph = torch.repeat_interleave(
            torch.arange(B, dtype=torch.int32, device=dev), pad)
        zerosB = torch.zeros(B, dtype=torch.long, device=dev)
        z = torch.zeros((B, pad), dtype=torch.long, device=dev)
        z[:, 0] = dr["first"].long()
        pos3 = torch.zeros((B, pad, 3), dtype=torch.float32, device=dev)
        n_atoms = torch.ones(B, dtype=torch.long, device=dev)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        for k, i in enumerate(range(1, max_atoms)):
            nm = slots < n_atoms[:, None]
            g = GraphBatch(
                nodes={"z": z.reshape(N), "pos": pos3.reshape(N, 3)},
                edges={}, senders=zerosB[:1].int(), receivers=zerosB[:1].int(),
                globals={}, node_graph=node_graph, node_mask=nm.reshape(N),
                edge_mask=torch.zeros(1, dtype=torch.bool, device=dev),
                graph_mask=torch.ones(B, dtype=torch.bool, device=dev),
                n_node=n_atoms.int(), n_edge=zerosB.int())
            node_feat = model.encoder(g)
            sc = torch.sigmoid(model._focus_score(node_feat)).reshape(B, pad)
            logits = torch.where(nm, torch.log(sc + 1e-9), -torch.inf)
            f_loc = torch.argmax(logits + dr["gumbel"][k], dim=1)
            pf = pos3[bb, f_loc]
            d_f = torch.linalg.norm(pos3 - pf[:, None, :], dim=-1)
            d_f = torch.where(nm & (slots != f_loc[:, None]), d_f, torch.inf)
            c1_loc = torch.argmin(d_f, dim=1)
            p1 = pos3[bb, c1_loc]
            d_c1 = torch.linalg.norm(pos3 - p1[:, None, :], dim=-1)
            d_c1 = torch.where(nm & (slots != f_loc[:, None])
                               & (slots != c1_loc[:, None]), d_c1, torch.inf)
            c2_loc = torch.argmin(d_c1, dim=1)
            # host-version cases: n==1 -> c1=c2=0; n==2 -> c2=f
            c1_loc = torch.where(n_atoms == 1, 0, c1_loc)
            c2_loc = torch.where(n_atoms == 1, 0,
                                 torch.where(n_atoms == 2, f_loc, c2_loc))
            fj, c1j, c2j = base + f_loc, base + c1_loc, base + c2_loc
            _, nt_feat, _, _, _ = model.step_features(
                g, fj, c1j, c2j, zerosB, node_feat)
            zn = model.reverse_node(nt_feat, dr["lz"][k])
            new_type = torch.argmax(zn, dim=-1)
            _, _, d_feat, a_feat, t_feat = model.step_features(
                g, fj, c1j, c2j, new_type, node_feat)
            mx = torch.max(torch.where(nm, sc, -torch.inf), dim=1).values
            stop = (i >= min_atoms) & (mx < focus_th)
            alive = alive & ~stop
            dd = model.reverse_dist(d_feat, dr["ld"][k])
            aa = model.reverse_angle(a_feat, dr["la"][k])
            tt = model.reverse_torsion(t_feat, dr["lt"][k])
            d = torch.abs(dd[:, 0]) + 0.6
            theta = torch.remainder(aa[:, 0], math.pi)
            phi = torch.remainder(tt[:, 0], 2 * math.pi)
            p2 = pos3[bb, c2_loc]
            zero = torch.zeros_like(d)
            np1 = pf + torch.stack([d, zero, zero], -1)
            ey = torch.tensor([0.0, 1.0, 0.0], device=dev)
            np2 = place_atom_batched(pf, p1, p1 + ey, d, theta, zero)
            np3 = place_atom_batched(pf, p1, p2, d, theta, phi)
            new_pos = torch.where((n_atoms == 1)[:, None], np1,
                                  torch.where((n_atoms == 2)[:, None],
                                              np2, np3))
            z[:, i] = torch.where(alive, new_type, z[:, i])
            pos3[:, i] = torch.where(alive[:, None], new_pos, pos3[:, i])
            n_atoms = n_atoms + alive.long()
        return z, pos3, n_atoms

    def generate(self, type_to_atomic_number: Sequence[int],
                 num_gen: int = 10, temperature=(1.0, 1.0, 1.0, 1.0),
                 min_atoms: int = 2, max_atoms: int = 20,
                 focus_th: float = 0.5, seed: int = 0,
                 n_node_pad: Optional[int] = None,
                 batch_size: int = 32) -> List[Dict]:
        """Lockstep generation in batches of ``batch_size`` on the model's
        device (:meth:`run_batch`), each batch's draws from one generator
        seeded with ``seed`` (:meth:`draw_batch`), each batch read once."""
        assert self.model is not None, "train first"
        T = len(type_to_atomic_number)
        pad = n_node_pad or max_atoms
        gen = torch.Generator().manual_seed(seed)
        results = []
        done = 0
        while done < num_gen:
            B = min(batch_size, num_gen - done)
            draws = self.draw_batch(gen, B, T, pad, max_atoms, temperature)
            z, pos3, n_atoms = (t.cpu().numpy() for t in self.run_batch(
                draws, pad, max_atoms, min_atoms, focus_th))
            for b in range(B):
                n = int(n_atoms[b])
                results.append({
                    "z": np.array([type_to_atomic_number[int(t)]
                                   for t in z[b, :n]]),
                    "pos": np.asarray(pos3[b, :n], np.float32)})
            done += B
        return results
