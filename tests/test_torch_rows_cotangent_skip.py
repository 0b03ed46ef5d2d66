"""The rows' cotangent (``dpt`` of ``fused_triplet_pt`` and
``fused_triplet_slot``, ``dgeo`` of ``fused_triplet_slot_geom``, the basis
cotangents ``dsbf`` / ``dtbf`` of ``fused_triplet_product``) is computed
only when the backward pass running will use it, on the CPU.

A force step differentiates the model twice: the inner
``torch.autograd.grad(energy, pos, create_graph=True)`` needs the rows'
cotangent (the rows lead to the positions), the outer
``loss.backward(inputs=params)`` does not. Each op's first-order backward
is counted here through its plain version's flag (``need_dpt`` /
``need_dgeo`` / ``basis_grads``), the CPU counterpart of the kernel's: per layer the inner
pass asks for the cotangent and the outer pass does not. The step's
parameter gradients are the same bits as those of the same step with the
cotangent forced on (the old rule: asked whenever the rows require a
gradient), and ``torch.autograd.grad(esum, pos)`` and a plain
``loss.backward()`` still receive it.

SphereNet at 2 layers x 32 (int_emb 16, n = 2, k = 4, K = 8) on seeded
synthetic molecules of 5-10 atoms: the packed basis on the unblocked
[N, K] table (``fused_triplet_pt``), the triplet product on the same table
without the packed basis (``fused_triplet_product``), the slot layout (``fused_triplet_slot``,
also bucketed through ``make_bucketed_step_fns``, and with ``remat=True``:
each layer's ``UpdateE`` recomputed in the backward, which must not change
what the engine is asked), and two layers of the geometry op on the slot
layout's geometry with seeded leaves.
"""
import inspect

import pytest
import torch

from dig_tpu.datasets import synthetic_molecules
from dig_tpu_torch.datasets import BucketedMoleculeLoader, MoleculeLoader
from dig_tpu_torch.models import SphereNet
from dig_tpu_torch.ops import triplet_product as tp
from dig_tpu_torch.ops import triplet_pt as tpt
from dig_tpu_torch.ops import triplet_slot as ts
from dig_tpu_torch.train import (energy_force, make_bucketed_step_fns,
                                 make_step_fns)

A = 10
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, int_emb_size=16,
          out_emb_channels=32, num_spherical=2, num_radial=4, nk_degree=8)
LAYERS = KW["num_layers"]
FLAGS = {"pt": dict(pallas_triplet=True, pallas_fuse_basis=True),
         "product": dict(pallas_triplet=True),
         "slot": dict(pallas_triplet=True, pallas_fuse_basis=True,
                      pallas_slot=True, block_size=A),
         "geom": dict(block_size=A)}
# the slot model with remat: the recomputed UpdateE must not change what
# _grad_wanted decides
FLAGS["slot_remat"] = dict(FLAGS["slot"], remat=True)
# the plain first-order VJP each op's backward runs on the CPU, and the
# keyword of its rows' flag
PLAIN = {"pt": (tpt, "fused_triplet_pt_bwd_ref", "need_dpt"),
         "product": (tp, "fused_triplet_product_bwd_reference",
                     "basis_grads"),
         "slot": (ts, "fused_triplet_slot_bwd_reference", "need_dpt"),
         "geom": (ts, "fused_triplet_slot_geom_bwd_reference", "need_dgeo")}
PLAIN["slot_remat"] = PLAIN["slot"]


def _mols(n=8, seed=5):
    return synthetic_molecules(n, seed=seed, min_atoms=5, max_atoms=A,
                               box=6.0, with_forces=True)


def _batch(op):
    slot = {} if op in ("pt", "product") else dict(slot_size=A)
    mols = [dict(m, y=m["y"][:1]) for m in _mols()]
    return next(iter(MoleculeLoader(mols, 4, shuffle=False, device="cpu",
                                    **slot)))


class GeomEnergy(torch.nn.Module):
    """Energies [G, 1] from two layers of ``fused_triplet_slot_geom`` on
    the slot geometry of a SphereNet (its own weights unused): per layer
    seeded leaves x [E, 16], ws, wt, the edge outputs projected on a
    seeded vector and summed per graph."""

    def __init__(self, E, G):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        n, k, C = KW["num_spherical"], KW["num_radial"], KW["int_emb_size"]
        r = lambda *s: torch.nn.Parameter(torch.randn(*s, generator=gen))
        self.xs = torch.nn.ParameterList([r(E, C) for _ in range(LAYERS)])
        self.ws = torch.nn.ParameterList([r(n * k, C) for _ in range(LAYERS)])
        self.wt = torch.nn.ParameterList([r(n * n * k, C)
                                          for _ in range(LAYERS)])
        self.w_out = torch.randn(C, generator=gen) * 0.1
        self.G = G
        self.geo_model = [SphereNet(**KW, **FLAGS["geom"], device="cpu",
                                    generator=torch.Generator().manual_seed(0))]

    def forward(self, g):
        sn = self.geo_model[0]
        geo = sn.geometry(g.nodes["pos"], g, A)
        _, m2t, lj = sn.slot_operands(geo, A)
        E, K = m2t.shape[1], KW["nk_degree"]
        smaj = lambda v: v.reshape(E, K).t()
        rows = torch.stack([smaj(geo.angle), smaj(geo.phi),
                            smaj(geo.dist_kj) / KW["cutoff"]], 1)
        cfg = (KW["num_spherical"], KW["num_radial"], True)
        per_edge = 0.0
        for x, ws, wt in zip(self.xs, self.ws, self.wt):
            out = ts.fused_triplet_slot_geom(x, rows, ws, wt, m2t, lj, A, K,
                                             cfg)
            per_edge = per_edge + out @ self.w_out
        node = torch.zeros(g.num_nodes).index_add_(0, geo.nkg.receivers,
                                                    per_edge)
        return torch.zeros(self.G, 1).index_add_(
            0, g.node_graph, (node * g.node_mask)[:, None])


def _model(op, batch):
    if op == "geom":
        K = KW["nk_degree"]
        return GeomEnergy(batch.num_nodes * K, batch.num_graphs)
    return SphereNet(**KW, **FLAGS[op], device="cpu",
                     generator=torch.Generator().manual_seed(0))


def _count_flags(monkeypatch, op):
    """Record the rows' flag of every first-order plain VJP of ``op``."""
    mod, name, kw = PLAIN[op]
    plain, flags = getattr(mod, name), []
    sig = inspect.signature(plain)

    def counted(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        flags.append(bool(bound.arguments[kw]))
        return plain(*args, **kwargs)
    monkeypatch.setattr(mod, name, counted)
    return flags


def _force_on(monkeypatch):
    """The old rule: the rows' cotangent whenever they require a gradient."""
    old = lambda ctx, i: bool(ctx.needs_input_grad[i])
    monkeypatch.setattr(ts, "_grad_wanted", old)
    monkeypatch.setattr(tpt, "_grad_wanted", old)
    monkeypatch.setattr(tp, "_grad_wanted", old)


def _step_grads(op, bucketed=False):
    """One force step at lr 0: the loss and the parameters' gradients."""
    if bucketed:
        batch = next(iter(BucketedMoleculeLoader(_mols(12, 0), {6: 2, 10: 2},
                                                 shuffle=False,
                                                 device="cpu")))
        model = SphereNet(**KW, **FLAGS["slot"], device="cpu",
                          generator=torch.Generator().manual_seed(0))
        step = make_bucketed_step_fns(
            model, torch.optim.SGD(model.parameters(), lr=0.0))[0]
    else:
        batch = _batch(op)
        model = _model(op, batch)
        step = make_step_fns(model, torch.optim.SGD(model.parameters(),
                                                    lr=0.0),
                             energy_and_force=True)[0]
    loss = step(batch)["loss"]
    return loss, [p.grad for p in model.parameters()]


@pytest.mark.parametrize("op,bucketed", [("pt", False), ("product", False),
                                         ("slot", False), ("slot", True),
                                         ("geom", False),
                                         ("slot_remat", False)])
def test_force_step_outer_pass_skips_rows_cotangent(monkeypatch, op,
                                                    bucketed):
    flags = _count_flags(monkeypatch, op)
    loss, grads = _step_grads(op, bucketed)
    calls = LAYERS * (2 if bucketed else 1)      # layers x buckets
    # the inner create_graph pass first, with the cotangent; the outer
    # pass (the energy term's backward) without it
    assert flags == [True] * calls + [False] * calls
    flags.clear()
    _force_on(monkeypatch)
    loss_on, grads_on = _step_grads(op, bucketed)
    assert flags == [True] * (2 * calls)
    assert torch.equal(loss, loss_on)
    assert len(grads) == len(grads_on)
    for g, g_on in zip(grads, grads_on):
        assert (g is None) == (g_on is None)
        if g is not None:
            assert torch.equal(g, g_on)


@pytest.mark.parametrize("op", ["pt", "product", "slot", "geom",
                                "slot_remat"])
def test_position_gradient_still_gets_rows_cotangent(monkeypatch, op):
    batch = _batch(op)
    model = _model(op, batch)
    flags = _count_flags(monkeypatch, op)
    # the inner pass of a force step, and an evaluation's
    for create_graph in (True, False):
        _, force = energy_force(model, batch, create_graph=create_graph)
        assert flags == [True] * LAYERS
        assert bool(torch.isfinite(force).all())
        assert float(force.detach().abs().max()) > 0.0
        flags.clear()
    # a plain backward (no inputs) reaches the positions too
    pos = batch.nodes["pos"].detach().requires_grad_()
    e = model(batch.replace_nodes(pos=pos))
    e.sum().backward()
    assert flags == [True] * LAYERS
    flags.clear()
    _force_on(monkeypatch)
    pos_on = batch.nodes["pos"].detach().requires_grad_()
    model.zero_grad()
    model(batch.replace_nodes(pos=pos_on)).sum().backward()
    assert flags == [True] * LAYERS
    assert torch.equal(pos.grad, pos_on.grad)
