"""``dig_tpu_torch.ggraph3d`` against ``dig_tpu.ggraph3d`` on the CPU, the
flax weights carried across with ``dig_tpu_torch.convert``, at
``tests/test_modules_misc.py``'s widths (hidden 24, 2 flow layers, steps
of 8 a batch).

* ``steps_from_molecule``, ``collate_steps``, the loader's batches (the
  same shuffling stream) and the evaluators bit for bit;
* the batched placement against ``_place_atom_jnp`` (degenerate frames
  included) 1e-6 of the largest coordinate;
* ``SphereEncoder``, ``MaskedMHA`` (with a query whose graph has no valid
  key: a uniform softmax) and the four flows forward and reverse 1e-5 of
  their largest value (float32: the edge sums add in another order);
* ``SphGenModel.loss`` given the JAX dequantization noise (the test
  replays the JAX key's draw): loss 1e-5 (relative), every parameter's
  gradient 1e-4 of its largest value;
* two ``GSphereNet.train`` steps from the JAX initial weights and noise:
  the epoch's loss 1e-5, every weight within 5% of one step's size (lr:
  Adam divides each gradient entry by its own running norm);
* one ``generate`` batch from those weights given the JAX draws (latents,
  Gumbel noise, first types): the types and atom counts exactly, the
  positions within 1e-4 of the largest coordinate (float32 reverse flows
  and frames, carried through the placements).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.ggraph3d import QM93DGEN as JQM93DGEN
from dig_tpu.ggraph3d import GSphereNet as JGSphereNet
from dig_tpu.ggraph3d import dataset as jds
from dig_tpu.ggraph3d import evaluation as jev
from dig_tpu.ggraph3d.gspherenet import SphGenModel as JSphGen
from dig_tpu.ggraph3d.gspherenet import _place_atom_jnp
from dig_tpu_torch.convert import gspherenet_from_flax
from dig_tpu_torch.ggraph3d import QM93DGEN, GSphereNet
from dig_tpu_torch.ggraph3d import dataset as tds
from dig_tpu_torch.ggraph3d import evaluation as tev
from dig_tpu_torch.ggraph3d.gspherenet import SphGenModel, place_atom_batched

CONF = dict(num_node_types=4, hidden=24, num_flow_layers=2)
OUT_TOL, GRAD_TOL, STEP_TOL, POS_TOL = 1e-5, 1e-4, 0.05, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that parallel
    test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max(initial=0.0)
                 / max(np.abs(b).max(initial=0.0), 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _mols(n, seed):
    from dig_tpu.datasets.synthetic import synthetic_molecules
    mols = synthetic_molecules(n, seed=seed, min_atoms=4, max_atoms=7,
                               box=3.0)
    rng = np.random.default_rng(seed)
    for m in mols:
        m["z"] = rng.choice([6, 7, 8, 9], len(m["z"])).astype(np.int32)
    return mols


MOLS = _mols(6, 3)


@jax.jit
def _jinit(key, g, st):
    """The JAX model's initial variables (one compile for the module's
    fixtures: their batches share shapes)."""
    return JSphGen(**CONF).init(key, g, st, key, method="loss")


def _batch_eq(gt, gj):
    for f in ("senders", "receivers", "node_graph", "node_mask",
              "edge_mask", "graph_mask", "n_node", "n_edge"):
        a, b = getattr(gt, f).numpy(), np.asarray(getattr(gj, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for k in gj.nodes:
        assert np.array_equal(gt.nodes[k].numpy(), np.asarray(gj.nodes[k]))


def test_dataset_bit_for_bit():
    rng = np.random.default_rng(0)
    z = np.array([6, 6, 8, 7, 6, 9])
    pos = rng.normal(size=(6, 3)) * 1.2
    a = tds.steps_from_molecule(z, pos, [6, 7, 8, 9])
    b = jds.steps_from_molecule(z, pos, [6, 7, 8, 9])
    assert len(a) == len(b) == 5
    for sa, sb in zip(a, b):
        assert set(sa) == set(sb)
        for k in sb:
            assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
    td, jd = QM93DGEN(MOLS, 8), JQM93DGEN(MOLS, 8)
    assert td.n_node_pad == jd.n_node_pad and len(td.steps) == len(jd.steps)
    tl, jl = td.loader(seed=2), jd.loader(seed=2)
    assert len(tl) == len(jl) >= 2
    for _ in range(2):                      # two epochs: the stream goes on
        for (gt, st), (gj, sj) in zip(tl, jl):
            _batch_eq(gt, gj)
            for k in sj:
                assert sj[k].dtype == st[k].dtype
                assert np.array_equal(st[k], sj[k]), k


def test_evaluators_bit_for_bit():
    samples = [{"z": m["z"], "pos": m["pos"]} for m in _mols(5, 4)]
    ref = [{"z": m["z"], "pos": m["pos"]} for m in _mols(5, 5)]
    d = {"mol_dicts": samples, "ref_dicts": ref}
    assert tev.RandGenEvaluator3D().eval_validity(d) == \
        jev.RandGenEvaluator3D().eval_validity(d)
    assert tev.RandGenEvaluator3D().eval_bond_mmd(d) == \
        jev.RandGenEvaluator3D().eval_bond_mmd(d)
    a, b = tev.PropOptEvaluator3D().eval(d), jev.PropOptEvaluator3D().eval(d)
    assert a == b
    sa, sb = tev.bond_stats(samples), jev.bond_stats(samples)
    assert set(sa) == set(sb) and all(np.array_equal(sa[k], sb[k])
                                      for k in sb)
    rng = np.random.default_rng(0)
    x, y = rng.normal(0, 1, 50), rng.normal(1, 1, 40)
    assert tev.compute_mmd(x, y) == jev.compute_mmd(x, y)
    ma, mb = tev.mols_from_xyz(samples), jev.mols_from_xyz(samples)
    assert [(m.num_atoms, sorted(m.bonds)) for m in ma] == \
        [(m.num_atoms, sorted(m.bonds)) for m in mb]


def test_place_atom_batched():
    rng = np.random.default_rng(1)
    B = 12
    pf, p1, p2 = (rng.normal(size=(B, 3)).astype(np.float32)
                  for _ in range(3))
    p2[:3] = p1[:3] + (p1[:3] - pf[:3]) * 2.0    # collinear: normal 0
    p1[3] = pf[3] + np.array([1.0, 0, 0], np.float32)
    p2[3] = p1[3] + np.array([2.0, 0, 0], np.float32)  # on the x axis
    d, th, ph = (rng.uniform(0.5, 3.0, B).astype(np.float32)
                 for _ in range(3))
    got = place_atom_batched(*(torch.tensor(a) for a in (pf, p1, p2, d, th,
                                                          ph)))
    want = _place_atom_jnp(*(jnp.asarray(a) for a in (pf, p1, p2, d, th,
                                                      ph)))
    assert _rel(got, want) < 1e-6


@pytest.fixture(scope="module")
def model():
    """A batch of steps, the JAX model's variables and the port's model
    from them."""
    ds = JQM93DGEN(MOLS[:3], 8)
    g, st = next(iter(ds.loader(shuffle=False)))
    tg, tst = next(iter(QM93DGEN(MOLS[:3], 8).loader(shuffle=False)))
    jm = JSphGen(**CONF)
    v = _np(_jinit(jax.random.PRNGKey(0), g, st))
    tm = gspherenet_from_flax(v, SphGenModel(**CONF, device="cpu"))
    tst = {k: torch.as_tensor(a) for k, a in tst.items()}
    return {"jm": jm, "v": v, "tm": tm, "g": g, "st": st, "tg": tg,
            "tst": tst}


def test_encoder_attention_flows(model):
    jm, v, tm = model["jm"], model["v"], model["tm"]
    g, tg = model["g"], model["tg"]
    h_j = jax.jit(lambda v, g: jm.apply(v, g, method=lambda m, g:
                                        m.encoder(g)))(v, g)
    h_t = tm.encoder(tg)
    assert _rel(h_t, h_j) < OUT_TOL
    # queries: the first two in graph 0, the last in a graph that has no
    # valid key
    hv = np.asarray(h_j)
    q = hv[:3]
    qg = np.array([0, 0, 99], np.int32)
    a_j = jm.apply(v, jnp.asarray(q), jnp.asarray(hv), jnp.asarray(qg),
                   g.node_graph, g.node_mask,
                   method=lambda m, *a: m.node_att(*a))
    a_t = tm.node_att(torch.tensor(q), torch.tensor(hv), torch.tensor(qg),
                      tg.node_graph, tg.node_mask)
    assert np.isfinite(a_t.detach().numpy()).all()
    assert _rel(a_t, a_j) < OUT_TOL
    rng = np.random.default_rng(2)
    cond = rng.normal(size=(5, 2 * CONF["hidden"])).astype(np.float32)
    x = rng.normal(size=(5, 4)).astype(np.float32)

    def jflow(m, x, c, rev):
        from dig_tpu.ggraph3d.gspherenet import flow_forward, flow_reverse
        return (flow_reverse(m.node_flow, x, c) if rev
                else flow_forward(m.node_flow, x, c))
    from dig_tpu_torch.ggraph3d.gspherenet import flow_forward, flow_reverse
    zj, lj = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), False,
                      method=jflow)
    zt, lt = flow_forward(tm.node_flow, torch.tensor(x), torch.tensor(cond))
    assert _rel(zt, zj) < OUT_TOL and _rel(lt, lj) < OUT_TOL
    rj = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), True, method=jflow)
    rt = flow_reverse(tm.node_flow, torch.tensor(x), torch.tensor(cond))
    assert _rel(rt, rj) < OUT_TOL


def _noise(key, S):
    return np.asarray(jax.random.uniform(key, (S, CONF["num_node_types"])))


def test_loss_and_gradients(model):
    jm, v, tm = model["jm"], model["v"], model["tm"]
    key = jax.random.PRNGKey(5)
    (lj, auxj), gj = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, model["g"], model["st"], key, method="loss"),
        has_aux=True))(v)
    tm.zero_grad()
    lt, auxt = tm.loss(model["tg"], model["tst"],
                       torch.tensor(_noise(key, 8)))
    lt.backward()
    lt = lt.detach()
    assert abs(float(lt) - float(lj)) <= OUT_TOL * abs(float(lj))
    for k in auxj:
        assert abs(float(auxt[k].detach()) - float(auxj[k])) <= \
            OUT_TOL * max(abs(float(auxj[k])), 1.0), k
    ref = gspherenet_from_flax(_np(gj), SphGenModel(**CONF, device="cpu"))
    got = dict(tm.named_parameters())
    for k, p in ref.named_parameters():
        gk = got[k].grad
        gk = torch.zeros_like(p) if gk is None else gk
        assert _rel(gk, p) < GRAD_TOL, (k, _rel(gk, p))


@pytest.fixture(scope="module")
def trained():
    """JAX's train (one epoch of 2 steps of 8) beside the port's from the
    same initial weights and noise."""
    jds_, tds_ = JQM93DGEN(MOLS[:3], 8), QM93DGEN(MOLS[:3], 8)
    jgs = JGSphereNet(**CONF)
    jh = jgs.train(jds_.loader(), lr=1e-3, max_epochs=1, verbose=False)
    key = jax.random.PRNGKey(0)
    k0, key = jax.random.split(key)
    g0, st0 = next(iter(JQM93DGEN(MOLS[:3], 8).loader()))
    v0 = _np(_jinit(k0, g0, st0))
    noises = []
    for _ in range(len(jds_.loader())):
        key, k = jax.random.split(key)
        noises.append(torch.tensor(_noise(k, 8)))
    tgs = GSphereNet(**CONF)
    build = tgs.init_model

    def init_model(seed, device):
        m = gspherenet_from_flax(v0, build(seed, device))
        it = iter(noises)
        m.draw = lambda gen, S: next(it)
        return m
    tgs.init_model = init_model
    th = tgs.train(tds_.loader(), lr=1e-3, max_epochs=1, verbose=False,
                   device="cpu")
    return jgs, jh, tgs, th


def test_two_train_steps(trained):
    jgs, jh, tgs, th = trained
    assert len(JQM93DGEN(MOLS[:3], 8).loader()) == 2
    assert abs(th[0] - jh[0]) <= OUT_TOL * abs(jh[0])
    want = gspherenet_from_flax(_np(jgs.params),
                                SphGenModel(**CONF, device="cpu"))
    got = dict(tgs.model.named_parameters())
    for k, p in want.named_parameters():
        err = float((got[k] - p).detach().abs().max()) / 1e-3
        assert err < STEP_TOL, (k, err)


def _jax_draws(seed, B, T, pad, max_atoms, temperature):
    L = max_atoms - 1
    key = jax.random.PRNGKey(seed)
    key, k = jax.random.split(key)
    ks = jax.random.split(k, 5)
    t = temperature
    a = lambda x: torch.tensor(np.asarray(x))
    return {"lz": a(t[0] * jax.random.normal(ks[0], (L, B, T))),
            "ld": a(t[1] * jax.random.normal(ks[1], (L, B, 1))),
            "la": a(t[2] * jax.random.normal(ks[2], (L, B, 1))),
            "lt": a(t[3] * jax.random.normal(ks[3], (L, B, 1))),
            "gumbel": a(jax.random.gumbel(ks[4], (L, B, pad))),
            "first": a(jax.random.randint(jax.random.fold_in(k, 7), (B,), 0,
                                          T))}


def test_generate_batch(trained):
    jgs, _, tgs, _ = trained
    kw = dict(num_gen=6, max_atoms=7, seed=3, temperature=(0.7, 0.7, 0.7,
                                                           0.7),
              focus_th=0.5)
    js = jgs.generate([6, 7, 8, 9], **kw)
    # the port's model from the JAX weights after training (the two sets of
    # weights differ by Adam's rounding, up to STEP_TOL of a step)
    tgs.model = gspherenet_from_flax(_np(jgs.params),
                                     SphGenModel(**CONF, device="cpu"))
    tgs.draw_batch = lambda gen, B, T, pad, mx, temp: _jax_draws(
        gen.initial_seed(), B, T, pad, mx, temp)
    ts = tgs.generate([6, 7, 8, 9], **kw)
    assert [len(s["z"]) for s in ts] == [len(s["z"]) for s in js]
    assert len({len(s["z"]) for s in js}) > 1          # the stop test acts
    scale = max(np.abs(s["pos"]).max() for s in js)
    for a, b in zip(ts, js):
        assert np.array_equal(a["z"], b["z"])
        assert np.abs(a["pos"] - b["pos"]).max(initial=0.0) <= POS_TOL * scale
