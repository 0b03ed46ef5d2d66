"""``dig_tpu_torch.ggraph`` (GraphDF, GraphAF, GraphEBM, the PPO fine-tune)
against ``dig_tpu.ggraph`` on the CPU at ``tests/test_ggraph.py``'s widths
(max_size 9, edge_unroll 4, 2 flow layers, 2 RGCN layers, hidden 24), the
JAX weights carried across with ``dig_tpu_torch.convert``.

* the flow utilities' values 1e-6, the straight-through gradient 1e-4
  (softmax at temperature 0.1: exp rounds otherwise in each library); the
  mask schedule exactly; RGCN outputs 1e-5 of their largest value;
* GraphDF: the latents z exactly (one-hot argmaxes); the loss within 1e-6
  (relative; the sums of z * log p run in another order, so the last bit
  may differ); every parameter's gradient within 1e-4 of its largest
  value (float32; the straight-through softmax at temperature 0.1
  magnifies the RGCN's rounding); the running statistics after one step
  1e-5; ``reverse_node`` / ``reverse_edge`` exactly;
* two ``train_rand_gen`` steps from the JAX initial weights: the epoch's
  loss 1e-6; after two Adam steps every weight within 5% of one step's
  size (lr: Adam divides each gradient entry by its own running norm, so
  an entry's small relative error becomes a fraction of a step) and the
  running statistics within 1e-5; ``run_rand_gen`` from the same weights and seed:
  the same canonical hashes in order, the same first-try flags;
* GraphAF given the JAX dequantization draws (the test replays the JAX
  model's ``jax.random`` calls): loss 1e-5, gradients 1e-4; its Gaussian
  generation: the same hashes;
* GraphEBM: energies 1e-5, their gradients in the weights and in (x, adj)
  1e-4; a Langevin run given the JAX draws 1e-5; one training step given
  the JAX draws: loss 1e-5, weights after Adam(b1 = 0) as above;
* PPO: the rollouts' collated batch bit for bit from the same weights and
  numpy stream (the port's at the records' true counts, JAX's padded to
  its caps: the port's rows are JAX's first ones, JAX's rest are zeros); the PPO loss 1e-5 and its gradients 1e-4; the weights
  after the update as above, with ``warm_up`` 0 and 2 (two updates: the
  first scaled by 0); ``_shape_rewards`` and ``make_seed_canvas`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.chem import canonical_hash as j_hash
from dig_tpu.chem import mol_from_smiles as j_smiles
from dig_tpu.ggraph import DenseMolLoader as JLoader
from dig_tpu.ggraph import GraphAF as JGraphAF
from dig_tpu.ggraph import GraphDF as JGraphDF
from dig_tpu.ggraph import GraphEBM as JGraphEBM
from dig_tpu.ggraph import synthetic_smiles_dataset as j_synth
from dig_tpu.ggraph import rl as jrl
from dig_tpu.ggraph.models import flow_utils as jfu
from dig_tpu.ggraph.models.graphaf import GraphFlowModelAF as JAF
from dig_tpu.ggraph.models.graphdf import GraphFlowModelDF as JDF
from dig_tpu.ggraph.models.graphebm import EnergyFunc as JEnergy
from dig_tpu.ggraph.models.graphebm import langevin_sample as j_langevin
from dig_tpu.ggraph.models.rgcn import RGCN as JRGCN
from dig_tpu_torch.chem import canonical_hash
from dig_tpu_torch.chem import mol_from_smiles
from dig_tpu_torch.convert import (graphaf_from_flax, graphdf_from_flax,
                                   graphebm_from_flax)
from dig_tpu_torch.ggraph import DenseMolLoader, GraphAF, GraphDF, GraphEBM
from dig_tpu_torch.ggraph import rl as trl
from dig_tpu_torch.ggraph import synthetic_smiles_dataset
from dig_tpu_torch.ggraph.models import flow_utils as tfu
from dig_tpu_torch.ggraph.models.graphaf import GraphFlowModelAF
from dig_tpu_torch.ggraph.models.graphdf import GraphFlowModelDF
from dig_tpu_torch.ggraph.models.graphebm import (EnergyFunc, LangevinNoise,
                                                  langevin_sample)
from dig_tpu_torch.ggraph.models.rgcn import RGCN

CONF = dict(max_size=9, edge_unroll=4, node_dim=4, bond_dim=4,
            num_flow_layer=2, num_rgcn_layer=2, nhid=24, nout=24)
VAL_TOL, GRAD_TOL, STEP_TOL, LOSS_TOL = 1e-5, 1e-4, 0.05, 1e-6


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


def _same_weights(port, want, lr):
    """Every parameter of ``port`` after Adam steps at rate ``lr`` against
    the same entry of ``want`` (a port module made from the JAX tree),
    within STEP_TOL of one step's size; the buffers within VAL_TOL."""
    got, ref = port.state_dict(), want.state_dict()
    assert set(got) == set(ref)
    params = {k for k, _ in want.named_parameters()}
    for k in ref:
        if k in params:
            err = float((got[k] - ref[k]).abs().max()) / lr
            assert err < STEP_TOL, (k, err)
        else:
            assert _rel(got[k], ref[k]) < VAL_TOL, (k, _rel(got[k], ref[k]))


def _grads_vs(port, jgrads, convert, make, tol=GRAD_TOL):
    """Each parameter's gradient against the JAX gradient tree, laid out
    through the converter into a fresh module."""
    ref = convert({"params": jgrads, "batch_stats": _bs_like(port)}, make())
    got = dict(port.named_parameters())
    for k, p in ref.named_parameters():
        g = got[k].grad
        g = torch.zeros_like(p) if g is None else g
        assert _rel(g, p) < tol, (k, _rel(g, p))


def _bs_like(port):
    if not hasattr(port, "flow_core"):
        return {}
    bn = port.flow_core.bn
    return {"flow_core": {"bn": {"mean": bn.mean.numpy(),
                                 "var": bn.var.numpy()}}}


@pytest.fixture(scope="module")
def data():
    jds = j_synth(repeat=2)
    tds = synthetic_smiles_dataset(repeat=2)
    b = next(iter(JLoader(jds, 16, shuffle=True)))
    return {"jds": jds, "tds": tds, "x": b["x"], "adj": b["adj"]}


@pytest.fixture(scope="module")
def df_vars(data):
    return _np(jax.jit(JDF(**CONF).init)(
        jax.random.PRNGKey(0), jnp.asarray(data["x"]),
        jnp.asarray(data["adj"])))


def _df(v):
    return graphdf_from_flax(v, GraphFlowModelDF(**CONF))


def test_flow_utils():
    rng = np.random.default_rng(0)
    V = 5
    x = rng.random((7, V)).astype(np.float32)
    s = rng.random((7, V)).astype(np.float32)
    logits = rng.normal(size=(6, V)).astype(np.float32)
    w = rng.normal(size=(6, V)).astype(np.float32)
    jadd, jminus, (jout, jg) = jax.jit(lambda x, s, l: (
        jfu.one_hot_add(x, s), jfu.one_hot_minus(x, s),
        jax.value_and_grad(lambda l: jnp.sum(jfu.one_hot_argmax_st(l) * w))(
            l)))(x, s, logits)
    jhard = jax.jit(jfu.one_hot_argmax_st)(logits)
    for jv, tf in ((jadd, tfu.one_hot_add), (jminus, tfu.one_hot_minus)):
        assert _rel(tf(torch.tensor(x), torch.tensor(s)), jv) < 1e-6
    lt = torch.tensor(logits, requires_grad=True)
    out = tfu.one_hot_argmax_st(lt)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jhard))
    assert _rel(lt.grad, jg) < GRAD_TOL
    jm, tm = jfu.build_flow_masks(9, 4), tfu.build_flow_masks(9, 4)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rgcn(data):
    jr = JRGCN(24, 24, 3, 3)
    x, adj = jnp.asarray(data["x"]), jnp.asarray(data["adj"][:, :3])
    p = _np(jax.jit(jr.init)(jax.random.PRNGKey(1), x, adj))["params"]
    tr = RGCN(4, 24, 24, 3, 3)
    with torch.no_grad():
        tr.emb.weight.copy_(torch.tensor(p["Dense_0"]["kernel"]).T)
        for k, conv in enumerate(tr.convs):
            conv.weight.copy_(torch.tensor(p[f"RelGraphConv_{k}"]["weight"]))
    got = tr(torch.tensor(data["x"]), torch.tensor(data["adj"][:, :3]))
    assert _rel(got, jax.jit(jr.apply)({"params": p}, x, adj)) < VAL_TOL


def test_graphdf_loss_grads_stats(data, df_vars):
    jm = JDF(**CONF)
    x, adj = jnp.asarray(data["x"]), jnp.asarray(data["adj"])
    (jz, _), ((jloss, mut), jg) = jax.jit(lambda v: (
        jm.apply(v, x, adj, mutable=["batch_stats"]),
        jax.value_and_grad(lambda p: jm.apply(
            {**v, "params": p}, x, adj, method="loss",
            mutable=["batch_stats"]), has_aux=True)(v["params"])))(df_vars)
    tm = _df(df_vars).train()
    tx, tadj = torch.tensor(data["x"]), torch.tensor(data["adj"])
    with torch.no_grad():
        tz = tm(tx, tadj)
    tm.load_state_dict(_df(df_vars).state_dict())     # undo the stats' move
    loss = tm.loss(tx, tadj)
    loss.backward()
    for a, b in zip(tz, jz):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert _rel(loss, jloss) < LOSS_TOL
    _grads_vs(tm, _np(jg), graphdf_from_flax,
              lambda: GraphFlowModelDF(**CONF))
    bn = tm.flow_core.bn
    jbn = _np(mut)["batch_stats"]["flow_core"]["bn"]
    assert _rel(bn.mean, jbn["mean"]) < VAL_TOL
    assert _rel(bn.var, jbn["var"]) < VAL_TOL


def test_graphdf_reverse(data, df_vars):
    """The generation steps on a half-built canvas, running statistics."""
    jm = JDF(**CONF)
    x, adj = data["x"][:6].copy(), data["adj"][:6].copy()
    x[:, 5:] = 0.0
    adj[:, :, 5:] = 0.0
    adj[:, :, :, 5:] = 0.0
    rng = np.random.default_rng(2)
    lat_n = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    ei = np.stack([rng.integers(0, 5, 6), np.full(6, 5)], 1)
    tm = _df(df_vars).eval()
    t = torch.tensor
    np.testing.assert_array_equal(
        tm.reverse_node(t(x), t(adj), t(lat_n)).detach().numpy(),
        np.asarray(jax.jit(lambda v: jm.apply(
            v, x, adj, lat_n, method="reverse_node"))(df_vars)))
    np.testing.assert_array_equal(
        tm.reverse_edge(t(x), t(adj), t(lat_n), t(ei)).detach().numpy(),
        np.asarray(jax.jit(lambda v: jm.apply(
            v, x, adj, lat_n, jnp.asarray(ei, jnp.int32),
            method="reverse_edge"))(df_vars)))


@pytest.fixture(scope="module")
def trained_df(data, df_vars):
    """JAX's train_rand_gen, two steps (80 molecules in batches of 40),
    beside the port's from the same initial weights."""
    j = JGraphDF()
    jh = j.train_rand_gen(JLoader(data["jds"], 40, shuffle=True), lr=1e-3,
                          wd=0, max_epochs=1, model_conf_dict=CONF,
                          verbose=False)
    t = GraphDF()
    build = t.get_model      # start from the JAX initial weights

    def get_model(task, config, ckpt=None, device=None, seed=0):
        build(task, config, _df(df_vars).state_dict(), device, seed)
    t.get_model = get_model
    th = t.train_rand_gen(DenseMolLoader(data["tds"], 40, shuffle=True),
                          lr=1e-3, wd=0, max_epochs=1, model_conf_dict=CONF,
                          verbose=False, device="cpu")
    return j, jh, t, th


def test_graphdf_two_train_steps(data, trained_df):
    j, jh, t, th = trained_df
    assert len(data["jds"]) // 40 == 2
    assert abs(th[0] - jh[0]) <= LOSS_TOL * abs(jh[0])
    _same_weights(t.model, _df(_np(j.params)), 1e-3)


def _hashes(mols, h):
    return [h(m) if m is not None else None for m in mols]


def test_graphdf_run_rand_gen(trained_df):
    j, _, t, _ = trained_df
    jm, jp = j.run_rand_gen(n_mols=8, temperature=(0.6, 0.6), seed=1)
    tm, tp = t.run_rand_gen(n_mols=8, temperature=(0.6, 0.6), seed=1)
    assert _hashes(tm, canonical_hash) == _hashes(jm, j_hash)
    assert tp == jp


def _af_noise(key, x):
    """The JAX GraphFlowModelAF.__call__'s uniforms for key."""
    S = jfu.build_flow_masks(9, 4).num_edge_steps

    @jax.jit
    def draws(key):
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, x.shape),
                jax.random.uniform(k2, (x.shape[0], S, 4)))
    return tuple(np.asarray(a) for a in draws(key))


def test_graphaf_loss_and_generation(data):
    jm = JAF(**CONF)
    x, adj = jnp.asarray(data["x"]), jnp.asarray(data["adj"])
    key = jax.random.PRNGKey(3)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x, adj, key))
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({**v, "params": p}, x, adj, key, method="loss",
                           mutable=["batch_stats"]), has_aux=True))(
        v["params"])
    make = lambda: GraphFlowModelAF(**CONF)
    tm = graphaf_from_flax(v, make()).train()
    noise = tuple(torch.tensor(a) for a in _af_noise(key, data["x"]))
    loss = tm.loss(torch.tensor(data["x"]), torch.tensor(data["adj"]), noise)
    loss.backward()
    assert _rel(loss, jloss) < VAL_TOL
    _grads_vs(tm, _np(jg), graphaf_from_flax, make)
    ja, ta = JGraphAF(), GraphAF()
    ja.get_model("rand_gen", CONF, v)
    ta.get_model("rand_gen", CONF, graphaf_from_flax(v, make()).state_dict(),
                 device="cpu")
    jmols, jp = ja.run_rand_gen(n_mols=8, temperature=0.75, seed=2)
    tmols, tp = ta.run_rand_gen(n_mols=8, temperature=0.75, seed=2)
    assert _hashes(tmols, canonical_hash) == _hashes(jmols, j_hash)
    assert tp == jp


def _langevin_noise(key, shape_x, shape_adj, steps):
    """The draws of the JAX langevin_sample for key, replayed (its step
    keys' normals drawn at once: vmap over keys gives each key's draw)."""
    @jax.jit
    def draws(key):
        k0, k1, kloop = jax.random.split(key, 3)
        ks = jax.vmap(jax.random.split)(jax.random.split(kloop, steps))
        nx = jax.vmap(lambda k: jax.random.normal(k, shape_x))(ks[:, 0])
        na = jax.vmap(lambda k: jax.random.normal(k, shape_adj))(ks[:, 1])
        return (jax.random.uniform(k0, shape_x),
                jax.random.uniform(k1, shape_adj), nx, na)
    return LangevinNoise(*(torch.tensor(np.asarray(a)) for a in draws(key)))


def test_graphebm_energy_langevin_step(data):
    x, adj = data["x"][:4], data["adj"][:4]
    jx, jadj = jnp.asarray(x), jnp.asarray(adj)
    je = JEnergy(hidden=24, depth=1)
    v = _np(jax.jit(je.init)(jax.random.PRNGKey(0), jadj, jx))
    make = lambda: EnergyFunc(4, hidden=24, depth=1)
    te = graphebm_from_flax(v, make())
    # energies and their gradients in the weights and in (x, adj)
    tx = torch.tensor(x, requires_grad=True)
    tadj = torch.tensor(adj, requires_grad=True)
    out = te(tadj, tx)
    out.sum().backward()
    jout, (jgp, jgx, jga) = jax.jit(lambda p, a, b: (
        je.apply(p, a, b), jax.grad(lambda p, a, b: jnp.sum(je.apply(
            p, a, b)), argnums=(0, 1, 2))(p, a, b)))(v, jadj, jx)
    assert _rel(out, jout) < VAL_TOL
    assert _rel(tx.grad, jga) < GRAD_TOL and _rel(tadj.grad, jgx) < GRAD_TOL
    _grads_vs(te, _np(jgp)["params"], graphebm_from_flax, make)
    # JAX's train_rand_gen on one batch draws its step key as
    # split(PRNGKey(0))[1], and the step's Langevin run from its third part
    _, sk = jax.random.split(jax.random.PRNGKey(0))
    kd1, kd2, kl = jax.random.split(sk, 3)
    ld = _langevin_noise(kl, x.shape, adj.shape, 5)
    # a Langevin run given the JAX draws
    jn = jax.jit(lambda v, key: j_langevin(
        lambda p, a, b: je.apply(p, a, b), v, key, x.shape, adj.shape,
        ld_step=5))(v, kl)
    for a, b in zip(langevin_sample(te, ld), jn):
        assert _rel(a, b) < VAL_TOL
    # one train step given the JAX draws
    jeb = JGraphEBM(4, hidden=24, depth=1)
    batches = [{"x": x, "adj": adj}]
    jl = jeb.train_rand_gen(batches, lr=1e-3, max_epochs=1, c=0.2,
                            ld_step=5, verbose=False)
    teb = GraphEBM(4, hidden=24, depth=1)        # its init key: PRNGKey(0)
    teb.model = graphebm_from_flax(v, make())
    u = jax.jit(lambda a, b: (jax.random.uniform(a, x.shape),
                              jax.random.uniform(b, adj.shape)))(kd1, kd2)
    noise = (*(torch.tensor(np.asarray(t)) for t in u), ld)
    opt = torch.optim.Adam(teb.model.parameters(), 1e-3, betas=(0.0, 0.999))
    loss = teb.loss_of(torch.tensor(x), torch.tensor(adj), noise, c=0.2)
    loss.backward()
    opt.step()
    assert _rel(loss, jl[0]) < VAL_TOL
    _same_weights(teb.model, graphebm_from_flax(_np(jeb.params), make()),
                  1e-3)


def test_shape_rewards_and_seed_canvas():
    for R, decay, T in ((2.5, 0.9, 5), (-1.0, 0.5, 3)):
        jt, tt = jrl._Traj(), trl._Traj()
        for tr in (jt, tt):
            tr.nrew = [1.0, 2.0, 3.0]
            tr.erew = [1.0, -1.0, 2.0, 4.0]
        jrl._shape_rewards(jt, R, decay, T)
        trl._shape_rewards(tt, R, decay, T)
        assert (jt.nrew, jt.erew) == (tt.nrew, tt.erew)
    for s, keep in (("CC(=O)Oc1ccccc1C(=O)O", 5), ("c1ccncc1", 3)):
        jc = jrl.make_seed_canvas(j_smiles(s), keep, (6, 7, 8, 9), 12, 4, 4,
                                  4)
        tc = trl.make_seed_canvas(mol_from_smiles(s), keep, (6, 7, 8, 9), 12,
                                  4, 4, 4)
        np.testing.assert_array_equal(jc[0], tc[0])
        np.testing.assert_array_equal(jc[1], tc[1])
        assert j_hash(jc[2]) == canonical_hash(tc[2])
        assert jc[3:] == tc[3:]


_JIT = {}         # JAX functions jitted once for the module


def _j_ppo_grad(model, eps=0.2):
    """The gradient of the JAX PPOFineTuner's ppo_step loss_fn."""
    if "ppo_grad" in _JIT:
        return _JIT["ppo_grad"]

    def loss_fn(p, variables, batch):
        v = {**variables, "params": p}
        ll_n = model.apply(v, batch["nx"], batch["nadj"], batch["nact"],
                           batch["nstep"], method="rl_node_ll")
        ll_e = model.apply(v, batch["ex"], batch["eadj"], batch["eact"],
                           batch["eei"], batch["ecnt"], method="rl_edge_ll")
        out = 0.0
        for ll, old, adv, mask in ((ll_n, "nll_old", "nadv", "nmask"),
                                   (ll_e, "ell_old", "eadv", "emask")):
            r = jnp.exp(jnp.clip(ll - batch[old], -10.0, 10.0))
            surr = jnp.minimum(r * batch[adv],
                               jnp.clip(r, 1 - eps, 1 + eps) * batch[adv])
            out = out + jnp.sum(surr * batch[mask])
        total = (jnp.sum(batch["nmask"]) * batch["nact"].shape[-1]
                 + jnp.sum(batch["emask"]) * batch["eact"].shape[-1])
        return -(out / jnp.maximum(total, 1.0) - 1.0)
    _JIT["ppo_grad"] = jax.jit(
        lambda v, b: jax.grad(loss_fn)(v["params"], v, b))
    return _JIT["ppo_grad"]


@pytest.mark.parametrize("warm_up", [0, 2])
def test_ppo_step(trained_df, warm_up):
    j = trained_df[0]
    cfg = dict(property_type="plogp", batch_size=3, temperature=(0.8, 0.8),
               warm_up=warm_up)
    jt = jrl.PPOFineTuner(j.model, j.params, jrl.RLConfig(**cfg), lr=1e-3)
    # the rollout and likelihood functions do not depend on warm_up: one
    # jitted copy serves both cases
    for name in ("_rev_node", "_rev_edge", "_lls"):
        setattr(jt, name, _JIT.setdefault(name, getattr(jt, name)))
    seen = []
    orig = jt._ppo_step

    def spy(variables, opt_state, batch):
        out = orig(variables, opt_state, batch)
        seen.append((_np(batch), _np(variables), _np(out[0]), float(out[2])))
        return out
    jt._ppo_step = spy
    port = _df(_np(j.params))
    tt = trl.PPOFineTuner(port, trl.RLConfig(**cfg), lr=1e-3)
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    for it in range(2 if warm_up else 1):
        jt.step(it, jrng)
        jb, jv_before, jv_after, jloss = seen[-1]
        batch, *_ = tt.collect(it, trng)
        # the JAX tuner pads its records to static caps (mask 1 on the
        # records): the port's batch is JAX's first rows, none truncated
        n = {"n": int(jb["nmask"].sum()), "e": int(jb["emask"].sum())}
        assert (len(batch["nx"]), len(batch["ex"])) == (n["n"], n["e"])
        assert set(batch) == set(jb) - {"nll_old", "ell_old", "nmask",
                                        "emask"}
        for k in batch:
            np.testing.assert_array_equal(batch[k], jb[k][:n[k[0]]],
                                          err_msg=k)
            assert not jb[k][n[k[0]]:].any(), k
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            nll_old, ell_old = trl.rl_lls(tt.old_model, b)
        assert _rel(nll_old, jb["nll_old"][:n["n"]]) < VAL_TOL
        assert _rel(ell_old, jb["ell_old"][:n["e"]]) < VAL_TOL
        port.zero_grad()
        trl.ppo_loss(port, b, nll_old, ell_old, 0.2).backward()
        jg = _j_ppo_grad(j.model)(jv_before, jb)
        _grads_vs(port, _np(jg), graphdf_from_flax,
                  lambda: GraphFlowModelDF(**CONF))
        loss = tt.update(batch)
        assert abs(loss - jloss) <= VAL_TOL * max(abs(jloss), 1.0)
        _same_weights(port, _df(jv_after), 1e-3)
    if warm_up:      # the schedule starts at 0: the first update is zero
        first = [jax.tree.leaves(seen[0][k]["params"]) for k in (1, 2)]
        assert all(np.array_equal(a, b) for a, b in zip(*first))
