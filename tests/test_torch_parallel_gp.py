"""The port's graph-parallel engine and models on 4 gloo ranks against the
JAX engine on 4 virtual CPU devices (the same partition, weights carried
across with ``convert.gp_model_from_flax``), computed in the pytest
process; one spawn (``torch_parallel_ranks.gp``) runs every case.

* 1-D ``data`` mesh, ``node_reg_loss``, Adam: GPGCN2 and GPPNA (hidden
  16, 2 layers, on a 96-node random graph): the forward partitioned 4
  ways and on one part against JAX's forward on one part (no halo) to
  1e-4 relative, and two steps train (the loss falls); the two steps'
  losses against JAX's 1-D engine to 1e-4 relative and the weights after
  them to 1e-4 relative + 5% of one Adam step, which holds the models'
  own backward (GCNII's residual mixing, PNA's max / min / std
  aggregations) to JAX's;
  GPSchNet (2 layers, width 16, on a 96-atom cloud): the forward before
  training (the port's ``predict_fn`` and first step's output against
  JAX's first step's output) and three steps' losses to 1e-4 relative,
  the weights after them to 1e-4 relative + 5% of one Adam step (lr
  1e-3). The port sums neighbours through the sorted-CSR sum
  (its plain version here), JAX with ``segment_sum``: the same sums in
  another order.
* 2-D ``(data, graph)`` mesh, 2 x 2: two data rows with disjoint halves
  of the train mask (GPGCN, ``node_class_loss``), against JAX's 2-D
  engine, as above; both rows' outputs equal.
* GPSchNet partitioned 4 ways against the same module on one part (each
  rank a replica row of a ``(4, 1)`` mesh): the forward to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from dig_tpu.lsgraph import synthetic_large_graph
from dig_tpu.parallel import make_gp_engine as j_engine
from dig_tpu.parallel import prepare_gp_graph as j_prepare
from dig_tpu.parallel import gp_models as jm
from dig_tpu.parallel.gp import node_class_loss as j_class
from dig_tpu.parallel.gp import node_reg_loss as j_reg
from dig_tpu.parallel.gp import slab_layout, unslab_layout
from dig_tpu_torch.convert import gp_model_from_flax
from dig_tpu_torch.parallel import gp_models as tm
from dig_tpu_torch.parallel import GPGraph, prepare_gp_graph, spawn_local

import torch_parallel_ranks as ranks

P = 4
LR = 1e-3


def _graph(seed=0, N=96, F=8):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, 400)
    r = rng.integers(0, N, 400)
    x = rng.normal(size=(N, F)).astype(np.float32)
    return s, r, x, N


def _cloud(N=96):
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 8.0, (N, 3)).astype(np.float32)
    z = rng.choice([1, 6, 7, 8], N).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    adj = (d < 3.0) & ~np.eye(N, dtype=bool)
    r_idx, s_idx = np.nonzero(adj)
    x = np.concatenate([z[:, None], pos], axis=1)
    y = (0.1 * z + 0.01 * d.sum(1)).astype(np.float32)
    return s_idx, r_idx, x, y, N


def _np_graph(g):
    """A JAX ``GPGraph`` as the port's (numpy), for the ranks."""
    return GPGraph(*(np.asarray(a) for a in g))


def _jax_case(mesh, module, g, H, C, x, y, mask, loss, steps,
              data_axis=None, axis="data"):
    """JAX's engine from PRNGKey(0): the initial variables, and a callable
    that takes ``steps`` Adam steps from them and returns ``(initial
    variables, variables after, the first step's output (the forward
    before any update), losses, the first step's output)``."""
    opt = optax.adam(LR)
    init, step, _ = j_engine(mesh, module, opt, H, C, loss_fn=loss,
                             axis=axis, data_axis=data_axis)
    params0 = jax.jit(init)(jax.random.PRNGKey(0), x, g)
    vars0 = jax.device_get(params0)

    def finish():
        params, st = params0, opt.init(params0)
        losses, outs = [], []
        for _ in range(steps):
            params, st, lo, out = step(params, st, g, x, y, mask)
            losses.append(float(lo))
            outs.append(np.asarray(out))
        return vars0, jax.device_get(params), outs[0], losses, outs[0]
    return vars0, finish


def _spec(model, kw, vars0, g, H, C, x, y, mask, loss, steps):
    return {"model": model, "kw": kw, "vars": vars0, "g": _np_graph(g),
            "H": H, "C": C, "x": np.asarray(x), "y": np.asarray(y),
            "mask": np.asarray(mask), "loss": loss, "lr": LR,
            "steps": steps}


def _single(model, kw, vars0, s, r, x, y, N, loss):
    """A case on one part, replicated on every rank of a (P, 1) mesh."""
    g1, perm1, H1, C1 = prepare_gp_graph(s, r, N, 1)
    rep = lambda a: np.stack([np.asarray(a)] * P)
    return _spec(model, kw, vars0, type(g1)(*map(rep, g1)), H1, C1,
                 rep(slab_layout(x, perm1, 1, C1)),
                 rep(slab_layout(y, perm1, 1, C1)),
                 rep(slab_layout(np.ones(N, bool), perm1, 1, C1)), loss,
                 1), perm1, (g1, H1, C1)


def _jax_single(module, g1, H1, C1, x1):
    """JAX's forward on one part (no halo rows), jitted with the part's
    tables closed over: the module's variables from PRNGKey(0) and its
    output."""
    from dig_tpu.parallel.gp import GPLocalGraph
    gl = GPLocalGraph(*(jnp.asarray(np.asarray(a)[0]) for a in g1[:5]),
                      num_local=C1)
    halo = lambda h: jnp.zeros((H1,) + h.shape[1:], h.dtype)
    x = jnp.asarray(x1)
    vars0 = jax.jit(lambda k: module.init(k, x, gl, halo))(
        jax.random.PRNGKey(0))
    out = jax.jit(lambda v: module.apply(v, x, gl, halo))(vars0)
    return jax.device_get(vars0), np.asarray(out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    devs = jax.devices()
    mesh = Mesh(np.array(devs[:P]), ("data",))
    want, one_d, single = {}, {}, {}
    s, r, x, N = _graph()
    g, perm, H, C = j_prepare(s, r, N, P)
    xs = slab_layout(x, perm, P, C)
    yv = np.random.default_rng(2).normal(size=N).astype(np.float32)
    y = slab_layout(yv, perm, P, C)
    m = slab_layout(np.ones(N, bool), perm, P, C)
    finish_1d = {}
    for name, jmod, kw in (
            ("gcn2", jm.GPGCN2(hidden=16, out_dim=3, num_layers=2),
             dict(in_dim=8, hidden=16, out_dim=3, num_layers=2)),
            ("pna", jm.GPPNA(hidden=16, out_dim=3, num_layers=2),
             dict(in_dim=8, hidden=16, out_dim=3, num_layers=2))):
        name_cls = type(jmod).__name__
        case1, perm1, (g1, H1, C1) = _single(name_cls, kw, None, s, r, x,
                                             yv, N, "reg")
        vars0, out1 = _jax_single(jmod, g1, H1, C1,
                                  slab_layout(x, perm1, 1, C1)[0])
        case1["vars"] = vars0
        single[name] = case1
        want[name] = (unslab_layout(out1[None], perm1), perm, perm1)
        vars_e, finish_1d[name] = _jax_case(
            mesh, jmod, g, H, C, jnp.asarray(xs), jnp.asarray(y),
            jnp.asarray(m), j_reg, 2)
        one_d[name] = _spec(name_cls, kw, vars_e, g, H, C, xs, y, m, "reg",
                            2)
        finish_1d[name] = (finish_1d[name], name_cls, kw)

    s, r, x, yv, N = _cloud()
    skw = dict(cutoff=3.0, num_layers=2, hidden_channels=16, num_filters=16,
               num_gaussians=8)
    g, perm, H, C = j_prepare(s, r, N, P)
    xs, ys = slab_layout(x, perm, P, C), slab_layout(yv, perm, P, C)
    m = slab_layout(np.ones(N, bool), perm, P, C)
    vars_s, finish_s = _jax_case(mesh, jm.GPSchNet(**skw), g, H, C,
                                 jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.asarray(m), j_reg, 3)
    want["schnet_perm"] = perm
    one_d["schnet"] = _spec("GPSchNet", skw, vars_s, g, H, C, xs, ys, m,
                            "reg", 3)
    single["schnet"], want["single_perm"], _ = _single(
        "GPSchNet", skw, vars_s, s, r, x, yv, N, "reg")

    data = synthetic_large_graph(200, seed=1)
    s, r, x, y = data["senders"], data["receivers"], data["x"], data["y"]
    N, P2 = len(y), 2
    g, perm, H, C = j_prepare(s, r, N, P2)
    tm_np = slab_layout(data["train_mask"], perm, P2, C)
    half = np.random.default_rng(0).uniform(size=tm_np.shape) < 0.5
    st = lambda a: np.stack([np.asarray(a)] * 2)
    g2 = type(g)(*map(lambda a: jnp.asarray(st(a)), g))
    xs2 = st(slab_layout(x, perm, P2, C))
    ys2 = st(slab_layout(y, perm, P2, C))
    m2 = np.stack([tm_np & half, tm_np & ~half])
    mesh2 = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "graph"))
    vars_2, finish_2 = _jax_case(mesh2, jm.GPGCN(features=(16, 4)), g2, H,
                                 C, jnp.asarray(xs2), jnp.asarray(ys2),
                                 jnp.asarray(m2), j_class, 1,
                                 data_axis="data", axis="graph")
    kw2 = dict(in_dim=x.shape[1], features=(16, 4))
    two_d = _spec("GPGCN", kw2, vars_2, g2, H, C, xs2, ys2, m2, "class", 1)

    # the ranks run while the JAX side takes its steps
    join = ranks.background(
        spawn_local, ranks.gp, P, str(tmp_path_factory.mktemp("gp")),
        ({"one_d": one_d, "two_d": two_d, "single": single},), timeout=120)
    want["schnet"] = finish_s() + ("GPSchNet", skw)
    for name, (finish, name_cls, kw) in finish_1d.items():
        want[f"{name}_steps"] = finish() + (name_cls, kw)
    want["two_d"] = finish_2() + ("GPGCN", kw2)
    return want, join()


def _weights(model_name, kw, vars_):
    mod = gp_model_from_flax(vars_, getattr(tm, model_name)(**kw))
    return {k: v.numpy() for k, v in mod.state_dict().items()}


def _check(res, want, slab_axis):
    vars0, params, pred, losses, out, name, kw = want
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
    w = _weights(name, kw, params)
    for k, v in w.items():
        tol = 1e-4 * np.abs(v).max() + 0.05 * LR
        assert np.abs(res["weights"][k] - v).max() <= tol, k
    return pred, out


@pytest.mark.parametrize("case", ["gcn2", "pna"])
def test_gp_forward_1d_matches_jax(run, case):
    """Partitioned 4 ways against one part, and one part against JAX's
    forward on one part; two steps train (the loss falls)."""
    want, got = run
    out1, perm, perm1 = want[case]
    parts = unslab_layout(np.stack([res[case]["pred"] for res in got]), perm)
    scale = np.abs(out1).max()
    np.testing.assert_allclose(parts, out1, rtol=1e-4, atol=1e-4 * scale)
    for res in got:
        single = unslab_layout(res[f"{case}_single"]["pred"][None], perm1)
        np.testing.assert_allclose(single, out1, rtol=1e-4,
                                   atol=1e-4 * scale)
        assert res[case]["losses"][-1] < res[case]["losses"][0]
        assert res[case]["losses"] == got[0][case]["losses"]


@pytest.mark.parametrize("case", ["gcn2", "pna"])
def test_gp_engine_1d_steps_match_jax(run, case):
    """The two Adam steps' losses and weights against JAX's 1-D engine
    from the same initial weights, and the first step's output."""
    want, got = run
    for p, res in enumerate(got):
        _, out = _check(res[case], want[f"{case}_steps"], 0)
        np.testing.assert_allclose(res[case]["out"], out[p], rtol=1e-4,
                                   atol=1e-4 * np.abs(out).max())


def test_gp_engine_1d_matches_jax(run):
    want, got = run
    case = "schnet"
    for p, res in enumerate(got):
        pred, out = _check(res[case], want[case], 0)
        scale = np.abs(pred).max()
        np.testing.assert_allclose(res[case]["pred"], pred[p], rtol=1e-4,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(res[case]["out"], out[p], rtol=1e-4,
                                   atol=1e-4 * np.abs(out).max())


def test_gp_engine_2d_matches_jax(run):
    want, got = run
    for rank, res in enumerate(got):
        d, p = divmod(rank, 2)
        pred, out = _check(res["two_d"], want["two_d"], 1)
        np.testing.assert_allclose(res["two_d"]["pred"], pred[d, p],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["two_d"]["out"], out[d, p],
                                   rtol=1e-4, atol=1e-5)
    for r in (0, 1):
        np.testing.assert_allclose(got[r]["two_d"]["out"],
                                   got[r + 2]["two_d"]["out"], rtol=1e-5,
                                   atol=1e-6)


def test_gp_schnet_partitioned_matches_single(run):
    want, got = run
    parts = np.stack([res["schnet"]["pred"] for res in got])
    partitioned = unslab_layout(parts, want["schnet_perm"])
    for res in got:
        single = unslab_layout(res["schnet_single"]["pred"][None],
                               want["single_perm"])
        np.testing.assert_allclose(partitioned, single, rtol=1e-4,
                                   atol=1e-4 * np.abs(single).max())
    assert got[0]["schnet"]["losses"][-1] < got[0]["schnet"]["losses"][0]
