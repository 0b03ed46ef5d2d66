"""``dig_tpu_torch.auggraph`` against ``dig_tpu.auggraph`` on the CPU, flax
weights carried across with ``dig_tpu_torch.convert.auggraph_from_flax``:

* ``sinkhorn`` (masked and not): the plan 1e-5, the scores' gradient 1e-4;
* ``_GIN``, ``MatchNet`` and ``RewardGMNet``: outputs 1e-5, every
  parameter's gradient 1e-4 of its largest value (float32; the GIN sums add
  in another order);
* one ``SMixup`` step at a fixed lambda: the loss 1e-5 and every gradient
  1e-4 (the JAX loss written out from the JAX method's own modules and
  ``sinkhorn``, as its ``train`` step computes it);
* ``Augmenter`` given the noise the JAX augmenter draws from its key (the
  test replays its ``jax.random`` calls): the masks exactly, the features
  1e-6, the log-prob 1e-5 and its gradient 1e-4;
* the three GraphAug runners and SMixup end to end on the CPU (one epoch
  each, finite, accuracies in [0, 1]).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.auggraph import graphaug as jga
from dig_tpu.auggraph import smixup as jsm
from dig_tpu.datasets.graphs import GraphClsLoader as JLoader
from dig_tpu.datasets.graphs import synthetic_graph_dataset
from dig_tpu_torch.auggraph import graphaug as tga
from dig_tpu_torch.auggraph import smixup as tsm
from dig_tpu_torch.convert import auggraph_from_flax

from test_torch_ssl import _flat, _rel, to_torch

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
H = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that parallel
    test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    data = synthetic_graph_dataset(10, seed=3)
    return (next(iter(JLoader(data[:5], 6))),
            next(iter(JLoader(data[5:], 6))))


def _check_grads(model, grads, make):
    want = auggraph_from_flax(_flat(grads), make())
    for (n, p), (_, q) in zip(model.named_parameters(),
                              want.named_parameters()):
        # no gradient reaches the keep heads through the masks: None here,
        # zeros in JAX
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel(got, q) < GRAD_TOL, n


@pytest.mark.parametrize("masked", [True, False])
def test_sinkhorn(masked):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(9, 7)).astype(np.float32)
    m = rng.random((9, 7)) < 0.6 if masked else None
    ct = rng.normal(size=(9, 7)).astype(np.float32)
    f = lambda x: jsm.sinkhorn(x, 6, None if m is None else jnp.asarray(m))

    @jax.jit
    def value_and_vjp(x, c):
        y, vjp = jax.vjp(f, x)
        return y, vjp(c)[0]
    want, want_grad = value_and_vjp(jnp.asarray(s), jnp.asarray(ct))
    x = torch.tensor(s, requires_grad=True)
    got = tsm.sinkhorn(x, 6, None if m is None else torch.tensor(m))
    assert _rel(got, want) < OUT_TOL
    got.backward(torch.tensor(ct))
    assert _rel(x.grad, want_grad) < GRAD_TOL


MODELS = {
    "gin": (lambda: jga._GIN(H), lambda: tga._GIN(8, H), 1),
    "match": (lambda: jsm.MatchNet(H), lambda: tsm.MatchNet(8, H), 2),
    "reward": (lambda: jga.RewardGMNet(H),
               lambda: tga.RewardGMNet(8, H, device="cpu"), 2),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_models_with_gradients(pair, name):
    jmk, tmk, n_in = MODELS[name]
    gs = pair[:n_in]
    jmod = jmk()
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), *gs)
    shapes = jax.eval_shape(jmod.apply, params, *gs)
    rng = np.random.default_rng(2)
    cts = [rng.normal(size=o.shape).astype(np.float32)
           for o in (shapes if isinstance(shapes, tuple) else (shapes,))]

    def f(p):
        o = jmod.apply(p, *gs)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * c) for a, c in zip(o, cts)), o
    (_, outs), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    model = auggraph_from_flax(_flat(params), tmk())
    got = model(*map(to_torch, gs))
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, outs):
        assert _rel(a, b) < OUT_TOL
    sum((a * torch.from_numpy(c)).sum() for a, c in zip(got, cts)).backward()
    _check_grads(model, grads, tmk)


def test_smixup_step_at_a_fixed_lambda(pair):
    g1, g2 = pair
    lam, n_cls = 0.3, 2
    js = jsm.SMixup(n_cls, H, sinkhorn_iters=4)
    params = {"match": jax.jit(js.matcher.init)(jax.random.PRNGKey(1), g1,
                                                g2),
              "cls": jax.jit(js.cls.init)(jax.random.PRNGKey(2), g1)}

    def loss_fn(p):          # SMixup.train's step (smixup.py)
        scores = js.matcher.apply(p["match"], g1, g2)
        pr = (g1.node_graph[:, None] == g2.node_graph[None, :])
        pr &= g1.node_mask[:, None] & g2.node_mask[None, :]
        plan = jsm.sinkhorn(scores, js.sinkhorn_iters, pr)
        x_mix = lam * g1.nodes["x"] + (1 - lam) * (plan @ g2.nodes["x"])
        logits = js.cls.apply(p["cls"], g1, x_mix)
        oh = lambda g: jax.nn.one_hot(g.globals["y"].astype(jnp.int32)
                                      .ravel(), n_cls)
        y_mix = lam * oh(g1) + (1 - lam) * oh(g2)
        ls = -jnp.sum(y_mix * jax.nn.log_softmax(logits, -1), -1)
        m = g1.graph_mask
        return jnp.sum(jnp.where(m, ls, 0.0)) / jnp.maximum(jnp.sum(m), 1)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    ts = tsm.SMixup(n_cls, H, sinkhorn_iters=4)
    ts.build(8, torch.Generator(), "cpu")
    auggraph_from_flax(_flat(params["match"]), ts.matcher)
    auggraph_from_flax(_flat(params["cls"]), ts.cls)
    got = ts.loss(to_torch(g1), to_torch(g2), lam)
    assert _rel(got, loss) < OUT_TOL
    got.backward()
    _check_grads(ts.matcher, grads["match"], lambda: tsm.MatchNet(8, H))
    _check_grads(ts.cls, grads["cls"], lambda: tga._Cls(8, H, n_cls))


def _replay_augmenter(aug, key, g):
    """The noise the JAX Augmenter draws from ``key`` on ``g``."""
    out = []
    for _ in range(aug.max_steps):
        key, k_cat, k_node, k_edge, k_feat = jax.random.split(key, 5)
        out.append({
            "u_cat": jax.random.uniform(k_cat, (g.num_graphs, 3),
                                        minval=1e-6, maxval=1 - 1e-6),
            "u_node": jax.random.uniform(k_node, (g.num_nodes,)),
            "u_edge": jax.random.uniform(k_edge, (g.num_edges,)),
            "z": jax.random.normal(k_feat, g.nodes["x"].shape)})
    return out


_JAUG = jga.Augmenter(H, max_steps=2, magnitude=0.6)
# the JAX augmenter's init, and its log-prob's value and gradient (the
# augmented batch as aux), jitted once for every seed
_JAUG_INIT = jax.jit(_JAUG.init)
_JAUG_VG = jax.jit(jax.value_and_grad(
    lambda p, key, g: _JAUG.apply(p, key, g)[::-1], has_aux=True))


@pytest.mark.parametrize("seed", [0, 5])
def test_augmenter_given_the_jax_draws(pair, seed):
    # features scaled down so that the category softmax is not saturated:
    # a saturated one's log-prob gradient is a difference of nearly equal
    # float32 values, as far from a float64 evaluation in JAX as here
    g = pair[0]
    g = g.replace_nodes(x=g.nodes["x"] * 0.1)
    jaug = _JAUG
    k0 = jax.random.PRNGKey(seed)
    params = _JAUG_INIT(k0, k0, g)
    key = jax.random.PRNGKey(seed + 100)
    (logp, g_aug), grads = _JAUG_VG(params, key, g)
    noise = [{k: torch.from_numpy(np.array(v)) for k, v in n.items()}
             for n in _replay_augmenter(jaug, key, g)]
    make = lambda: tga.Augmenter(8, H, 2, 0.6, device="cpu")
    aug = auggraph_from_flax(_flat(params), make())
    t_aug, t_logp = aug(to_torch(g), noise)
    for f in ("node_mask", "edge_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(g_aug, f)),
                                      getattr(t_aug, f).numpy())
    assert _rel(t_aug.nodes["x"], g_aug.nodes["x"]) < 1e-6
    assert not torch.equal(t_aug.node_mask, to_torch(g).node_mask) or \
        not torch.equal(t_aug.nodes["x"], to_torch(g).nodes["x"])
    assert _rel(t_logp, logp) < OUT_TOL
    t_logp.backward()
    _check_grads(aug, grads, make)


def test_runners_and_smixup_end_to_end():
    data = synthetic_graph_dataset(24, seed=4)
    rg = tga.RunnerRewardGen(H)
    rp = rg.train(data, 8, epochs=1, device="cpu")
    gen = tga.RunnerGenerator(H)
    ap = gen.train(data, rg.model, rp, 8, epochs=1, device="cpu")
    acc = tga.RunnerAugCls(2, H).train(data, gen.augmenter, ap, 8, epochs=1,
                                       device="cpu")
    assert 0.0 <= acc <= 1.0
    for p in (rp, ap):
        assert all(torch.isfinite(v).all() for v in p.values())
    sm = tsm.SMixup(2, H)
    params = sm.train(data, 8, epochs=1, device="cpu")
    assert all(torch.isfinite(v).all() for d in params.values()
               for v in d.values())
    assert 0.0 <= sm.evaluate(data, 8) <= 1.0
