"""``dig_tpu_torch.ssl`` against ``dig_tpu.ssl`` on the CPU, flax weights
carried across with ``dig_tpu_torch.convert``.

* encoders (GIN / GCN / ResGCN, batch norm and PReLU, sum and mean
  pooling, GCN with edge weights, ``DenseDiffusionEncoder``), on a batch
  with padding graphs and on a batch after JAX views (dropped nodes, edges
  written into free slots): outputs 1e-5 and every parameter's gradient
  1e-4 of its largest value (float32; the neighbour sums and poolings add
  in another order);
* every objective, values 1e-5 and input gradients 1e-4, with zero
  padding rows (their gradient must be finite);
* each view given the noise the JAX view draws from the same key (the
  test replays the JAX view's own ``jax.random`` calls): masks and edges
  exactly, features 1e-6; the views' invariants with the port's own
  draws, as ``tests/test_ssl.py`` checks them;
* ``Diffusion`` (PPR and heat) 1e-5; the adaptive centralities and drop
  weights 1e-5;
* two ``Contrastive.train`` steps with identity views (NCE: GraphCL; JSE:
  InfoGraph) from the JAX engine's initial weights: loss 1e-5, weights
  after two Adam steps 1e-5 of their largest value;
* ``_embed_dataset`` 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dig_tpu.datasets.graphs import GraphClsLoader as JLoader
from dig_tpu.datasets.graphs import synthetic_graph_dataset
from dig_tpu.ssl import adaptive as ja
from dig_tpu.ssl import contrastive as jc
from dig_tpu.ssl import encoders as je
from dig_tpu.ssl import evaluation as jev
from dig_tpu.ssl import methods as jm
from dig_tpu.ssl import objectives as jo
from dig_tpu.ssl import views as jv
from dig_tpu_torch.convert import (contrastive_from_flax, proj_head_from_flax,
                                   ssl_encoder_from_flax)
from dig_tpu_torch.datasets import GraphClsLoader
from dig_tpu_torch.graph import GraphBatch
from dig_tpu_torch.ssl import adaptive as ta
from dig_tpu_torch.ssl import encoders as te
from dig_tpu_torch.ssl import evaluation as tev
from dig_tpu_torch.ssl import methods as tm
from dig_tpu_torch.ssl import objectives as to
from dig_tpu_torch.ssl import views as tv

OUT_TOL, GRAD_TOL, VIEW_X_TOL = 1e-5, 1e-4, 1e-6


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


def _flat(p):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        p["params"], sep="/").items()}


def to_torch(g) -> GraphBatch:
    t = lambda v: torch.from_numpy(np.array(v))
    d = lambda m: {k: t(v) for k, v in m.items()}
    return GraphBatch(nodes=d(g.nodes), edges=d(g.edges), senders=t(g.senders),
                      receivers=t(g.receivers), globals=d(g.globals),
                      node_graph=t(g.node_graph), node_mask=t(g.node_mask),
                      edge_mask=t(g.edge_mask), graph_mask=t(g.graph_mask),
                      n_node=t(g.n_node), n_edge=t(g.n_edge))


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tt(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def batches():
    """6 graphs in 8 slots (2 padding graphs), and the same batch after
    JAX views: edges dropped and added into free slots, then nodes
    dropped."""
    data = synthetic_graph_dataset(6, seed=0)
    g = next(iter(JLoader(data, 8)))
    gv = jax.jit(jv.EdgePerturbation(add=True, drop=True, ratio=0.3))(
        jax.random.PRNGKey(3), g)
    gv = jax.jit(jv.UniformSample(0.25))(jax.random.PRNGKey(4), gv)
    return {"base": g, "viewed": gv}


ENC_CASES = {
    "gin_sum": dict(gnn="gin"),
    "gin_bn_prelu_mean": dict(gnn="gin", bn=True, act="prelu", pool="mean"),
    "gcn_bn_prelu": dict(gnn="gcn", bn=True, act="prelu"),
    "gcn_mean": dict(gnn="gcn", pool="mean"),
    "gcn_edge_weight": dict(gnn="gcn", edge_weight=True),
    "resgcn": dict(gnn="resgcn"),
    "resgcn_mean": dict(gnn="resgcn", pool="mean"),
}


def _encoder_pair(name):
    if name == "diffusion":
        return (jm.DenseDiffusionEncoder(16, 2),
                lambda: tm.DenseDiffusionEncoder(8, 16, 2, device="cpu"))
    kw = dict(feat_dim=8, hidden_dim=16, n_layers=3, node_level=True,
              graph_level=True, **ENC_CASES[name])
    return je.Encoder(**kw), lambda: te.Encoder(**kw, device="cpu")


_JAX_ENCODERS = {}


def _jax_encoder(name, g):
    """The JAX encoder's weights and its jitted value-and-gradient of
    ``sum(zg * ctg) + sum(zn * ctn)`` (outputs as aux), made once a case
    and shared by its batches (the same shapes: one compile)."""
    if name not in _JAX_ENCODERS:
        jenc, make = _encoder_pair(name)
        params = jax.jit(jenc.init)(jax.random.PRNGKey(0), g)

        def f(p, g, ctg, ctn):
            a, b = jenc.apply(p, g)
            return jnp.sum(a * ctg) + jnp.sum(b * ctn), (a, b)
        _JAX_ENCODERS[name] = (params, make, jax.jit(
            jax.value_and_grad(f, has_aux=True)))
    return _JAX_ENCODERS[name]


@pytest.mark.parametrize("name,which", [
    (n, "base") for n in list(ENC_CASES) + ["diffusion"]] + [
    (n, "viewed") for n in ("gin_bn_prelu_mean", "gcn_mean", "resgcn_mean",
                            "diffusion")])
def test_encoder_outputs_and_gradients(batches, name, which):
    g = batches[which]
    if name == "gcn_edge_weight":
        w = np.random.default_rng(5).uniform(0.5, 2.0, g.num_edges)
        g = g.replace_edges(w=jnp.asarray(w, jnp.float32))
    params, make, vg = _jax_encoder(name, g)
    rng = np.random.default_rng(1)
    zdim = 16 if name in ("resgcn", "resgcn_mean") else 16 * (
        2 if name == "diffusion" else 3)
    ctg = rng.normal(size=(g.num_graphs, zdim)).astype(np.float32)
    ctn = rng.normal(size=(g.num_nodes, 16)).astype(np.float32)
    (_, (zg, zn)), grads = vg(params, g, ctg, ctn)

    enc = ssl_encoder_from_flax(_flat(params), make())
    tzg, tzn = enc(to_torch(g))
    assert _rel(tzg, zg) < OUT_TOL and _rel(tzn, zn) < OUT_TOL
    ((tzg * torch.from_numpy(ctg)).sum()
     + (tzn * torch.from_numpy(ctn)).sum()).backward()
    want = ssl_encoder_from_flax(_flat(grads), make())
    for (n, p), (_, q) in zip(enc.named_parameters(),
                              want.named_parameters()):
        assert _rel(p.grad, q) < GRAD_TOL, n
    nm = to_torch(g).node_mask
    assert float(tzn.detach()[~nm].abs().sum()) == 0.0


def _obj_inputs():
    """Graph embeddings [8, 6] (graphs 6, 7 padding: zero rows), node
    embeddings [40, 6] (rows 33.. padding: zero), the node graph ids."""
    rng = np.random.default_rng(2)
    G, N, D = 8, 40, 6
    gm = np.arange(G) < 6
    nm = np.arange(N) < 33
    ng = np.minimum(np.arange(N) // 6, 5).astype(np.int32)
    ng[~nm] = G - 1
    z = lambda n, m: (rng.normal(size=(n, D)) * m[:, None]).astype(
        np.float32)
    arrs = [z(G, gm), z(G, gm), z(G, gm), z(N, nm), z(N, nm), z(N, nm),
            z(G, gm), z(N, nm)]
    return arrs, gm, nm, ng


OBJ_CASES = {
    "nt_xent": lambda m, a, gm, nm, ng: m.nt_xent(a[0], a[1], 0.5, True, gm),
    "nt_xent_plain": lambda m, a, gm, nm, ng: m.nt_xent(a[0], a[1], 0.2,
                                                        False),
    "intra_node_nce": lambda m, a, gm, nm, ng: m.intra_node_nce(
        a[3], a[4], 0.5, True, nm),
    "nce_nodes": lambda m, a, gm, nm, ng: m.nce_loss(None, [a[3], a[4]],
                                                     tau=0.4, node_mask=nm),
    "nce_three_views": lambda m, a, gm, nm, ng: m.nce_loss(
        [a[0], a[1], a[2]], graph_mask=gm,
        sigma=[[0, 1, 0], [0, 0, 1], [0, 0, 0]]),
    "jse_local_global": lambda m, a, gm, nm, ng: m.jse_local_global(
        a[0], a[3], ng, gm, nm),
    "jse_global_global": lambda m, a, gm, nm, ng: m.jse_global_global(
        a[0], a[1], gm),
    "jse_one_view": lambda m, a, gm, nm, ng: m.jse_loss([a[0]], [a[3]], ng,
                                                        graph_mask=gm,
                                                        node_mask=nm),
    "jse_two_views": lambda m, a, gm, nm, ng: m.jse_loss(
        [a[0], a[1]], [a[3], a[4]], ng, graph_mask=gm, node_mask=nm),
    "jse_three_views": lambda m, a, gm, nm, ng: m.jse_loss(
        [a[0], a[1], a[2]], [a[3], a[4], a[5]], ng, graph_mask=gm,
        node_mask=nm),
    "jse_graphs_three": lambda m, a, gm, nm, ng: m.jse_loss(
        [a[0], a[1], a[2]], graph_mask=gm),
    "jse_unmasked": lambda m, a, gm, nm, ng: m.jse_local_global(a[0], a[3],
                                                               ng),
    "neg_paired": lambda m, a, gm, nm, ng: m.jse_local_global_neg_paired(
        m_cat(m, a[0], a[6]), m_cat(m, a[3], a[7]), ng, gm, nm),
}


def m_cat(m, a, b):
    return jnp.concatenate([a, b]) if m is jo else torch.cat([a, b])


@pytest.mark.parametrize("name", list(OBJ_CASES))
def test_objectives(name):
    arrs, gm, nm, ng = _obj_inputs()
    fn = OBJ_CASES[name]
    jf = lambda *a: fn(jo, a, jnp.asarray(gm), jnp.asarray(nm),
                       jnp.asarray(ng))
    val, grads = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(arrs)))))(*map(jnp.asarray, arrs))
    xs = [torch.tensor(a, requires_grad=True) for a in arrs]
    out = fn(to, xs, torch.tensor(gm), torch.tensor(nm), torch.tensor(ng))
    assert _rel(out, val) < OUT_TOL
    out.backward()
    for i, (x, gj) in enumerate(zip(xs, grads)):
        got = torch.zeros_like(x) if x.grad is None else x.grad
        assert torch.isfinite(got).all()
        assert _rel(got, gj) < GRAD_TOL, i


# -- views ------------------------------------------------------------------

def _r_uniform(view, key, g):
    return {"scores": jax.random.uniform(key, (g.num_nodes,))}


def _r_rw(view, key, g):
    N, G = g.num_nodes, g.num_graphs
    steps = view.max_steps or max(int(N / max(G, 1)), 4)
    k_seed, k_walk = jax.random.split(key)
    walk = [jax.random.uniform(k, (N,))
            for k in jax.random.split(k_walk, steps)]
    return {"seed": jax.random.uniform(k_seed, (N,)), "walk": jnp.stack(walk)}


def _r_edge(view, key, g):
    k_drop, k_a, k_b = jax.random.split(key, 3)
    E, out = g.num_edges, {}
    if view.drop:
        out["keep_u"] = jax.random.uniform(k_drop, (E,))
    if view.add:
        logits = jnp.where(g.node_mask, 0.0, -jnp.inf)
        a = jax.random.categorical(k_a, logits, shape=(E,))
        # the port draws the endpoint as a uniform over the real nodes:
        # the uniform at the middle of a's rank among them picks a
        cnt = jnp.cumsum(g.node_mask.astype(jnp.int32))
        out["a_u"] = (cnt[a] - 0.5) / cnt[-1]
        out["off"] = jax.random.randint(k_b, (E,), 0, 1 << 30)
    return out


def _r_mask(view, key, g):
    k_sel, k_val = jax.random.split(key)
    shape = g.nodes["x"].shape
    if view.mode == "whole":
        out = {"scores": jax.random.uniform(k_sel, (g.num_nodes,))}
        if view.mask_std > 0:
            out["z"] = jax.random.normal(k_val, shape)
        return out
    return {"sel": jax.random.uniform(k_sel, shape),
            "z": jax.random.normal(k_val, shape)}


def _r_ada_edge(view, key, g):
    return {"u": jax.random.uniform(key, (g.num_edges,))}


def _r_ada_feat(view, key, g):
    return {"u": jax.random.uniform(key, g.nodes["x"].shape)}


REPLAY = {jv.UniformSample: _r_uniform, jv.RWSample: _r_rw,
          jv.EdgePerturbation: _r_edge, jv.NodeAttrMask: _r_mask,
          jv.DiffusionWithSample: _r_uniform,
          ja.AdaEdgePerturbation: _r_ada_edge,
          ja.AdaNodeAttrMask: _r_ada_feat}


def replay(view, key, g):
    """The noise the JAX ``view`` draws from ``key`` on ``g``."""
    if isinstance(view, jv.RandomView):
        k_pick, k_view = jax.random.split(key)
        return {"idx": jax.random.randint(k_pick, (), 0,
                                          len(view.candidates)),
                "views": [replay(c, k_view, g) for c in view.candidates]}
    if isinstance(view, jv.SequentialView):
        out = []
        for k, v in zip(jax.random.split(key, len(view.views)), view.views):
            out.append(replay(v, k, g))
            g = v(k, g)
        return out
    return REPLAY[type(view)](view, key, g)


def _pair(name, *a, **kw):
    mod = {"Ada": (ja, ta)}.get(name[:3], (jv, tv))
    return getattr(mod[0], name)(*a, **kw), getattr(mod[1], name)(*a, **kw)


def _random_pair():
    mk = lambda m: [m.UniformSample(0.25), m.RWSample(0.3),
                    m.EdgePerturbation(ratio=0.3),
                    m.NodeAttrMask(mask_ratio=0.3)]
    return jv.RandomView(mk(jv)), tv.RandomView(mk(tv))


def _sequential_pair():
    mk = lambda m: m.SequentialView([
        m.EdgePerturbation(add=False, drop=True, ratio=0.3),
        m.NodeAttrMask(mask_ratio=0.3)])
    return mk(jv), mk(tv)


VIEW_CASES = {
    "uniform": lambda: _pair("UniformSample", 0.25),
    "rw": lambda: _pair("RWSample", 0.5),
    "rw_steps": lambda: _pair("RWSample", 0.2, max_steps=3),
    "edge_add": lambda: _pair("EdgePerturbation", ratio=0.2),
    "edge_add_drop": lambda: _pair("EdgePerturbation", True, True, 0.3),
    "edge_drop": lambda: _pair("EdgePerturbation", False, True, 0.3),
    "mask_whole": lambda: _pair("NodeAttrMask", mask_ratio=0.3),
    "mask_const": lambda: _pair("NodeAttrMask", mask_ratio=0.5,
                                mask_mean=7.0, mask_std=0.0),
    "mask_partial": lambda: _pair("NodeAttrMask", "partial", 0.3),
    "sequential": _sequential_pair,
    "random": _random_pair,
    "diffusion_sample": lambda: _pair("DiffusionWithSample", 5),
    "ada_edge_degree": lambda: _pair("AdaEdgePerturbation", "degree"),
    "ada_edge_pr": lambda: _pair("AdaEdgePerturbation", "pr", 0.4),
    "ada_edge_evc": lambda: _pair("AdaEdgePerturbation", "evc"),
    "ada_feat_degree": lambda: _pair("AdaNodeAttrMask", "degree"),
    "ada_feat_pr_dense": lambda: _pair("AdaNodeAttrMask", "pr", 0.4,
                                       dense=True),
    "ada_feat_evc": lambda: _pair("AdaNodeAttrMask", "evc"),
}


def _same_batch(gj, gt):
    for f in ("node_mask", "edge_mask", "senders", "receivers"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, f)),
                                      getattr(gt, f).numpy(), err_msg=f)
    assert _rel(gt.nodes["x"], gj.nodes["x"]) < VIEW_X_TOL


@pytest.mark.parametrize("name", list(VIEW_CASES))
def test_views_given_the_jax_draws(batches, name):
    # keys 10, 12, 14 and 16 pick RandomView's candidates 0, 3, 2 and 1
    runs = ([("base", k) for k in (10, 12, 14, 16)] if name == "random"
            else [("base", 10), ("viewed", 11)])
    jview, tview = VIEW_CASES[name]()
    # the view and its replayed draws, one compile for every run
    jitted = jax.jit(lambda key, g: (jview(key, g), replay(jview, key, g)))
    for which, k in runs:
        g = batches[which]
        want, noise = jitted(jax.random.PRNGKey(k), g)
        got = tview.apply(to_torch(g), _tt(noise))
        if isinstance(want, tuple):
            assert _rel(got[1], want[1]) < OUT_TOL
            want, got = want[0], got[0]
        _same_batch(want, got)


def _kept(g):
    return te.pool_graphs(g.node_mask[:, None].float(), g, "sum")[:, 0]


def test_view_invariants_with_the_ports_draws(batches):
    """tests/test_ssl.py's checks of the JAX views, on the port's views
    with their own draws."""
    g = to_torch(batches["base"])
    gen = torch.Generator().manual_seed(0)
    g2 = tv.UniformSample(0.25)(gen, g)
    want = torch.floor(g.n_node.float() * 0.75)
    assert torch.equal(_kept(g2), want)
    em, nm = g2.edge_mask, g2.node_mask
    s, r = g2.senders.long(), g2.receivers.long()
    assert nm[s[em]].all() and nm[r[em]].all()

    g2 = tv.RWSample(0.5)(gen, g)
    kept = _kept(g2)[g.graph_mask]
    assert (kept >= 1).all() and (kept <= g.n_node[g.graph_mask]).all()

    g2 = tv.EdgePerturbation(add=True, drop=True, ratio=0.3)(gen, g)
    em = g2.edge_mask
    s, r = g2.senders.long()[em], g2.receivers.long()[em]
    assert torch.equal(g2.node_graph[s], g2.node_graph[r])
    assert g2.node_mask[s].all() and g2.node_mask[r].all()
    assert int(em.sum()) > int((g.edge_mask & g2.edge_mask).sum())

    g2 = tv.NodeAttrMask(mask_ratio=0.5, mask_std=0.0, mask_mean=7.0)(gen, g)
    n_masked = int(((g2.nodes["x"] == 7.0).all(1) & g.node_mask).sum())
    assert n_masked == int(torch.floor(g.n_node.float() * 0.5).sum())

    for mode in ("ppr", "heat"):
        _, S = tv.Diffusion(mode)(gen, g)
        ng, nm = g.node_graph, g.node_mask
        cross = (ng[:, None] != ng[None, :]) | ~nm[:, None] | ~nm[None, :]
        assert float(S[cross].abs().max()) == 0.0
        assert torch.isfinite(S).all()


@pytest.mark.parametrize("mode", ["ppr", "heat"])
def test_diffusion(batches, mode):
    jitted = jax.jit(lambda g: jv.Diffusion(mode, alpha=0.15, t=3.0)(None, g))
    for g in batches.values():
        _, want = jitted(g)
        _, got = tv.Diffusion(mode, alpha=0.15, t=3.0)(None, to_torch(g))
        assert _rel(got, want) < OUT_TOL


ADAPTIVE = {
    "degree": lambda m, g: m.degree_centrality(g),
    "pr": lambda m, g: m.compute_pr(g),
    "pr_k3": lambda m, g: m.compute_pr(g, damp=0.7, k=3),
    "evc": lambda m, g: m.eigenvector_centrality(g),
    "degree_w": lambda m, g: m.degree_drop_weights(g),
    "pr_sink": lambda m, g: m.pr_drop_weights(g),
    "pr_source": lambda m, g: m.pr_drop_weights(g, "source"),
    "pr_mean": lambda m, g: m.pr_drop_weights(g, "mean"),
    "evc_w": lambda m, g: m.evc_drop_weights(g),
    "feat": lambda m, g: m.feature_drop_weights(g, m.compute_pr(g)),
    "feat_dense": lambda m, g: m.feature_drop_weights(
        g, m.degree_centrality(g) + 1.0, dense=True),
}


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_adaptive_weights(batches, name):
    jitted = jax.jit(lambda g: ADAPTIVE[name](ja, g))
    for g in batches.values():
        want = jitted(g)
        got = ADAPTIVE[name](ta, to_torch(g))
        assert _rel(got, want) < OUT_TOL


# -- the engine -------------------------------------------------------------

def _engines(kind):
    if kind == "NCE":
        kw = dict(feat_dim=8, hidden_dim=16, n_layers=2, gnn="gin")
        return (jm.GraphCL(32), je.Encoder(**kw), tm.GraphCL(32),
                te.Encoder(**kw, device="cpu"))
    # no batch norm after the convs here: their biases' gradients are 0
    # but for rounding, which Adam's first step scales up to +-lr
    kw = dict(feat_dim=8, hidden_dim=16, n_layers=2, gnn="gcn", pool="mean",
              node_level=True)
    return (jm.InfoGraph(32, 16), je.Encoder(**kw), tm.InfoGraph(32, 16),
            te.Encoder(**kw, device="cpu"))


@pytest.mark.parametrize("kind", ["NCE", "JSE"])
def test_two_contrastive_steps(kind, monkeypatch):
    """One epoch of two batches, identity views: the JAX engine's scan of
    two steps against the port's loop, from the JAX engine's initial
    weights (its key schedule replayed; the port's ``make_heads`` made to
    return the JAX heads)."""
    data = synthetic_graph_dataset(16, seed=1)
    jmeth, jenc, tmeth, tenc = _engines(kind)
    jl, tl = JLoader(data, 8), GraphClsLoader(data, 8)
    key = jax.random.PRNGKey(jmeth.seed)
    key, *iks = jax.random.split(key, 4)
    g0 = next(iter(jl))
    out = jmeth.z_n_dim if jmeth.z_n_dim is not None else jmeth.z_dim
    init = {"enc": [_flat(jax.jit(jenc.init)(iks[0], g0))], "pg": None,
            "pn": None}
    if jmeth.graph_level and jmeth.proj:
        init["pg"] = _flat(jc.ProjHead(out, jmeth.proj).init(
            iks[1], jnp.zeros((1, jmeth.z_dim))))
    if jmeth.node_level and jmeth.proj_n:
        init["pn"] = _flat(jc.ProjHead(out, jmeth.proj_n).init(
            iks[2], jnp.zeros((1, out))))
    heads = tmeth.make_heads(torch.Generator(), "cpu")
    contrastive_from_flax(init, [tenc], heads)
    monkeypatch.setattr(tmeth, "make_heads", lambda *a, **k: heads)

    want = list(jmeth.train(jenc, jl, epochs=1))[-1]
    got = list(tmeth.train(tenc, tl, epochs=1, device="cpu"))[-1]
    assert abs(got["loss"] - want["loss"]) <= OUT_TOL * abs(want["loss"])
    ref = ssl_encoder_from_flax(
        _flat(want["encoder_params"][0]),
        _engines(kind)[3])
    for n, p in ref.state_dict().items():
        assert _rel(got["encoder_params"][0][n], p) < OUT_TOL, n
    for k in ("pg", "pn"):
        if want["proj_params"][k] is not None:
            h = proj_head_from_flax(_flat(want["proj_params"][k]),
                                    type(tmeth).make_heads(
                                        tmeth, torch.Generator(), "cpu")[k])
            for n, p in h.state_dict().items():
                assert _rel(got["proj_params"][k][n], p) < OUT_TOL, (k, n)
    zg = got["apply"](next(iter(tl)))
    zg = zg[0] if isinstance(zg, tuple) else zg
    assert zg.shape[0] == 8 and torch.isfinite(zg).all()


def test_embed_dataset():
    data = synthetic_graph_dataset(13, seed=2)
    kw = dict(feat_dim=8, hidden_dim=16, n_layers=3, gnn="gin", bn=True)
    jenc = je.Encoder(**kw)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(4),
                                next(iter(JLoader(data, 5))))
    zj, yj = jev._embed_dataset(jenc, params, JLoader(data, 5))
    enc = ssl_encoder_from_flax(_flat(params), te.Encoder(**kw,
                                                          device="cpu"))
    z, y = tev._embed_dataset(enc, None, GraphClsLoader(data, 5), "cpu")
    assert z.shape == (13, 48)
    np.testing.assert_array_equal(y, yj)
    assert _rel(z, zj) < OUT_TOL
    z2, _ = tev._embed_dataset(enc, enc.state_dict(),
                               GraphClsLoader(data, 5), "cpu")
    np.testing.assert_array_equal(z, z2)
