"""``dig_tpu_torch.xgraph`` against ``dig_tpu.xgraph`` on the CPU, the flax
weights carried across with ``dig_tpu_torch.convert``, on
``synthetic_graph_dataset`` graphs (8-16 nodes, 8 features, hidden 16).

* the datasets (BA-shapes, BA-community, tree-cycle, tree-grid, BA-LRP,
  BA-2Motifs, the node-task batch) bit for bit; the molecule CSV and
  SentiGraph readers on ``tmp_path`` fixtures bit for bit;
* ``GNNModel`` (GCN / GIN, graph and node level, the sum, mean and max
  readouts) with ``edge_weight`` None, one tensor and a per-layer list:
  logits and every activation 1e-5 of their largest value (float32: the
  neighbour sums add in another order);
* the logit's derivatives in ``edge_weight``: the gradient, a Hessian-
  vector product (2 layers) and a third directional derivative (3 layers),
  1e-4 of their largest value;
* two ``train_gnn`` steps (and two ``train_gnn_node`` epochs) from the JAX
  initial weights: every weight within 5% of one step's size (lr: Adam
  divides each gradient entry by its own running norm, so an entry's small
  relative error becomes a fraction of a step), the accuracy the same;
  the cosine schedule 1e-7 (relative);
* ``GNNExplainer.explain`` over 10 epochs from the JAX initial masks (the
  test replays the JAX keys' draws): the masks 2e-4; ``explain_batch``
  against ``explain`` per graph 2e-4 (``tests/test_xgraph.py``'s bound);
* GradCAM, GNN-GI, DeepLIFT and GNN-LRP (2 layers, and 3 on a graph of
  14 edges) scores 1e-4 of their largest value; FlowX (the numpy stream)
  1e-5 (its scores are means of differences of probabilities);
* one PGExplainer step from the JAX scorer's initial weights and
  uniforms: its weights as for ``train_gnn``, the edge logits after it
  1e-4 (relative);
* ``score_coalitions`` (five methods) and the sequential estimators 1e-5
  (probabilities); ``SubgraphX.explain`` the same coalition;
* ``eval_related_pred``, ``XCollector``, ``fidelity`` 1e-5;
  ``control_sparsity`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.datasets.graphs import GraphClsLoader as JLoader
from dig_tpu.datasets.graphs import synthetic_graph_dataset
from dig_tpu.xgraph import datasets as jd
from dig_tpu.xgraph import gradient as jg
from dig_tpu.xgraph import metrics as jmet
from dig_tpu.xgraph import model_manager as jmm
from dig_tpu.xgraph import models as jmod
from dig_tpu.xgraph import shapley as jsh
from dig_tpu.xgraph.gnnexplainer import GNNExplainer as JGNNExplainer
from dig_tpu.xgraph.pgexplainer import PGExplainer as JPGExplainer
from dig_tpu.xgraph.subgraphx import SubgraphX as JSubgraphX
from dig_tpu_torch.convert import pgexplainer_from_flax, xgraph_from_flax
from dig_tpu_torch.datasets import GraphClsLoader
from dig_tpu_torch.xgraph import datasets as td
from dig_tpu_torch.xgraph import gradient as tg
from dig_tpu_torch.xgraph import metrics as tmet
from dig_tpu_torch.xgraph import model_manager as tmm
from dig_tpu_torch.xgraph import models as tmod
from dig_tpu_torch.xgraph import shapley as tsh
from dig_tpu_torch.xgraph.base import ExplainerBase, disjoint_union
from dig_tpu_torch.xgraph.gnnexplainer import GNNExplainer
from dig_tpu_torch.xgraph.pgexplainer import PGExplainer
from dig_tpu_torch.xgraph.subgraphx import SubgraphX

OUT_TOL, GRAD_TOL, STEP_TOL, MASK_TOL, PROB_TOL = 1e-5, 1e-4, 0.05, 2e-4, 1e-5


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
    fin = np.isfinite(b)
    assert np.array_equal(fin, np.isfinite(a)) and np.array_equal(
        a[~fin], b[~fin])
    return float(np.abs(a[fin] - b[fin]).max(initial=0.0)
                 / max(np.abs(b[fin]).max(initial=0.0), 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


DATA = synthetic_graph_dataset(8, seed=0, feat_dim=8)


@pytest.fixture(scope="module")
def graphs():
    """A batch of 4 graphs plus one padding slot's worth of room (5 slots),
    and single-graph batches, in both packages."""
    return {"jb": next(iter(JLoader(DATA[:4], 5))),
            "tb": next(iter(GraphClsLoader(DATA[:4], 5))),
            "j1": [next(iter(JLoader([d], 1))) for d in DATA],
            "t1": [next(iter(GraphClsLoader([d], 1))) for d in DATA]}


def _pair(make_j, make_t, g_j):
    jm = make_j()
    v = _np(jm.init(jax.random.PRNGKey(0), g_j))
    return jm, v, xgraph_from_flax(v, make_t())


CASES = {
    "gcn_graph_mean": dict(gnn="gcn", model_level="graph", readout="mean"),
    "gcn_graph_sum": dict(gnn="gcn", model_level="graph", readout="sum"),
    "gcn_graph_max": dict(gnn="gcn", model_level="graph", readout="max"),
    "gin_graph_sum": dict(gnn="gin", model_level="graph", readout="sum"),
    "gcn_node": dict(gnn="gcn", model_level="node"),
    "gin_node": dict(gnn="gin", model_level="node"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_models_logits_and_activations(graphs, case):
    kw = dict(num_layers=2, hidden_dim=16, num_classes=3, **CASES[case])
    jm, v, tm = _pair(lambda: jmod.GNNModel(**kw),
                      lambda: tmod.GNNModel(**kw), graphs["jb"])
    gj, gt = graphs["jb"], graphs["tb"]
    E = gj.num_edges
    rng = np.random.default_rng(1)
    w = [rng.uniform(0.2, 1.0, E).astype(np.float32) for _ in range(2)]
    for ew_j, ew_t in ((None, None), (w[0], torch.tensor(w[0])),
                       ([w[0], w[1]], [torch.tensor(a) for a in w])):
        lj, aj = jm.apply(v, gj, None if ew_j is None else (
            [jnp.asarray(a) for a in ew_j] if isinstance(ew_j, list)
            else jnp.asarray(ew_j)), return_activations=True)
        lt, at = tm(gt, ew_t, return_activations=True)
        assert _rel(lt, lj) < OUT_TOL
        assert len(at) == len(aj) == 3
        for a, b in zip(at, aj):
            assert _rel(a, b) < OUT_TOL


def _derivs_t(tm, g, E, row, cls, order, u, vv):
    """The port's gradient, Hessian-vector product and third directional
    derivative of logits[row, cls] in one shared edge weight."""
    w = torch.ones(E, requires_grad=True)
    f = tm(g, w)[row, cls]
    (g1,) = torch.autograd.grad(f, w, create_graph=True)
    out = [g1]
    if order >= 2:
        (g2,) = torch.autograd.grad(g1 @ torch.tensor(u), w,
                                    create_graph=True)
        out.append(g2)
    if order >= 3:
        (g3,) = torch.autograd.grad(g2 @ torch.tensor(vv), w)
        out.append(g3)
    return out


@pytest.mark.parametrize("gnn,layers", [("gcn", 2), ("gin", 2), ("gcn", 3),
                                        ("gin", 3)])
def test_edge_weight_derivatives(graphs, gnn, layers):
    kw = dict(gnn=gnn, num_layers=layers, hidden_dim=16, num_classes=2,
              readout="sum")
    jm, v, tm = _pair(lambda: jmod.GNNModel(**kw),
                      lambda: tmod.GNNModel(**kw), graphs["jb"])
    gj, gt = graphs["jb"], graphs["tb"]
    E = gj.num_edges
    rng = np.random.default_rng(2)
    u = rng.normal(size=E).astype(np.float32)
    vv = rng.normal(size=E).astype(np.float32)
    row, cls = 1, 1
    f = lambda w: jm.apply(v, gj, w)[row, cls]
    g1 = jax.grad(f)
    hvp = lambda w: jax.grad(lambda w: g1(w) @ u)(w)
    d3 = lambda w: jax.grad(lambda w: hvp(w) @ vv)(w)
    ones = jnp.ones(E)
    want = [g1(ones), hvp(ones)] + ([d3(ones)] if layers == 3 else [])
    got = _derivs_t(tm, gt, E, row, cls, len(want), u, vv)
    for k, (a, b) in enumerate(zip(got, want)):
        assert float(np.abs(np.asarray(b)).max()) > 0, k
        assert _rel(a, b) < GRAD_TOL, (k, _rel(a, b))


def test_cosine_schedule():
    import optax
    sched = optax.cosine_decay_schedule(5e-3, 7)
    for t in range(9):
        assert abs(tmm.cosine_decay(5e-3, 7, t) - float(sched(t))) <= \
            1e-7 * 5e-3


def _same_params(port, want, lr):
    got = dict(port.named_parameters())
    for k, p in want.named_parameters():
        err = float((got[k] - p).detach().abs().max()) / lr
        assert err < STEP_TOL, (k, err)


def test_train_gnn_two_steps():
    """JAX's train_gnn, one epoch of 8 graphs in batches of 4 (two steps,
    the second at half the rate), beside the port's from the same initial
    weights."""
    jm = jmod.GCN_2l(dim_hidden=16)
    jp, jacc = jmm.train_gnn(jm, DATA, epochs=1, batch_size=4, restarts=1)
    g0 = next(iter(JLoader(DATA, 4, shuffle=True, seed=0)))
    v0 = _np(jm.init(jax.random.PRNGKey(0), g0))
    tm = tmod.GCN_2l(dim_hidden=16)
    tm.init = lambda g, seed: xgraph_from_flax(v0, tm)
    tp, tacc = tmm.train_gnn(tm, DATA, epochs=1, batch_size=4, restarts=1,
                             device="cpu")
    assert tacc == jacc
    _same_params(tm, xgraph_from_flax(_np(jp), tmod.GCN_2l(dim_hidden=16)),
                 5e-3)
    assert set(tp) == set(tm.state_dict())


def test_train_gnn_node_two_epochs():
    data = jd.ba_shapes(num_base=30, num_motifs=4, m=2, seed=0)
    jm = jmod.GCN_2l(model_level="node", dim_hidden=8, num_classes=4)
    jp, jacc = jmm.train_gnn_node(jm, data, epochs=2, restarts=1)
    v0 = _np(jm.init(jax.random.PRNGKey(0), jd.node_task_batch(data)))
    tm = tmod.GCN_2l(model_level="node", dim_hidden=8, num_classes=4)
    tm.init = lambda g, seed: xgraph_from_flax(v0, tm)
    _, tacc = tmm.train_gnn_node(tm, data, epochs=2, restarts=1,
                                 device="cpu")
    assert tacc == jacc
    ref = xgraph_from_flax(_np(jp), tmod.GCN_2l(model_level="node",
                                                dim_hidden=8, num_classes=4))
    _same_params(tm, ref, 1e-2)


@pytest.fixture(scope="module")
def trained(graphs):
    """A GCN_2l (hidden 16) from the JAX initial weights, in both
    packages (the explainers need no trained model to be compared)."""
    jm = jmod.GCN_2l(dim_hidden=16)
    v = _np(jm.init(jax.random.PRNGKey(0), graphs["j1"][0]))
    return jm, v, xgraph_from_flax(v, tmod.GCN_2l(dim_hidden=16))


def _jax_masks(seed, E, F):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (torch.tensor(np.asarray(3.0 + 0.1 * jax.random.normal(k1, (E,)))),
            torch.tensor(np.asarray(3.0 + 0.1 * jax.random.normal(k2, (F,)))))


def test_gnnexplainer_explain_and_batch(trained):
    """Three graphs of the same pads (one loader, so one JAX compile):
    each graph's ``explain`` against JAX's from the same initial masks,
    then the port's ``explain_batch`` against its ``explain`` per graph
    (``tests/test_xgraph.py`` holds JAX's ``explain_batch`` to its
    ``explain``)."""
    jm, v, tm = trained
    jex = JGNNExplainer(jm, v, epochs=10, lr=0.05)
    tex = GNNExplainer(tm, epochs=10, lr=0.05)
    tex.draw = lambda gen, E, F: _jax_masks(gen.initial_seed(), E, F)
    labels = [int(d["y"]) for d in DATA[:3]]
    jgs = list(JLoader(DATA[:3], 1, n_node_pad=16, n_edge_pad=160))
    tgs = list(GraphClsLoader(DATA[:3], 1, n_node_pad=16, n_edge_pad=160))
    tb = tex.explain_batch(tgs, labels, seed=0)
    for b in range(3):
        ej, fj = jex.explain(jgs[b], target_label=labels[b], seed=b)
        et, ft = tex.explain(tgs[b], target_label=labels[b], seed=b)
        assert np.allclose(et, ej, rtol=0, atol=MASK_TOL), b
        assert np.allclose(ft, fj, rtol=0, atol=MASK_TOL), b
        assert np.allclose(tb[b][0], et, rtol=MASK_TOL, atol=MASK_TOL)
        assert np.allclose(tb[b][1], ft, rtol=MASK_TOL, atol=MASK_TOL)


def test_gnnexplainer_node_level(graphs):
    kw = dict(model_level="node", dim_hidden=16, num_classes=2)
    jm, v, tm = _pair(lambda: jmod.GIN_2l(**kw), lambda: tmod.GIN_2l(**kw),
                      graphs["j1"][1])
    jex = JGNNExplainer(jm, v, epochs=5, lr=0.05, explain_graph=False)
    tex = GNNExplainer(tm, epochs=5, lr=0.05, explain_graph=False)
    tex.draw = lambda gen, E, F: _jax_masks(gen.initial_seed(), E, F)
    ej, fj = jex.explain(graphs["j1"][1], node_idx=3, seed=4)
    et, ft = tex.explain(graphs["t1"][1], node_idx=3, seed=4)
    assert np.allclose(et, ej, rtol=0, atol=MASK_TOL)
    assert np.allclose(ft, fj, rtol=0, atol=MASK_TOL)


def _small_graph(max_edges):
    for k, d in enumerate(DATA):
        if 8 <= len(d["senders"]) <= max_edges:
            return k
    raise AssertionError("no small graph")


@pytest.mark.parametrize("name", ["GradCAM", "GNN_GI", "DeepLIFT", "FlowX",
                                  "GNN_LRP"])
def test_gradient_explainers(graphs, trained, name):
    jm, v, tm = trained
    gj, gt = graphs["j1"][3], graphs["t1"][3]
    kw = dict(sample_num=3, seed=5) if name == "FlowX" else {}
    sj = getattr(jg, name)(jm, v).explain(gj, 1, **kw)
    st = getattr(tg, name)(tm).explain(gt, 1, **kw)
    if name == "FlowX":     # means of differences of probabilities
        fin = np.isfinite(sj)
        assert np.array_equal(np.isfinite(st), fin)
        assert np.abs(st[fin] - sj[fin]).max() <= PROB_TOL
    else:
        assert _rel(st, sj) < GRAD_TOL


def test_gnn_lrp_three_layers(graphs):
    k = _small_graph(30)
    gj, gt = graphs["j1"][k], graphs["t1"][k]
    jm, v, tm = _pair(lambda: jmod.GIN_3l(dim_hidden=16, readout="sum"),
                      lambda: tmod.GIN_3l(dim_hidden=16, readout="sum"), gj)
    sj = jg.GNN_LRP(jm, v).explain(gj, 0)
    st = tg.GNN_LRP(tm).explain(gt, 0)
    assert np.abs(sj[np.isfinite(sj)]).max() > 0
    assert _rel(st, sj) < GRAD_TOL


def test_pgexplainer_step(graphs, trained):
    jm, v, tm = trained
    gj, gt = graphs["j1"][1], graphs["t1"][1]
    jpg = JPGExplainer(jm, v, epochs=1, lr=3e-3)
    jpg.train_explanation_network([gj], seed=0)
    key = jax.random.PRNGKey(0)
    feats0 = jpg._edge_feats(gj)
    mlp0 = _np(jpg.mlp.init(key, feats0))
    u = jax.random.uniform(jax.random.split(key)[1], (gj.num_edges,),
                           minval=1e-6, maxval=1 - 1e-6)
    tpg = PGExplainer(tm, epochs=1, lr=3e-3)
    assert _rel(tpg._edge_feats(gt), feats0) < OUT_TOL
    init_mlp = tpg.init_mlp
    tpg.init_mlp = lambda F, seed: pgexplainer_from_flax(mlp0,
                                                         init_mlp(F, seed))
    tpg.draw = lambda gen, E: torch.tensor(np.asarray(u))
    tpg.train_explanation_network([gt], seed=0)
    want = pgexplainer_from_flax(_np(jpg.mlp_params),
                                 init_mlp(feats0.shape[-1], 0))
    _same_params(tpg.mlp, want, 3e-3)
    assert _rel(tpg.explain(gt), jpg.explain(gj)) < GRAD_TOL


@pytest.mark.parametrize("method", ["zero_filling", "split"])
def test_score_coalitions(graphs, trained, method):
    jm, v, tm = trained
    gj, gt = graphs["j1"][3], graphs["t1"][3]
    n = int(np.asarray(gj.node_mask).sum())
    coalitions = [[0, 1, 2], [1, 3], list(range(n))]
    vj = jsh.make_batched_value_func(jm, v, 1, None, method)
    vt = tsh.make_batched_value_func(tm, None, 1, None, method)
    for m in ("gnn_score", "l_shapley", "mc_shapley", "mc_l_shapley",
              "nc_mc_l_shapley"):
        kw = dict(local_radius=2, sample_num=6, seed=3,
                  node_idx=0 if m == "nc_mc_l_shapley" else None)
        a = tsh.score_coalitions(coalitions, gt, vt, m, **kw)
        b = jsh.score_coalitions(coalitions, gj, vj, m, **kw)
        assert np.allclose(a, b, rtol=0, atol=PROB_TOL), m


def test_sequential_shapley(graphs, trained):
    jm, v, tm = trained
    gj, gt = graphs["j1"][3], graphs["t1"][3]
    fj = jsh.make_value_func(jm, v, 0)
    ft = tsh.make_value_func(tm, None, 0)
    c = [0, 2, 4]
    pairs = [
        (jsh.l_shapley(c, gj, 2, fj), tsh.l_shapley(c, gt, 2, ft)),
        (jsh.mc_shapley(c, gj, fj, sample_num=5),
         tsh.mc_shapley(c, gt, ft, sample_num=5)),
        (jsh.mc_l_shapley(c, gj, 2, fj, sample_num=5),
         tsh.mc_l_shapley(c, gt, 2, ft, sample_num=5)),
        (jsh.NC_mc_l_shapley(c, gj, 2, fj, 1, sample_num=5),
         tsh.NC_mc_l_shapley(c, gt, 2, ft, 1, sample_num=5)),
        (jsh.gnn_score(c, gj, fj, "split"), tsh.gnn_score(c, gt, ft,
                                                           "split"))]
    for k, (a, b) in enumerate(pairs):
        assert abs(a - b) <= PROB_TOL, k


def test_subgraphx(graphs, trained):
    jm, v, tm = trained
    gj, gt = graphs["j1"][4], graphs["t1"][4]
    kw = dict(num_classes=2, rollout=3, min_atoms=3, sample_num=5)
    bj, rj = JSubgraphX(jm, v, **kw).explain(gj, label=1, max_nodes=5)
    bt, rt = SubgraphX(tm, **kw).explain(gt, label=1, max_nodes=5)
    assert bt.coalition == bj.coalition
    assert abs(bt.P - bj.P) <= PROB_TOL
    for k in rj:
        assert abs(rt[k] - rj[k]) <= PROB_TOL, k


def test_related_pred_and_collector(graphs, trained):
    jm, v, tm = trained
    gj, gt = graphs["j1"][2], graphs["t1"][2]
    rng = np.random.default_rng(4)
    masks = [jmet.control_sparsity(rng.normal(size=gj.num_edges), 0.6)
             for _ in range(2)]
    soft = rng.normal(size=gj.num_edges).astype(np.float32)
    assert np.array_equal(tmet.control_sparsity(soft, 0.6),
                          jmet.control_sparsity(soft, 0.6))
    assert np.array_equal(ExplainerBase.control_sparsity(soft, 0.4),
                          jmod_base_sparsity(soft, 0.4))
    rj = jmet.ExplanationProcessor(jm, v).forward(
        gj, masks, jxc := jmet.XCollector(), label=1)
    rt = tmet.ExplanationProcessor(tm, None).forward(
        gt, masks, txc := tmet.XCollector(), label=1)
    for a, b in zip(rt, rj):
        for k in b:
            assert abs(a[k] - b[k]) <= PROB_TOL, k
    for name in ("fidelity", "fidelity_inv", "sparsity"):
        assert abs(getattr(txc, name) - getattr(jxc, name)) <= PROB_TOL
    assert tmet.fidelity([0.9, 0.5], [0.2, 0.4]) == jmet.fidelity(
        [0.9, 0.5], [0.2, 0.4])
    assert tmet.fidelity_inv([0.9, 0.5], [0.2, 0.4]) == jmet.fidelity_inv(
        [0.9, 0.5], [0.2, 0.4])


def jmod_base_sparsity(mask, sparsity):
    from dig_tpu.xgraph.base import ExplainerBase as JBase
    return JBase.control_sparsity(mask, sparsity)


def test_disjoint_union_logits(graphs, trained):
    """A union of copies gives each copy the logits of a run on it."""
    _, _, tm = trained
    g = graphs["t1"][5]
    u = disjoint_union([g, g, g])
    with torch.no_grad():
        assert _rel(tm(u).reshape(3, 1, 2)[1], tm(g)) < OUT_TOL


def _tree_eq(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name,kw", [
    ("ba_shapes", dict(num_base=40, num_motifs=5, m=3, seed=1)),
    ("ba_community", dict(seed=2, num_base=30, num_motifs=3, m=2)),
    ("tree_cycle", dict(height=4, num_motifs=5, seed=3)),
    ("tree_grid", dict(height=4, num_motifs=5, seed=4)),
    ("ba_lrp", dict(num_graphs=6, num_nodes=12, seed=5)),
    ("ba_2motifs", dict(num_graphs=6, base_n=20, seed=6)),
])
def test_datasets_bit_for_bit(name, kw):
    a = getattr(td, name)(**kw)
    b = getattr(jd, name)(**kw)
    _tree_eq(a, b)
    if isinstance(a, dict):
        ta, jb = td.node_task_batch(a), jd.node_task_batch(b)
        for f in ("senders", "receivers", "node_mask", "edge_mask",
                  "node_graph"):
            assert np.array_equal(getattr(ta, f).numpy(),
                                  np.asarray(getattr(jb, f)))
        assert np.array_equal(ta.nodes["x"].numpy(), np.asarray(jb.nodes["x"]))


def test_molecule_and_sentigraph_readers(tmp_path):
    import json
    import pickle
    (tmp_path / "bbbp.csv").write_text(
        "smiles,p_np\nCCO,1\nc1ccccc1,0\nCC(N)=O,1\nbadsmiles(,0\n")
    _tree_eq(td.molecule_dataset(str(tmp_path), "bbbp"),
             jd.molecule_dataset(str(tmp_path), "bbbp"))
    raw = tmp_path / "Graph-SST2" / "raw"
    raw.mkdir(parents=True)
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    with open(raw / "Graph-SST2_node_features.pkl", "wb") as f:
        pickle.dump(x, f)
    np.savetxt(raw / "Graph-SST2_edge_index.txt",
               np.array([[0, 1], [1, 2], [3, 4]]), fmt="%d")
    np.savetxt(raw / "Graph-SST2_node_indicator.txt",
               np.array([1, 1, 1, 2, 2]), fmt="%d")
    np.savetxt(raw / "Graph-SST2_graph_labels.txt", np.array([1, 0]),
               fmt="%d")
    np.savetxt(raw / "Graph-SST2_split_indices.txt", np.array([0, 2]),
               fmt="%d")
    with open(raw / "Graph-SST2_sentence_tokens.json", "w") as f:
        json.dump({"0": ["a", "b", "c"], "1": ["d", "e"]}, f)
    _tree_eq(td.sentigraph_dataset(str(tmp_path), "Graph-SST2"),
             jd.sentigraph_dataset(str(tmp_path), "Graph-SST2"))
