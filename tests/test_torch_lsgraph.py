"""The port's lsgraph against the JAX package's, on the CPU: the native and
numpy partitioners, the one-hop relabel, the subgraph loader's arrays,
ScalableGNN (gcn, gcn with momentum, gcn2, pna, pna_jk) on the CSR, SELL
and plain aggregation routes with flax weights transplanted, the
histories, and mini_inference.

Tolerance: float32, 1e-5 of the largest value of each compared tensor (the
port and JAX sum in other orders); partitions, relabels and loader arrays
exactly. Two faults of the JAX package are stepped around, not copied:
its loader hands the native relabel a sender-keyed CSR (so the JAX arrays
compared are those of its numpy relabel, ``_relabel_np``), and its
history push may overwrite the fresh row of global node 0 with a stale
one (so pushed tables are compared on every row but node 0's, and a
separate case holds the port's row 0 to the fresh value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import dig_tpu.lsgraph as jl
import dig_tpu.native as j_native
import dig_tpu.parallel.partition as j_partition
import dig_tpu_torch.lsgraph as tl
import dig_tpu_torch.native as t_native
import dig_tpu_torch.parallel as t_parallel
from dig_tpu_torch.convert import scalable_gnn_from_flax

TOL = 1e-5
PNA_TOL = 5e-4
SUB_FIELDS = ("senders", "receivers", "edge_mask", "n_id", "node_mask",
              "in_batch_mask", "rowptr", "rev_perm", "send_ids_sorted",
              "rowptr_rev")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def graph():
    return tl.synthetic_large_graph(160, seed=0, avg_deg=6)


@pytest.fixture(scope="module")
def parts(graph):
    s, r = graph["senders"], graph["receivers"]
    N = len(graph["y"])
    perm, ptr, _ = tl.metis_permute(s, r, N, 4)
    return s, r, N, perm, ptr


def _no_jax_native(monkeypatch):
    """The JAX package's numpy routes (its partitioner and _relabel_np)."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(j_native, "metis_partition", lambda *a, **k: None)


def test_native_partition_bit_for_bit(graph):
    assert t_native.available() and j_native.available()
    s, r = graph["senders"], graph["receivers"]
    N = len(graph["y"])
    for k in (2, 4, 7):
        got = t_native.metis_partition(s, r, N, k)
        want = j_native.metis_partition(s, r, N, k)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t_parallel.partition_graph(s, r, N, k),
                                      want)
    for a, b in zip(tl.metis_permute(s, r, N, 4), jl.metis_permute(s, r, N,
                                                                   4)):
        np.testing.assert_array_equal(a, b)


def test_numpy_partition_bit_for_bit(graph, monkeypatch):
    _no_jax_native(monkeypatch)
    monkeypatch.setattr(t_native, "metis_partition", lambda *a, **k: None)
    s, r = graph["senders"], graph["receivers"]
    N = len(graph["y"])
    got = t_parallel.partition_graph(s, r, N, 4)
    want = j_partition.partition_graph(s, r, N, 4)
    np.testing.assert_array_equal(got, want)
    assert t_parallel.edge_cut(got, s, r) == j_partition.edge_cut(want, s, r)
    pg, pj = (m.build_partitions(s, r, N, 4, part_of=want)
              for m in (t_parallel, j_partition))
    for f in ("perm", "part_of", "senders", "receivers", "edge_mask",
              "halo_src_part", "halo_src_slot", "halo_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(pg, f), getattr(pj, f))


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_subdata_equals_jax_numpy_relabel(parts, monkeypatch, route):
    """Both relabel routes of the port give the JAX numpy route's arrays,
    halo and edge order included."""
    s, r, N, perm, ptr = parts
    _no_jax_native(monkeypatch)
    want = list(jl.SubgraphLoader(s, r, N, ptr, perm, batch_parts=2))
    if route == "numpy":
        monkeypatch.setattr(t_native, "available", lambda: False)
    else:
        assert t_native.available()
    got = list(tl.SubgraphLoader(s, r, N, ptr, perm, batch_parts=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.batch_size == w.batch_size
        for f in SUB_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_directed_graph_aggregates_along_edges(monkeypatch):
    """Edges 0->1, 0->2, 1->3, 2->3, 3->0 in two parts {0, 1}, {2, 3}: each
    node sums its in-neighbours (node 1 gets 0; node 3 gets 1 and 2), on
    both relabel routes, as a one-layer GCN's output shows. (The JAX
    native route gives node 0 the senders 1 and 2: its out-neighbours.)"""
    s, r = np.array([0, 0, 1, 2, 3]), np.array([1, 2, 3, 3, 0])
    N, perm, ptr = 4, np.arange(4), np.array([0, 2, 4])
    x = np.random.default_rng(0).normal(size=(N, 3)).astype(np.float32)

    def senders_of(subs):
        out = {}
        for sub in subs:
            em = sub.edge_mask
            for v in range(sub.batch_size):
                out[int(sub.n_id[v])] = sorted(
                    int(sub.n_id[u])
                    for u in sub.senders[em & (sub.receivers == v)])
        return out
    assert j_native.available()
    assert senders_of(jl.SubgraphLoader(s, r, N, ptr, perm)) == {
        0: [1, 2], 1: [3], 2: [3], 3: [0]}       # the JAX native route
    model = tl.ScalableGCN(N, 3, 4, 2, 1, device="cpu")
    lin = model.body.layers[0].lin
    xt = torch.tensor(x)
    for native_on in (True, False):
        if not native_on:
            monkeypatch.setattr(t_native, "available", lambda: False)
        subs = list(tl.SubgraphLoader(s, r, N, ptr, perm))
        assert senders_of(subs) == {0: [3], 1: [0], 2: [0], 3: [1, 2]}
        for sub in subs:
            out, _ = model(model.histories, xt, sub)
            B, em = sub.batch_size, sub.edge_mask
            snd, rcv = sub.senders[em], sub.receivers[em]
            n = len(sub.n_id)
            d_in = 1 + np.bincount(rcv, minlength=n)
            d_out = 1 + np.bincount(snd, minlength=n)
            h = lin(xt[torch.as_tensor(sub.n_id)]).detach().numpy()
            want = h / d_in[:, None]
            for a, b in zip(snd, rcv):
                want[b] += h[a] / np.sqrt(d_in[b] * d_out[a])
            assert _rel(out.detach().numpy()[:B], want[:B]) < TOL


def _jax_step(model, params, hist, xg, sub, route, w):
    """Out, new histories and the parameter gradient of sum(out * w) of the
    JAX ScalableGNN.forward, in one jit: the host-side SubData closed over
    (its SELL route), or traced as an argument (its CSR route for
    segment_eb > 0, else segment_sum)."""
    def run(p, h, x, s):
        out, nh = model.forward(p, h, x, s)
        return jnp.sum(out * w), (out, nh)
    grad = jax.value_and_grad(run, has_aux=True)
    if route == "sell":
        (_, aux), g = jax.jit(lambda p, h, x: grad(p, h, x, sub))(
            params, hist, xg)
    else:
        (_, aux), g = jax.jit(grad)(params, hist, xg, sub)
    return aux[0], aux[1], g


CASES = [("gcn", {}, "csr"), ("gcn", {}, "sell"), ("gcn", {}, "plain"),
         ("gcn", {"use_momentum": True}, "csr"),
         ("gcn2", {}, "csr"), ("gcn2", {}, "sell"), ("gcn2", {}, "plain"),
         ("pna", {"avg_deg": 6.0}, "plain"),
         ("pna_jk", {"avg_deg": 6.0}, "plain")]


IDS = [a + ("_momentum" if "use_momentum" in k else "") + "-" + r
       for a, k, r in CASES]


@pytest.mark.parametrize("arch,kw,route", CASES, ids=IDS)
def test_scalable_gnn_against_jax(parts, graph, arch, kw, route):
    """Out, parameter gradients (of sum(out * w)) and pushed histories of
    one minibatch from seeded non-zero histories, three layers. PNA at
    PNA_TOL: XLA's CPU float32 evaluation of PNA lies up to 4.5e-5
    (outputs) and 1.6e-4 (gradients) from a float64 evaluation of the same
    weights and inputs, the port's up to 1.3e-6 and 3.1e-5 (std is
    sqrt(mean(x^2) - mean^2), which cancels)."""
    tol = PNA_TOL if arch.startswith("pna") else TOL
    s, r, N, perm, ptr = parts
    tsub = tl.SubgraphLoader(s, r, N, ptr, perm, batch_parts=2)._batches[0]
    sub = jl.SubData(**{f: getattr(tsub, f) for f in SUB_FIELDS},
                     batch_size=tsub.batch_size)
    assert 0 in tsub.n_id[:tsub.batch_size]
    x = graph["x"][perm]
    F = x.shape[1]
    eb = 256 if route == "csr" else 0
    jm = jl.ScalableGNN(arch, N, F, 8, 3, 3, segment_eb=eb, **kw)
    params = jm.init(jax.random.PRNGKey(1), x, sub)
    rng = np.random.default_rng(2)
    tables = [rng.normal(size=(N, 8)).astype(np.float32) for _ in range(2)]
    w = rng.normal(size=(len(sub.n_id), 3)).astype(np.float32)
    jh = [type(h)(jnp.asarray(t), *h[1:]) for h, t in zip(jm.histories,
                                                           tables)]

    j_out, j_hist, j_grads = _jax_step(jm, params, jh, jnp.asarray(x), sub,
                                       route, w)

    tm = tl.ScalableGNN(arch, N, F, 8, 3, 3, segment_eb=eb,
                        sell=route == "sell", device="cpu", **kw)
    scalable_gnn_from_flax(flatten_dict(params["params"], sep="/"), tm)
    th = [type(h)(torch.tensor(t), *h[1:]) for h, t in zip(tm.histories,
                                                            tables)]
    t_out, t_hist = tm(th, torch.tensor(x), tsub)
    (t_out * torch.tensor(w)).sum().backward()
    assert _rel(t_out.detach().numpy(), j_out) < tol
    flat = flatten_dict(j_grads["params"], sep="/")
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert len(grads) == len(flat)
    for name, g in flat.items():
        mod = _param_of(tm, arch, name)
        want = np.asarray(g).T if name.endswith("kernel") else np.asarray(g)
        assert _rel(mod.grad.numpy(), want) < tol, name
    keep = np.arange(N) != 0     # the JAX push may lose node 0's row
    for a, b in zip(t_hist, j_hist):
        assert _rel(a.emb.numpy()[keep], np.asarray(b.emb)[keep]) < tol


def _param_of(model, arch, name):
    """The port's parameter that the flax entry ``name`` fills."""
    body = model.body
    scope, leaf = name.rsplit("/", 1)
    if scope.startswith("_"):
        lin = body.layers[int(scope.split("/")[0].rsplit("_", 1)[1])].lin
    elif arch == "gcn2":
        lin = body.lin_in if scope == "Dense_0" else body.lin_out
    else:
        lin = body.lin_out
    return lin.weight if leaf == "kernel" else lin.bias


def test_history_push_keeps_node_0_fresh():
    """Padding rows carry node id 0: a masked push must not write them, so
    a fresh row of node 0 survives (History and FeatureMomentum)."""
    n_id = torch.tensor([0, 1, 0, 0])
    mask = torch.tensor([True, True, False, False])
    x = torch.arange(1.0, 9.0).reshape(4, 2)
    h = tl.History.create(3, 2, device="cpu")
    h = tl.History(emb=h.emb + 7.0).push(x, n_id, mask=mask)
    np.testing.assert_array_equal(h.emb.numpy(),
                                  [[1, 2], [3, 4], [7, 7]])
    fm = tl.FeatureMomentum.create(3, 2, gamma=0.5, device="cpu")
    fm = fm.push(x, n_id, mask=mask)
    np.testing.assert_array_equal(fm.emb.numpy(), [[1, 2], [3, 4], [0, 0]])
    fm = fm.push_momentum(x + 1.0, n_id, mask=torch.zeros(4, dtype=bool))
    np.testing.assert_array_equal(fm.emb.numpy(), [[1, 2], [3, 4], [0, 0]])
    fm = fm.push_momentum(x + 1.0, torch.tensor([2, 1, 0, 0]),
                          mask=torch.tensor([True, False, False, False]))
    np.testing.assert_array_equal(fm.emb.numpy(), [[1, 2], [3, 4],
                                                   [1, 1.5]])


def test_history_against_jax():
    """Pull, push with and without a mask, and the momentum blend, on
    rows that leave node 0 out."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(10, 4)).astype(np.float32)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    ids = np.array([3, 5, 7, 9, 2])
    mask = np.array([True, False, True, True, False])
    for cls_t, cls_j, extra in ((tl.History, jl.History, ()),
                                (tl.FeatureMomentum, jl.FeatureMomentum,
                                 (0.3,))):
        t = cls_t(torch.tensor(base), *extra)
        j = cls_j(jnp.asarray(base), *extra)
        for m in (None, mask):
            tm = None if m is None else torch.tensor(m)
            jm = None if m is None else jnp.asarray(m)
            a = t.push(torch.tensor(x), torch.tensor(ids), tm)
            b = j.push(jnp.asarray(x), jnp.asarray(ids), jm)
            assert _rel(a.emb.numpy(), b.emb) < TOL
            if extra:
                a = a.push_momentum(torch.tensor(x), torch.tensor(ids), tm)
                b = b.push_momentum(jnp.asarray(x), jnp.asarray(ids), jm)
                assert _rel(a.emb.numpy(), b.emb) < TOL
            assert _rel(a.pull(torch.tensor(ids)).numpy(),
                        b.pull(jnp.asarray(ids))) < TOL


def test_mini_inference_against_jax(graph, monkeypatch):
    """Two parts, two layers; each JAX forward jitted on its host-side
    SubData (its SELL route, as when run eagerly). The JAX push loses the
    fresh row of node 0 (module docstring), which the second sweep pulls
    as a halo row, so the rows of node 0's out-neighbours are left out."""
    _no_jax_native(monkeypatch)
    s, r = graph["senders"], graph["receivers"]
    N = len(graph["y"])
    perm, ptr, _ = tl.metis_permute(s, r, N, 2)
    x = graph["x"][perm]
    jm = jl.ScalableGCN(N, x.shape[1], 8, 4, 2, use_momentum=True)
    jev = jl.EvalSubgraphLoader(s, r, N, ptr, perm)
    params = jm.init(jax.random.PRNGKey(0), x, jev._batches[0])
    forward, jitted = jm.forward, {}

    def forward_jit(p, h, xg, sub):
        if id(sub) not in jitted:
            jitted[id(sub)] = jax.jit(lambda p, h, xg: forward(p, h, xg, sub))
        return jitted[id(sub)](p, h, xg)
    monkeypatch.setattr(jm, "forward", forward_jit)
    want = np.asarray(jm.mini_inference(params, jnp.asarray(x), jev))
    tm = tl.ScalableGCN(N, x.shape[1], 8, 4, 2, use_momentum=True,
                        device="cpu")
    scalable_gnn_from_flax(flatten_dict(params["params"], sep="/"), tm)
    got = tm.mini_inference(torch.tensor(x),
                            tl.EvalSubgraphLoader(s, r, N, ptr, perm))
    inv = np.argsort(perm)
    keep = np.ones(N, bool)
    keep[inv[r[inv[s] == 0]]] = False
    assert keep.sum() > N - 12
    assert _rel(got.numpy()[keep], want[keep]) < TOL
