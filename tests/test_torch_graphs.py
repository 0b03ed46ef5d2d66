"""The graph-classification substrate (``dig_tpu_torch.datasets.graphs``)
against ``dig_tpu.datasets.graphs``, bit for bit: ``degree_onehot``,
``load_tu_dataset`` (a TU-format fixture written to ``tmp_path``: node
attributes, node labels, or neither, so degree features),
``synthetic_graph_dataset`` and every batch of ``GraphClsLoader`` (in
order and shuffled over two epochs, ``drop_last`` both ways, explicit
pads)."""
import numpy as np
import pytest

from dig_tpu.datasets import graphs as jg
from dig_tpu_torch.datasets import graphs as tg

BATCH_FIELDS = ("senders", "receivers", "node_graph", "node_mask",
                "edge_mask", "graph_mask", "n_node", "n_edge")


def _same_graphs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            xa, ya = np.asarray(x[k]), np.asarray(y[k])
            assert xa.dtype == ya.dtype, k
            np.testing.assert_array_equal(xa, ya, err_msg=k)


def _same_batch(bj, bt):
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(bj, f)),
                                      getattr(bt, f).numpy(), err_msg=f)
    for d in ("nodes", "globals"):
        dj, dt = getattr(bj, d), getattr(bt, d)
        assert dj.keys() == dt.keys()
        for k in dj:
            # JAX (no x64) holds the int64 labels as int32
            a, b = np.asarray(dj[k]), dt[k].numpy()
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (d, k)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(num=12, seed=0),
                                dict(num=9, seed=3, min_nodes=3, max_nodes=6,
                                     feat_dim=4, num_classes=3)])
def test_synthetic_graph_dataset(kw):
    _same_graphs(jg.synthetic_graph_dataset(**kw),
                 tg.synthetic_graph_dataset(**kw))


@pytest.mark.parametrize("max_degree", [None, 2])
def test_degree_onehot(max_degree):
    mk = lambda m: m.synthetic_graph_dataset(7, seed=1)
    _same_graphs(jg.degree_onehot(mk(jg), max_degree),
                 tg.degree_onehot(mk(tg), max_degree))


def _write_tu(root, name, kind):
    """Three graphs (4, 3 and 5 nodes) in the TU format, 1-based ids, edges
    listed out of graph order; ``kind``: 'attrs', 'labels' or 'plain'."""
    rng = np.random.default_rng(7)
    sizes = [4, 3, 5]
    off = np.cumsum([0] + sizes)
    edges = []
    for gi, n in enumerate(sizes):
        for a in range(n):
            for b in range(n):
                if a != b and rng.random() < 0.5:
                    edges.append((off[gi] + a + 1, off[gi] + b + 1))
    edges = [edges[i] for i in rng.permutation(len(edges))]
    base = root / name / "raw"
    base.mkdir(parents=True)
    np.savetxt(base / f"{name}_A.txt", np.array(edges), fmt="%d",
               delimiter=", ")
    ind = np.concatenate([np.full(n, gi + 1) for gi, n in enumerate(sizes)])
    np.savetxt(base / f"{name}_graph_indicator.txt", ind, fmt="%d")
    np.savetxt(base / f"{name}_graph_labels.txt", np.array([5, -1, 5]),
               fmt="%d")
    if kind == "attrs":
        np.savetxt(base / f"{name}_node_attributes.txt",
                   rng.normal(size=(off[-1], 3)), delimiter=",")
    elif kind == "labels":
        np.savetxt(base / f"{name}_node_labels.txt",
                   rng.integers(0, 4, size=off[-1]), fmt="%d")


@pytest.mark.parametrize("kind", ["attrs", "labels", "plain"])
def test_load_tu_dataset(tmp_path, kind):
    _write_tu(tmp_path, "TOY", kind)
    got = tg.load_tu_dataset(str(tmp_path), "TOY")
    _same_graphs(jg.load_tu_dataset(str(tmp_path), "TOY"), got)
    assert [g["y"] for g in got] == [1, 0, 1]
    with pytest.raises(FileNotFoundError):
        tg.load_tu_dataset(str(tmp_path), "MISSING")


@pytest.mark.parametrize("kw", [dict(batch_size=4),
                                dict(batch_size=4, shuffle=True, seed=3),
                                dict(batch_size=5, drop_last=False),
                                dict(batch_size=3, n_node_pad=64,
                                     n_edge_pad=300, shuffle=True,
                                     drop_last=True)])
def test_graph_cls_loader(kw):
    data = tg.synthetic_graph_dataset(14, seed=2)
    lj, lt = jg.GraphClsLoader(data, **kw), tg.GraphClsLoader(data, **kw)
    assert len(lj) == len(lt)
    for _ in range(2):
        bjs, bts = list(lj), list(lt)
        assert len(bjs) == len(bts) == len(lt)
        for bj, bt in zip(bjs, bts):
            assert bt.node_mask.device.type == "cpu"
            _same_batch(bj, bt)
