"""The port's oodgraph against the JAX package's, on the CPU: numpy on both
sides, so every split holds the same graphs in the same order, for each
shift and seed (``make_ood_splits``), the synthetic fallback of every
named class (``GOODDataset.load(generate=True)``: the same process, so the
same salted name hash seeds both) and the npz cache reader."""
import numpy as np
import pytest

import dig_tpu.oodgraph as jood
import dig_tpu_torch.oodgraph as tood
from dig_tpu.datasets.graphs import synthetic_graph_dataset

SHIFTS = ("no_shift", "covariate", "concept")


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for ga, gb in zip(a[k], b[k]):
            assert ga is gb or (ga["num_nodes"] == gb["num_nodes"]
                                and np.array_equal(ga["x"], gb["x"])), k


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("seed", [0, 2])
def test_make_ood_splits_identical(shift, seed):
    graphs = synthetic_graph_dataset(100, seed=seed)
    dom = (lambda g: float(g["x"].sum())) if seed else None
    kw = dict(shift=shift, seed=seed, domain_fn=dom)
    a = tood.make_ood_splits(graphs, **kw)
    b = jood.make_ood_splits(graphs, **kw)
    _same(a, b)
    if shift == "covariate" and not seed:
        tr = {g["num_nodes"] for g in a["train"]}
        te = {g["num_nodes"] for g in a["test"]}
        assert max(tr) <= min(te)
    with pytest.raises(ValueError):
        tood.make_ood_splits(graphs, shift="label")


@pytest.mark.parametrize("name", jood.__all__[2:])
def test_named_classes_generate_identical(name):
    tc, jc = getattr(tood, name), getattr(jood, name)
    assert (tc.name, tc.task, tc.metric, tc.domains) == (
        jc.name, jc.task, jc.metric, jc.domains)
    meta_t, sp_t = tc.load("/nonexistent", tc.domains[0], shift="covariate",
                           generate=True)
    meta_j, sp_j = jc.load("/nonexistent", jc.domains[0], shift="covariate",
                           generate=True)
    assert meta_t == meta_j
    _same(sp_t, sp_j)
    with pytest.raises(FileNotFoundError):
        tc.load("/nonexistent", tc.domains[0])


def test_npz_cache_reader(tmp_path):
    graphs = synthetic_graph_dataset(20, seed=4)
    splits = tood.make_ood_splits(graphs, shift="no_shift", seed=1)
    d = tmp_path / "GOODHIV" / "size"
    d.mkdir(parents=True)
    arr = {}
    for k, v in splits.items():
        a = np.empty(len(v), object)
        a[:] = v
        arr[k] = a
    np.savez(d / "no_shift.npz", **arr)
    _, got = tood.GOODHIV.load(str(tmp_path), "size")
    _, want = jood.GOODHIV.load(str(tmp_path), "size")
    _same(got, want)
    assert [len(v) for v in got.values()] == [len(v) for v in splits.values()]
