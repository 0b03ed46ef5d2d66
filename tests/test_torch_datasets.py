"""The port's host data layer against the JAX package's, on the CPU: the
QM9 and MD17 readers on tiny npz fixtures written to ``tmp_path`` (no
download), the split, ``synthetic_crystals``, the protein builders and
``ProteinLoader`` (the NaN missing-atom path included), ``dense_to_flat``
and ``Config``. Everything here is numpy or integer work, so every array
is compared for exact equality (bit for bit), NaN positions included.
"""
import json

import numpy as np
import pytest

import dig_tpu.config as jconfig
from dig_tpu.datasets import MD17 as JMD17
from dig_tpu.datasets import QM93D as JQM93D
from dig_tpu.datasets import DenseMoleculeLoader as JDense
from dig_tpu.datasets import ProteinLoader as JProteinLoader
from dig_tpu.datasets import proteins as jprot
from dig_tpu.datasets import synthetic_crystals as j_crystals
from dig_tpu.datasets.qm9 import get_idx_split as j_split
from dig_tpu.graph_dense import dense_to_flat as j_dense_to_flat
from dig_tpu.graph_dense import radius_adjacency as j_radius_adjacency
from dig_tpu_torch import Config
from dig_tpu_torch.datasets import MD17, QM93D, ProteinLoader
from dig_tpu_torch.datasets import DenseMoleculeLoader, synthetic_molecules
from dig_tpu_torch.datasets import proteins as tprot
from dig_tpu_torch.datasets import synthetic_crystals
from dig_tpu_torch.datasets.qm9 import get_idx_split
from dig_tpu_torch.graph_dense import dense_to_flat, radius_adjacency

TARGETS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0", "U",
           "H", "G", "Cv"]


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _same_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        _eq(x, y, k)


@pytest.mark.parametrize("args", [(130831, 1000, 10000, 42), (50, 10, 5, 3)])
def test_idx_split_matches_jax(args):
    a, b = get_idx_split(*args), j_split(*args)
    for k in ("train", "valid", "test"):
        _eq(a[k], b[k], k)
    if args[-1] == 42:
        assert (a["train"][0], a["valid"][0], a["test"][0]) == \
            (112526, 120798, 107901)


def test_qm9_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    N = np.array([3, 5, 2, 4], np.int64)
    total = int(N.sum())
    (tmp_path / "raw").mkdir()
    np.savez(tmp_path / "raw" / "qm9_eV.npz",
             R=rng.normal(size=(total, 3)).astype(np.float32),
             Z=rng.integers(1, 9, total).astype(np.int32), N=N,
             **{t: rng.normal(size=4).astype(np.float32) for t in TARGETS})
    got, want = QM93D(root=str(tmp_path)), JQM93D(root=str(tmp_path))
    assert len(got) == len(want) == 4
    for i in range(4):
        _same_dicts(got[i], want[i])
    split = got.get_idx_split(4, 2, 1, seed=0)
    sel_t, sel_j = got.select(split["train"]), want.select(split["train"])
    for a, b in zip(sel_t, sel_j):
        _same_dicts(a, b)


def test_md17_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    T, n = 6, 9
    np.savez(tmp_path / "aspirin_dft.npz",
             E=rng.normal(size=(T, 1)), F=rng.normal(size=(T, n, 3)),
             R=rng.normal(size=(T, n, 3)), z=rng.integers(1, 7, n))
    got = MD17(root=str(tmp_path), name="aspirin")
    want = JMD17(root=str(tmp_path), name="aspirin")
    assert len(got) == len(want) == T
    for i in range(T):
        _same_dicts(got[i], want[i])
    split_t, split_j = got.get_idx_split(T, 3, 2, 7), \
        want.get_idx_split(T, 3, 2, 7)
    for k in ("train", "valid", "test"):
        _eq(split_t[k], split_j[k], k)


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        QM93D(root=str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        MD17(root=str(tmp_path), name="benzene_old")
    with pytest.raises(FileNotFoundError):
        tprot.ECdataset(root=str(tmp_path))


def test_synthetic_crystals_match_jax():
    got = synthetic_crystals(5, seed=3, min_atoms=20, max_atoms=40)
    want = j_crystals(5, seed=3, min_atoms=20, max_atoms=40)
    for a, b in zip(got, want):
        _same_dicts(a, b)


def test_protein_builders_match_jax(tmp_path):
    """The embeddings of synthetic backbones (NaN side-chain atoms on about
    15% of the residues) and the npz readers."""
    got = tprot.synthetic_proteins(5, min_res=6, max_res=20, seed=2)
    want = jprot.synthetic_proteins(5, min_res=6, max_res=20, seed=2)
    for a, b in zip(got, want):
        _same_dicts(a, b)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(7, 3, 3))
    X[3] = np.nan
    _eq(tprot.bb_embs(X), jprot.bb_embs(X))
    vs = [rng.normal(size=(7, 3)) for _ in range(3)]
    vs[1][2] = np.nan
    _eq(tprot.compute_dihedrals(*vs), jprot.compute_dihedrals(*vs))
    objs = lambda key: np.array([p[key] for p in got] + [None],
                                dtype=object)[:-1]
    np.savez(tmp_path / "ec_train.npz",
             **{k: objs(k) for k in got[0]})
    for a, b in zip(tprot.ECdataset(str(tmp_path)),
                    jprot.ECdataset(str(tmp_path))):
        _same_dicts(a, b)


@pytest.mark.parametrize("slot", [None, 20], ids=["flat", "slots"])
def test_protein_loader_batches_are_the_jax_bits(slot):
    prots = tprot.synthetic_proteins(7, min_res=6, max_res=20, seed=4)
    kw = dict(slot_size=slot, shuffle=True, seed=1)
    got = list(ProteinLoader(prots, 3, device="cpu", **kw))
    want = list(JProteinLoader(prots, 3, **kw))
    assert len(got) == len(want) == 2          # drop_last with shuffle
    for a, b in zip(got, want):
        _same_dicts({k: v.numpy() for k, v in a.nodes.items()}, b.nodes)
        _same_dicts({k: v.numpy() for k, v in a.globals.items()}, b.globals)
        for name in ("node_graph", "node_mask", "graph_mask", "n_node",
                     "senders", "edge_mask"):
            _eq(getattr(a, name).numpy(), getattr(b, name), name)


@pytest.mark.parametrize("max_edges", [400, 60], ids=["all", "capped"])
def test_dense_to_flat_matches_jax(max_edges):
    mols = synthetic_molecules(5, seed=6, min_atoms=3, max_atoms=9)
    tb = next(iter(DenseMoleculeLoader(mols, 5, n_max=9, device="cpu")))
    jb = next(iter(JDense(mols, 5, n_max=9)))
    _, adj_t = radius_adjacency(tb.pos, tb.node_mask, 3.0)
    _, adj_j = j_radius_adjacency(jb.pos, jb.node_mask, 3.0)
    _eq(adj_t.numpy(), adj_j)
    got = dense_to_flat(tb, adj_t, max_edges)
    want = j_dense_to_flat(jb, adj_j, max_edges)
    assert int(adj_t.sum()) > 60
    for name in ("senders", "receivers", "edge_mask", "node_graph",
                 "node_mask", "graph_mask", "n_node", "n_edge"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        _eq(a, b, name)
    _same_dicts({k: v.numpy() for k, v in got.nodes.items()}, want.nodes)
    _same_dicts({k: v.numpy() for k, v in got.globals.items()}, want.globals)


YAML = """
# a comment
model:
  name: SphereNet
  hidden: 128   # trailing comment
  cutoff: 5.0
  dims: [1, 2, 3]
train:
  lr: 0.0005
  amp: false
  ckpt: ~
  tag: 'run-a'
"""


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_config_round_trips_match_jax(tmp_path, suffix):
    src = tmp_path / f"conf{suffix}"
    if suffix == ".json":
        src.write_text(json.dumps(jconfig._parse_yaml(YAML)))
    else:
        src.write_text(YAML)
    ov = ["train.lr=1e-3", "model.new.depth=4", "train.amp=True",
          "model.dims=[4, 5]", "train.tag=none"]
    got = Config.load(str(src), overrides=ov)
    want = jconfig.Config.load(str(src), overrides=ov)
    assert got.to_dict() == want.to_dict()
    assert got.model.hidden == 128 and got.model.new.depth == 4
    assert got.train.lr == 1e-3 and got.train.tag is None
    with pytest.raises(AttributeError):
        got.nope
    for out in ("out.yaml", "out.json"):
        got.save(str(tmp_path / f"t_{out}"))
        want.save(str(tmp_path / f"j_{out}"))
        assert (tmp_path / f"t_{out}").read_text() == \
            (tmp_path / f"j_{out}").read_text()
        back = Config.load(str(tmp_path / f"t_{out}"))
        assert back.to_dict() == got.to_dict()
    d = {"a": {"b": [1, {"c": 2}]}, "x": 1.5}
    assert Config.from_dict(d).to_dict() == \
        jconfig.Config.from_dict(d).to_dict() == d
    assert Config.from_dict(d).a.b[1].c == 2
