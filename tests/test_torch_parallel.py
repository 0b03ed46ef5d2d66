"""The port's parallel package on gloo ranks against the JAX package on
its virtual CPU mesh of the same size, computed in the pytest process.

One spawn of 4 ranks (``torch_parallel_ranks.dp_halo``) runs every
check of this file; the cases read its results (a module-scoped
fixture):

* ``collective_selfcheck`` on a ``(2, 2)`` mesh returns the sizes;
* one DP step (SGD) of the flat SchNet over 4 slabs of 2 molecules
  against JAX's DP step on 4 devices: the loss to 1e-5 relative, every
  weight to 5e-4 relative + 5e-6 (as the JAX test holds its DP step to a
  single device), the eval step's slab predictions to 1e-5;
* the all-to-all and the ring halo sums against the dense sum over the
  edges, and their gradients against the dense adjoint (float32, 1e-5),
  and the all-gather exchange's halo rows exactly, its gradient counted
  per halo reference;
* the scaling probe at P = 4 and, on each row of a (2, 2) mesh, at P = 2:
  the same halo rows as the JAX probe (host numpy), the per-rank send
  volume O(1), and one step's collective counts (by the port's wrappers)
  the same at both P.
"""
import flax
import jax
import numpy as np
import optax
import pytest

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.models import SchNet as JSchNet
from dig_tpu.parallel import (concat_local_shards as j_concat,
                              make_dp_eval_step as j_eval,
                              make_dp_train_step as j_dp,
                              make_mesh as j_mesh, replicate as j_replicate,
                              shard_graph_batch as j_shard)
from dig_tpu.parallel.scaling import measure_gp_scaling as j_scaling
from dig_tpu.train.trainer import make_train_state
from dig_tpu_torch.convert import schnet_from_flax
from dig_tpu_torch.models import SchNet
from dig_tpu_torch.parallel import build_partitions, spawn_local

import torch_parallel_ranks as ranks

P = 4
KW = dict(cutoff=3.0, num_layers=2, hidden_channels=32, num_filters=32,
          num_gaussians=16, max_edges=256)


def _flat(params):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        params["params"], sep="/").items()}


def _random_graph(rng, n, avg_deg):
    e = n * avg_deg
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    keep = s != r
    return s[keep], r[keep]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mols = [synthetic_molecules(2, seed=i, max_atoms=12) for i in range(P)]
    shards = [next(iter(JLoader(m, 2, n_node_pad=32))) for m in mols]
    model = JSchNet(**KW)
    opt = optax.sgd(1e-2)
    state0 = make_train_state(model, opt, shards[0], seed=0)
    flat0 = _flat(state0.params)
    rng = np.random.default_rng(1)
    n, F = 160, 16
    s, r = _random_graph(rng, n, 6)
    pg = build_partitions(s, r, n, P)
    C = pg.nodes_per_part
    x = rng.normal(size=(n, F)).astype(np.float32)
    ct = rng.normal(size=(n, F)).astype(np.float32)
    slab = lambda a: _slab(a, pg.perm, P, C)
    spec = {"dp": {"kw": KW, "flat": flat0, "lr": 1e-2, "mols": mols,
                   "per": 2, "pad": 32},
            "halo": {"s": s, "r": r, "n": n, "x_parts": slab(x),
                     "ct_parts": slab(ct)}}
    base = tmp_path_factory.mktemp("dp_halo")
    # the ranks run while the JAX DP step compiles
    join = ranks.background(spawn_local, ranks.dp_halo, P,
                            str(base / "p4"), (spec,), timeout=120)
    mesh = j_mesh((P,), ("data",), devices=jax.devices()[:P])
    g = j_shard(j_concat(shards), mesh, "data")
    preds = np.asarray(j_eval(model, mesh)(j_replicate(state0.params, mesh),
                                           g)[0])
    state, aux = j_dp(model, opt, mesh)(j_replicate(state0, mesh), g)
    want = schnet_from_flax(_flat(jax.device_get(state.params)),
                            SchNet(device="cpu", **KW)).state_dict()
    return dict(got=join(), dp=(float(aux["loss"]), want, preds), pg=pg,
                x=x, ct=ct, s=s, r=r, n=n, C=C)


def _slab(a, perm, P_, C):
    out = np.zeros((P_ * C,) + a.shape[1:], a.dtype)
    out[perm] = a
    return out.reshape((P_, C) + a.shape[1:])


def test_collective_selfcheck_2x2(run):
    for res in run["got"]:
        assert res["selfcheck"] == {"data": 2, "graph": 2}


def test_dp_matches_jax_dp(run):
    loss, want, preds = run["dp"]
    for res in run["got"]:
        assert res["dp_loss"] == pytest.approx(loss, rel=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(res["dp_weights"][k], w.numpy(),
                                       rtol=5e-4, atol=5e-6, err_msg=k)
    for i, res in enumerate(run["got"]):
        np.testing.assert_allclose(res["dp_eval"], preds[2 * i:2 * i + 2],
                                   rtol=1e-5, atol=1e-6)


def _dense(run):
    want = np.zeros_like(run["x"])
    np.add.at(want, run["r"], run["x"][run["s"]])
    gx = np.zeros_like(run["ct"])
    np.add.at(gx, run["s"], run["ct"][run["r"]])
    return want, gx


@pytest.mark.parametrize("kind", ["a2a", "ring"])
def test_halo_sums_match_dense(run, kind):
    want, gx = _dense(run)
    pg, C = run["pg"], run["C"]
    got = np.concatenate([res["halo_sums"][kind][0] for res in run["got"]])
    grad = np.concatenate([res["halo_sums"][kind][1] for res in run["got"]])
    np.testing.assert_allclose(got[pg.perm], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad[pg.perm], gx, rtol=1e-5, atol=1e-5)


def test_halo_allgather_rows_and_adjoint(run):
    pg, C = run["pg"], run["C"]
    xs = _slab(run["x"], pg.perm, P, C)
    uses = np.zeros((P, C), np.float32)
    for p, res in enumerate(run["got"]):
        halo, _ = res["halo_gather"]
        m = pg.halo_mask[p]
        want = xs[pg.halo_src_part[p], pg.halo_src_slot[p]]
        assert np.array_equal(halo[m], want[m])
        assert not np.any(halo[~m])
        np.add.at(uses, (pg.halo_src_part[p][m], pg.halo_src_slot[p][m]), 1)
    for p, res in enumerate(run["got"]):
        _, gx = res["halo_gather"]
        np.testing.assert_array_equal(gx, np.repeat(uses[p][:, None],
                                                    gx.shape[1], 1))


def test_scaling_probe_constant_halo_and_collectives(run):
    rows = {2: run["got"][0]["scaling_half"], P: run["got"][0]["scaling"]}
    for p_, row in rows.items():
        want = j_scaling(p_, n_local=128, k=4, compile_step=False)
        for k, v in want.items():
            assert row[k] == v, (p_, k)
    assert max(r["send_rows_max"] for r in rows.values()) <= 128 // 4
    c2, c4 = rows[2]["collectives"], rows[P]["collectives"]
    assert c2 == c4, (c2, c4)
    assert c2["all_to_all"] > 0 and c2["all_reduce"] > 0
    # every rank issued the same collectives
    assert all(res["scaling"]["collectives"] == c4
               and res["scaling_half"]["collectives"] == c2
               for res in run["got"])


def test_count_collectives_parses_both_syntaxes():
    """The HLO-text counter is a copy: the same counts as JAX's on the JAX
    test's text and on lowered StableHLO text."""
    from dig_tpu.parallel.scaling import count_collectives as j_count
    from dig_tpu_torch.parallel.scaling import count_collectives
    for txt in ("%x = f32[2] all-to-all(%a), dimensions={0}\n"
                "%y = f32[2] all-reduce-start(%b)\n"
                "%z = f32[2] all-reduce-done(%y)\n",
                "%0 = stablehlo.all_to_all %a\n%1 = stablehlo.all_reduce"
                " %b\n%2 = stablehlo.all_to_all %c\n"):
        assert count_collectives(txt) == j_count(txt)
    assert count_collectives("%x = f32[2] all-to-all(%a)\n")[
        "all_to_all"] == 1
