"""The port's tensor, pipeline and expert parallelism on 4 gloo ranks
(one spawn, ``torch_parallel_ranks.tp_pp_ep``) against the JAX package
computed in the pytest process.

* TP on a ``(data 2, model 2)`` mesh (the flat SchNet's column shards by
  ``tp_param_specs``' rule) against JAX's DP step on 2 devices from the
  same weights, energy only and energy + force (p = 1): three Adam steps'
  losses to 1e-5 relative and the weights after them to 2e-4 relative +
  1e-6, as the JAX test holds its TP run to its DP run; the eval step's
  predictions to 1e-5. The port's sharded set is JAX's (the same count of
  parameters, sharded on the same feature axis).
* PP over 4 stages of an 8-layer residual tanh stack, 6 microbatches:
  the outputs against the sequential stack (1e-5), one SGD step's loss and
  every stage's updated layers against JAX's sequential step (1e-5 / 1e-4).
* EP with 16 experts over 4 ranks, 64 tokens: at capacity 64 nothing
  drops, and the output and the gradients of ``sum(y^2)`` are JAX's dense
  oracle's (1e-5, 1e-4); at capacity 2 the same tokens drop as in JAX's
  EP on 4 devices (their rows 0), the others are the oracle's, and the
  gradients, which reach every expert and the gate, are JAX's EP's
  (1e-4).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from dig_tpu.datasets import MoleculeLoader as JLoader
from dig_tpu.datasets import synthetic_molecules
from dig_tpu.models import SchNet as JSchNet
from dig_tpu.parallel import (concat_local_shards, make_dp_eval_step,
                              make_dp_train_step, make_mesh, replicate,
                              shard_graph_batch, tp_param_specs)
from dig_tpu.parallel.ep import (ep_shard_params, init_moe_params,
                                 make_ep_moe, moe_dense_reference)
from dig_tpu.train.trainer import make_train_state
from dig_tpu_torch.convert import schnet_from_flax
from dig_tpu_torch.models import SchNet
from dig_tpu_torch.parallel import spawn_local

import torch_parallel_ranks as ranks

P = 4
KW = dict(cutoff=5.0, num_layers=2, hidden_channels=32, num_filters=32,
          num_gaussians=16, max_edges=192)


def _flat(params):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        params["params"], sep="/").items()}


def _pp_layer(pl, h):
    return h + jnp.tanh(h @ pl["w"] + pl["b"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mols = [synthetic_molecules(4, seed=i, max_atoms=10, with_forces=True)
            for i in range(2)]
    shards = [next(iter(JLoader(m, 4, n_node_pad=48))) for m in mols]
    model = JSchNet(**KW)
    opt = optax.adam(1e-3)
    state0 = make_train_state(model, opt, shards[0], seed=0)
    flat0 = _flat(state0.params)
    L, F, M, mb = 8, 16, 6, 5
    kw, kb = jax.random.split(jax.random.PRNGKey(2))
    pp = {"w": 0.1 * jax.random.normal(kw, (L, F, F)),
          "b": 0.01 * jax.random.normal(kb, (L, F))}
    x = jax.random.normal(jax.random.PRNGKey(3), (M, mb, F))
    y = jax.random.normal(jax.random.PRNGKey(4), (M, mb, F))
    E = 16
    ep = init_moe_params(jax.random.PRNGKey(2), E, 12, 24, 8)
    xe = jax.random.normal(jax.random.PRNGKey(3), (64, 12))
    spec = {"tp": {"kw": KW, "flat": flat0, "mols": mols, "per": 4,
                   "pad": 48},
            "pp": {"params": jax.tree.map(np.asarray, pp),
                   "x": np.asarray(x), "y": np.asarray(y)},
            "ep": {"params": jax.tree.map(np.asarray, ep),
                   "x": np.asarray(xe), "E": E, "caps": (64, 2)}}
    # the ranks run while the JAX side compiles
    join = ranks.background(spawn_local, ranks.tp_pp_ep, P,
                            str(tmp_path_factory.mktemp("tp")), (spec,),
                            timeout=120)

    mesh_tp = make_mesh((2, 2), ("data", "model"),
                        devices=jax.devices()[:4])
    specs = tp_param_specs(state0.params, mesh_tp, min_shard=4)
    n_sharded = sum(s != PartitionSpec() for s in jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec)))
    mesh_dp = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    g = shard_graph_batch(concat_local_shards(shards), mesh_dp, "data")
    want_tp = {}
    fresh = lambda: replicate(jax.tree.map(jnp.copy, state0), mesh_dp)
    preds = np.asarray(make_dp_eval_step(model, mesh_dp)(
        fresh().params, g)[0])
    for eaf in (False, True):
        state = fresh()
        step = make_dp_train_step(model, opt, mesh_dp, energy_and_force=eaf,
                                  p=1.0)
        losses = []
        for _ in range(3):
            state, aux = step(state, g)
            losses.append(float(aux["loss"]))
        want_tp[eaf] = (losses, _flat(jax.device_get(state.params)))

    def seq(p):
        h = x
        for l in range(L):
            h = _pp_layer(jax.tree.map(lambda v: v[l], p), h)
        return h

    seq_loss = lambda p: jnp.mean((seq(p) - y) ** 2)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(seq_loss))(pp)
    pp_new = jax.tree.map(lambda a, b: a - 1e-2 * b, pp, g_ref)

    mesh_ep = make_mesh((P,), ("expert",), devices=jax.devices()[:P])
    pe = ep_shard_params(ep, mesh_ep)
    xx = jax.device_put(xe, NamedSharding(mesh_ep, PartitionSpec("expert")))
    apply = make_ep_moe(mesh_ep, E, capacity=2)

    def loss(p):
        yv, dropped = apply(p, xx)
        return jnp.sum(yv ** 2), (yv, dropped)
    (_, (yv, dropped)), gr = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(pe)

    def dense_loss(p):
        yv = moe_dense_reference(p, xe)
        return jnp.sum(yv ** 2), yv
    (_, dense), g_dense = jax.jit(jax.value_and_grad(
        dense_loss, has_aux=True))(ep)
    dense = np.asarray(dense)
    # capacity 64 drops nothing: the dense oracle's values and gradients
    want_ep = {2: (np.asarray(yv), int(dropped), jax.tree.map(np.asarray,
                                                              gr)),
               64: (dense, 0, jax.tree.map(np.asarray, g_dense))}
    got = join()
    return dict(got=got, want_tp=want_tp, preds=preds, n_sharded=n_sharded,
                seq=np.asarray(jax.jit(seq)(pp)), loss_ref=float(loss_ref),
                pp_new=jax.tree.map(np.asarray, pp_new), want_ep=want_ep,
                dense=dense, L=L)


@pytest.mark.parametrize("eaf", [False, True])
def test_tp_matches_dp(run, eaf):
    losses, flat = run["want_tp"][eaf]
    want = schnet_from_flax(flat, SchNet(device="cpu", **KW)).state_dict()
    for res in run["got"]:
        got = res[f"tp_{eaf}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(got["weights"][k], w.numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=k)
        assert got["n_shards"] == run["n_sharded"] >= 4
    for rank, res in enumerate(run["got"]):
        d = rank // 2      # the data row: its slab of 4 graphs
        np.testing.assert_allclose(res[f"tp_eval_{eaf}"],
                                   run["preds"][4 * d:4 * d + 4], rtol=1e-5,
                                   atol=1e-6)


def test_tp_shards_hold_a_quarter_or_half(run):
    full = sum(v.size for v in run["want_tp"][False][1].values())
    for res in run["got"]:
        got = res["tp_False"]
        assert got["shard_numel"] * 2 < full


def test_pp_apply_and_step_match_sequential(run):
    per = run["L"] // P
    for s, res in enumerate(run["got"]):
        np.testing.assert_allclose(res["pp_outs"], run["seq"], rtol=1e-5,
                                   atol=1e-6)
        assert res["pp_loss"] == pytest.approx(run["loss_ref"], rel=1e-5)
        for k, v in res["pp_params"].items():
            np.testing.assert_allclose(v, run["pp_new"][k][s * per:
                                                           (s + 1) * per],
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cap", [64, 2])
def test_ep_matches_jax_and_dense_oracle(run, cap):
    yj, dropped, gj = run["want_ep"][cap]
    y = np.concatenate([res["ep"][cap]["y"] for res in run["got"]])
    assert all(res["ep"][cap]["dropped"] == dropped for res in run["got"])
    kept = np.abs(yj).sum(1) > 0
    assert np.array_equal(np.abs(y).sum(1) > 0, kept)
    assert int((~kept).sum()) == dropped and (dropped > 0) == (cap == 2)
    np.testing.assert_allclose(y, yj, atol=1e-5)
    np.testing.assert_allclose(y[kept], run["dense"][kept], atol=1e-5)
    for r, res in enumerate(run["got"]):
        for k, g in res["ep"][cap]["grads"].items():
            if k != "wg":      # this rank's 4 experts
                np.testing.assert_allclose(g, gj[k][4 * r:4 * (r + 1)],
                                           rtol=1e-4, atol=1e-6, err_msg=k)
    # each rank's gate gradient covers its own tokens
    wg = sum(res["ep"][cap]["grads"]["wg"] for res in run["got"])
    np.testing.assert_allclose(wg, gj["wg"], rtol=1e-4, atol=1e-6)
    assert np.abs(wg).max() > 0
