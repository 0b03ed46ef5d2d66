"""The port's fairgraph against the JAX package's, on the CPU.

* ``synthetic_fair_graph`` and ``load_fair_dataset`` (a csv + edge-list
  fixture in ``tmp_path``): the same arrays, bit for bit (numpy on both
  sides);
* ``AugModule`` given the JAX draws and ``_simclr_loss``: float32, 1e-5
  relative (matrix products in another order);
* ``Graphair.fit_whole`` from the JAX initial weights
  (``convert.graphair_from_flax``, with ``Graphair.init`` patched out)
  and the JAX key sequence's uniforms replayed through ``Graphair.draw``: two warm-up steps alone, then two
  warm-up steps, eleven adversary steps and two main steps. Every weight
  is held to 1e-5 of the largest entry of its tensor plus 5% of one step
  (lr 1e-4, Adam-normalised steps of rounding-level gradients may differ
  by up to a step's size where a gradient entry is rounding noise);
  ``enc`` and ``proj`` do not move during the warm-up, as in optax.
* ``test``'s metrics from the JAX classifier's initial weights
  (``PRNGKey(0)``, through ``convert.fair_classifier_from_flax``, put in
  place of the port's ``Classifier``): equal to 1e-4 relative.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.fairgraph import dataset as jdata
from dig_tpu.fairgraph import graphair as jg
from dig_tpu_torch.convert import (fair_classifier_from_flax,
                                   graphair_from_flax)
from dig_tpu_torch.fairgraph import Graphair, load_fair_dataset, run
from dig_tpu_torch.fairgraph import synthetic_fair_graph
from dig_tpu_torch.fairgraph import graphair as tg

N, FEAT, HID = 40, 6, 16


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_fair_graph_identical(seed):
    a = synthetic_fair_graph(60, feat_dim=5, avg_deg=6, seed=seed)
    b = jdata.synthetic_fair_graph(60, feat_dim=5, avg_deg=6, seed=seed)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_load_fair_dataset_identical(tmp_path):
    rows = ["user_id,region,I_am_working_in_field,age,f2",
            "u1,1,1,20,0.5", "u2,0,0,31,", "u3,1,-1,42,2", "u4,0,1,,1"]
    (tmp_path / "region_job.csv").write_text("\n".join(rows) + "\n")
    (tmp_path / "region_job_relationship.txt").write_text(
        "u1 u2\nu2 u3\nu4 u1\nu9 u1\n")
    a = load_fair_dataset(str(tmp_path))
    b = jdata.load_fair_dataset(str(tmp_path))
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    with pytest.raises(FileNotFoundError):
        load_fair_dataset(str(tmp_path), name="NBA")


def _data():
    return jdata.synthetic_fair_graph(N, feat_dim=FEAT, avg_deg=6, seed=1)


def _draws(seed, count):
    """The uniforms of JAX ``fit_whole``'s first ``count`` steps."""
    key = jax.random.PRNGKey(seed)
    key = jax.random.split(key, 5)[-1]
    out = []
    for _ in range(count):
        key, k = jax.random.split(key)
        ka, kb = jax.random.split(k)
        u = lambda kk, s: np.asarray(jax.random.uniform(
            kk, s, minval=1e-6, maxval=1 - 1e-6))
        out.append((u(ka, (N, N)), u(kb, (N, FEAT))))
    return out


def _flat(variables):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        variables["params"], sep="/").items()}


class _JitModule:
    """A flax module whose ``init`` and ``apply`` run jitted: the JAX
    ``fit_whole`` calls them eagerly once (the initial weights), where
    each primitive would compile on its own. The same functions."""

    def __init__(self, module):
        self.init = jax.jit(module.init)
        self.apply = jax.jit(module.apply)


def _jax_graphair():
    jm = jg.Graphair(FEAT, num_hidden=HID)
    for part in ("aug", "enc", "adv", "proj"):
        setattr(jm, part, _JitModule(getattr(jm, part)))
    return jm


@pytest.fixture(scope="module")
def trained():
    """JAX's initial weights (``fit_whole(0)``) and its weights after two
    warm-up steps and two epochs, the port's after the same steps from
    the initial weights and JAX's draws, and the port's after the two
    warm-up steps alone."""
    d = _data()
    jm = _jax_graphair()
    p0 = jm.fit_whole(0, d["adj"], d["x"], d["sens"], d["idx_sens_train"],
                      seed=5)
    pj = jm.fit_whole(2, d["adj"], d["x"], d["sens"], d["idx_sens_train"],
                      warmup=2, seed=5)
    out = {}
    for warmup, epochs in ((2, 0), (2, 2)):
        tm = Graphair(FEAT, num_hidden=HID, device="cpu")
        graphair_from_flax(p0, tm)
        steps = warmup + sum(11 if e == 0 else 2 for e in range(epochs))
        it = iter(_draws(5, steps))
        tm.draw = lambda gen, n, f: tuple(torch.tensor(a) for a in next(it))
        tm.init = lambda seed: None         # keep JAX's initial weights
        tm.fit_whole(epochs, d["adj"], d["x"], d["sens"],
                     d["idx_sens_train"], warmup=warmup, seed=5)
        out[(warmup, epochs)] = tm
    return d, p0, pj, jm, out


def test_augmodule_and_simclr_match(trained):
    d, p0, _, _, _ = trained
    tm = Graphair(FEAT, num_hidden=HID, device="cpu")
    graphair_from_flax(p0, tm)
    adj_n = jg.normalize_adj(jnp.asarray(d["adj"]))
    key = jax.random.PRNGKey(7)
    a_j, x_j, l_j = jax.jit(jg.AugModule(FEAT, HID).apply)(
        p0["aug"], adj_n, jnp.asarray(d["x"]), key,
        adj_orig=jnp.asarray(d["adj"]))
    ka, kb = jax.random.split(key)
    u = lambda kk, s: torch.tensor(np.asarray(jax.random.uniform(
        kk, s, minval=1e-6, maxval=1 - 1e-6)))
    with torch.no_grad():
        a_t, x_t, l_t = tm.aug(tg.normalize_adj(torch.tensor(d["adj"])),
                               torch.tensor(d["x"]),
                               (u(ka, (N, N)), u(kb, (N, FEAT))),
                               adj_orig=torch.tensor(d["adj"]))
    assert _rel(l_t, l_j) < 1e-5
    assert _rel(a_t, a_j) < 1e-5 and _rel(x_t, x_j) < 1e-5
    z = np.random.default_rng(0).normal(size=(2 * N, HID)).astype(np.float32)
    assert _rel(tg._simclr_loss(torch.tensor(z)),
                jg._simclr_loss(jnp.asarray(z))) < 1e-5


def _port_flat(tm):
    """The port's weights under the flax names (kernels [in, out])."""
    lins = {"aug": {"GCNBody_0/Dense_0": tm.aug.body.layers[0],
                    "Dense_0": tm.aug.edge_out, "Dense_1": tm.aug.edge_in,
                    "Dense_2": tm.aug.mask_out, "Dense_3": tm.aug.mask_in},
            "enc": {f"Dense_{i}": lin for i, lin in enumerate(tm.enc.layers)},
            "adv": {"Dense_0": tm.adv.lin1, "Dense_1": tm.adv.lin2},
            "proj": {"Dense_0": tm.proj.lin_out, "Dense_1": tm.proj.lin_in}}
    out = {}
    for part, named in lins.items():
        out[part] = {}
        for name, lin in named.items():
            out[part][f"{name}/kernel"] = lin.weight.detach().numpy().T
            out[part][f"{name}/bias"] = lin.bias.detach().numpy()
    return out


@pytest.mark.parametrize("case", [(2, 0), (2, 2)])
def test_graphair_steps_match(trained, case):
    """(2, 2): every weight against JAX's. (2, 0): the warm-up alone moves
    ``aug`` only, and the shared optimiser's count and moments advance for
    ``enc`` and ``proj`` with zero gradients (their moments stay 0), as
    optax's does under JAX's ``warm_step``."""
    _, p0, pj, _, out = trained
    tm = out[case]
    got = _port_flat(tm)
    lr = 1e-4
    if case == (2, 0):
        opt = tm.opt_main
        assert opt.count == 2
        for part in ("aug", "enc", "adv", "proj"):
            start = _flat(p0[part])
            moved = [not np.array_equal(got[part][k], v)
                     for k, v in start.items()]
            assert all(moved) if part == "aug" else not any(moved), part
        for p, m, v in zip(opt.params[tm.n_aug:], opt.m[tm.n_aug:],
                           opt.v[tm.n_aug:]):
            assert not m.any() and not v.any()
        return
    for part in ("aug", "enc", "adv", "proj"):
        want = _flat(pj[part])
        for k, w in want.items():
            g = got[part][k]
            tol = 1e-5 * max(np.abs(w).max(), 1e-12) + 0.05 * lr
            assert np.abs(g - w).max() <= tol, (part, k,
                                                 np.abs(g - w).max())


def test_graphair_test_metrics_match(trained, monkeypatch):
    d, _, _, jm, out = trained
    tm = out[(2, 2)]
    h = jm.embed()
    assert _rel(tm.embed(), h) < 1e-4
    clf_vars = jg.Classifier().init(jax.random.PRNGKey(0), jnp.asarray(h))
    clf = fair_classifier_from_flax(clf_vars, tg.Classifier(HID))
    monkeypatch.setattr(tg, "Classifier", lambda in_dim: clf)
    want = jm.test(d["y"], d["sens"], d["idx_train"], d["idx_test"],
                   epochs=40)
    got = tm.test(d["y"], d["sens"], d["idx_train"], d["idx_test"],
                  epochs=40)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def test_run_end_to_end():
    data = synthetic_fair_graph(60, seed=0)
    res = run(data, epochs=3, warmup=2, classifier_epochs=20,
              num_hidden=16, device="cpu")
    assert 0.0 <= res["accuracy"] <= 1.0
    assert 0.0 <= res["dp"] <= 100.0 and 0.0 <= res["eo"] <= 100.0
