"""The port's ProNet against the JAX package's, on the CPU: the three
levels (``aminoacid``, ``backbone``, ``allatom``) on the flat layout and
the NK-blocked one, deterministic, and with the training noise (Euler-angle
noise, per-block feature noise, dropout) drawn once and given to both.

Flax weights go into the port with ``pronet_from_flax``. Inputs: four
seeded synthetic proteins of 8-12 residues (``ProteinLoader``; slots of
12 residues for the NK table, K = 11 keeps every pair), 2 blocks x 32
channels, mid_emb 16, n = 2, k = 3, cutoff 8. The JAX side is jitted once
per case.

Random draws cannot match across JAX's and torch's generators, so the
noise test records the draws the JAX model asks ``jax.random.normal`` and
``jax.random.bernoulli`` for (seeded numpy arrays) and replays them, in
the same order, through the port's two draw functions.

Tolerances: outputs 1e-5 and dE/dpos 1e-5 of the largest entry (float32
sums in another order).
"""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.datasets import ProteinLoader as JLoader
from dig_tpu.models import ProNet as JProNet
from dig_tpu_torch.convert import pronet_from_flax
from dig_tpu_torch.datasets import ProteinLoader as TLoader
from dig_tpu_torch.datasets import synthetic_proteins
from dig_tpu_torch.models import ProNet
from dig_tpu_torch.models import pronet as tpronet

A = 12
KW = dict(num_blocks=2, hidden_channels=32, mid_emb=16, cutoff=8.0,
          num_radial=3, num_spherical=2)
LAYOUTS = {"flat": dict(max_edges=4096, max_num_neighbors=16),
           "nk_blocked": dict(nk_degree=11, block_size=A)}
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _data(layout):
    prots = synthetic_proteins(4, seed=5, min_res=8, max_res=A)
    kw = dict(slot_size=A) if layout == "nk_blocked" else {}
    return (next(iter(JLoader(prots, 4, **kw))),
            next(iter(TLoader(prots, 4, device="cpu", **kw))))


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@functools.lru_cache(maxsize=None)
def _params(level):
    """One flax parameter set per level: both layouts hold the same
    parameters."""
    jb, _ = _data("flat")
    return jax.jit(JProNet(**KW, level=level, **LAYOUTS["flat"]).init)(
        jax.random.PRNGKey(0), jb)


def _pair(level, layout, **extra):
    kw = dict(KW, level=level, **LAYOUTS[layout], **extra)
    jb, tb = _data(layout)
    params = _params(level)
    tm = pronet_from_flax(_flat(params["params"]),
                          ProNet(device="cpu", **kw))
    return JProNet(**kw), params, tm, jb, tb


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("level", ["aminoacid", "backbone", "allatom"])
def test_outputs_and_forces_match_jax(level, layout):
    jm, params, tm, jb, tb = _pair(level, layout)

    def esum(pos):
        e = jm.apply(params, jb.replace(nodes={**jb.nodes, "pos": pos}))
        return jnp.sum(jnp.where(jb.graph_mask[:, None], e, 0.0)), e
    (_, e_j), g_j = jax.jit(jax.value_and_grad(esum, has_aux=True))(
        jb.nodes["pos"])
    pos = tb.nodes["pos"].clone().requires_grad_()
    e_t = tm(tb.replace_nodes(pos=pos))
    (g_t,) = torch.autograd.grad(
        torch.where(tb.graph_mask[:, None], e_t, 0.0).sum(), pos)
    assert e_t.shape == (4, 1)
    assert _rel(e_t.detach().numpy(), e_j) < TOL
    assert bool(torch.isfinite(g_t).all()) and float(g_t.abs().max()) > 0
    assert _rel(g_t.numpy(), g_j) < TOL


def test_training_noise_given_to_both(monkeypatch):
    """allatom, flat: Euler noise, feature noise before each block and
    dropout 0.2, every draw the same numpy array in both packages."""
    noise = dict(euler_noise=True, data_augment_eachlayer=True, dropout=0.2)
    jm, params, tm, jb, tb = _pair("allatom", "flat", **noise)
    rng = np.random.default_rng(7)
    drawn = []

    def j_normal(key, shape=(), dtype=jnp.float32):
        drawn.append(("normal", rng.normal(size=shape).astype(np.float32)))
        return jnp.asarray(drawn[-1][1])

    def j_bernoulli(key, p=0.5, shape=None):
        drawn.append(("keep", rng.random(shape) < p))
        return jnp.asarray(drawn[-1][1])
    monkeypatch.setattr(jax.random, "normal", j_normal)
    monkeypatch.setattr(jax.random, "bernoulli", j_bernoulli)
    want = jax.jit(functools.partial(jm.apply, deterministic=False))(
        params, jb, rngs={"noise": jax.random.PRNGKey(1),
                          "dropout": jax.random.PRNGKey(2)})
    monkeypatch.undo()
    # one Euler draw, per block a feature draw and three dropout masks,
    # the readout's mask
    assert [k for k, _ in drawn] == ["normal"] + (
        ["normal"] + ["keep"] * 3) * 2 + ["keep"]
    replay = iter(drawn)

    def nxt(kind, shape):
        k, arr = next(replay)
        assert k == kind and arr.shape == tuple(shape)
        return torch.tensor(arr)
    monkeypatch.setattr(tpronet, "_standard_normal",
                        lambda shape, gen, dev: nxt("normal", shape))
    monkeypatch.setattr(tpronet, "_keep_mask",
                        lambda keep, shape, gen, dev: nxt("keep", shape))
    got = tm(tb, deterministic=False)
    assert next(replay, None) is None
    assert _rel(got.detach().numpy(), want) < TOL
    monkeypatch.undo()
    # without the replay: the caller's generator decides the draws, and
    # deterministic=True takes none
    run = lambda s: tm(tb, deterministic=False,
                       generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    quiet = _pair("allatom", "flat")[2]
    assert torch.equal(tm(tb), quiet(tb))
