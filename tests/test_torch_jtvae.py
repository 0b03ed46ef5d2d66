"""``dig_tpu_torch.ggraph.jtvae`` / ``jtmpn`` against ``dig_tpu.ggraph``'s
on the CPU, the JAX weights carried across with ``dig_tpu_torch.convert``.

* host code bit for bit: ``tree_decomp`` (cliques, edges, labels),
  ``Vocab``, ``_dfs_steps``, ``batch_trees``, ``merge_at`` /
  ``enumerate_candidates`` (canonical hashes in order), greedy
  ``assemble``, ``build_assembly_fixtures`` and ``featurize``;
* ``JTVAEModel`` at ``tests/test_ggraph.py``'s widths (hidden 24, latent
  12), with and without the property head, given the reparameterisation
  normals the JAX model draws from the same key (the test replays its
  ``jax.random`` calls): the loss and its parts 1e-5 (relative), every
  parameter's gradient 1e-4 of its largest value (float32, sums in
  another order); ``decode_steps``' labels exactly and its expand
  probabilities 1e-5; the property head's latent ascent 1e-5;
  ``run_rand_gen`` given the JAX prior latents: the same molecules (the
  case without the property head is marked ``slow``: the case with it
  runs the same code);
* the JTMPN scorer: scores 1e-5, one Adam step of the assembly loss: loss
  1e-5, gradients 1e-4, every weight after the step within 5% of the step
  size (lr), but for the entries whose gradient is rounding noise (below
  1e-6 of the largest: directions a softmax over the candidates does not
  see, such as the output bias) in both packages, which move by at most
  one step; ``assemble_scored`` with that scorer: the same molecules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dig_tpu.chem import canonical_hash as j_hash
from dig_tpu.chem import mol_from_smiles as j_smiles
from dig_tpu.ggraph import jtmpn as jj
from dig_tpu.ggraph import jtvae as jv
from dig_tpu_torch.chem import canonical_hash
from dig_tpu_torch.chem import mol_from_smiles
from dig_tpu_torch.convert import jtmpn_from_flax, jtvae_from_flax
from dig_tpu_torch.ggraph import jtmpn as tj
from dig_tpu_torch.ggraph import jtvae as tv

SMILES = ["CCO", "CCN", "CCC", "CC=O", "C1CC1", "c1ccccc1", "CC(C)O",
          "CC(N)=O", "CCOC", "CNC", "CC(=O)Oc1ccccc1C(=O)O", "c1ccc2ccccc2c1",
          "c1ccncc1C", "CC(C)(C)O", "CN1C=NC2=C1C(=O)N(C)C(=O)N2C"]
HIDDEN, LATENT = 24, 12
VAL_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max(initial=0.0)
                 / max(np.abs(b).max(initial=0.0), 1e-12))


def _amax(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


NOISE = 1e-6     # a gradient entry below NOISE x the largest is rounding


def _grads_vs(port, jgrads, convert, make):
    """Each parameter's gradient against JAX's, 1e-4 of its largest
    value; a parameter whose JAX gradient is all below NOISE x the
    model's largest entry (a direction the loss does not depend on) must
    have the same in the port. Returns JAX's gradients by name."""
    ref = {k: p.detach() for k, p in convert(
        {"params": jgrads}, make()).named_parameters()}
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in port.named_parameters()}
    top = max(float(p.abs().max()) for p in ref.values())
    for k, p in ref.items():
        if float(p.abs().max()) < NOISE * top:
            assert float(got[k].abs().max()) < NOISE * top, k
        else:
            assert _rel(got[k], p) < GRAD_TOL, (k, _rel(got[k], p))
    return ref, top


@pytest.fixture(scope="module")
def trees():
    jm = [j_smiles(s) for s in SMILES]
    tm = [mol_from_smiles(s) for s in SMILES]
    return ([jv.tree_decomp(m) for m in jm], [tv.tree_decomp(m) for m in tm],
            jv.Vocab.build(jm), tv.Vocab.build(tm))


def test_tree_vocab_batch_bit_for_bit(trees):
    jt, tt, jvoc, tvoc = trees
    for a, b in zip(jt, tt):
        assert (a.cliques, a.edges, a.labels) == (b.cliques, b.edges, b.labels)
        assert jv._dfs_steps(a, jvoc, 12) == tv._dfs_steps(b, tvoc, 12)
    assert jvoc.hash_to_id == tvoc.hash_to_id
    assert [j_hash(f) for f in jvoc.fragments] == \
        [canonical_hash(f) for f in tvoc.fragments]
    jb, tb = jv.batch_trees(jt, jvoc), tv.batch_trees(tt, tvoc)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy(), k)
    jf = [jvoc.fragments[i] for i in (0, 3, 1, 5)]
    tf = [tvoc.fragments[i] for i in (0, 3, 1, 5)]
    assert j_hash(jv.assemble(jf)) == canonical_hash(tv.assemble(tf))


def test_candidates_fixtures_featurize():
    pairs = [("CC", "CO"), ("c1ccccc1", "CC"), ("C1CCC1", "C1CC1"),
             ("CC(=O)O", "c1ccncc1")]
    for m, f in pairs:
        jc = jj.enumerate_candidates(j_smiles(m), j_smiles(f))
        tc = tj.enumerate_candidates(mol_from_smiles(m), mol_from_smiles(f))
        assert [j_hash(c) for c in jc] == [canonical_hash(c) for c in tc]
    jm = [j_smiles(s) for s in SMILES]
    tm = [mol_from_smiles(s) for s in SMILES]
    jfx, tfx = jj.build_assembly_fixtures(jm), tj.build_assembly_fixtures(tm)
    assert len(jfx) == len(tfx) >= 5
    for a, b in zip(jfx, tfx):
        assert a["label"] == b["label"]
        assert [j_hash(c) for c in a["cands"]] == \
            [canonical_hash(c) for c in b["cands"]]
        for x, y in zip(jj.featurize(a["cands"]), tj.featurize(b["cands"])):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert jj.greedy_accuracy(jfx) == tj.greedy_accuracy(tfx)


# the property head's model runs every part of the one without it (the
# loss without the head is its loss less the property term) and the
# generation besides: the case without the head is slow (about 30
# worker-seconds, most of it the JAX side's compiles) and left to
# ``-m slow``
@pytest.mark.parametrize("prop", [pytest.param(False, marks=pytest.mark.slow),
                                  True])
def test_jtvae_loss_grads_decode(trees, prop):
    jt, tt, jvoc, tvoc = trees
    jb, tb = jv.batch_trees(jt[:8], jvoc), tv.batch_trees(tt[:8], tvoc)
    if prop:
        props = np.linspace(-1.0, 2.0, 8).astype(np.float32)
        jb["props"], tb["props"] = jnp.asarray(props), torch.tensor(props)
    jm = jv.JTVAEModel(len(jvoc), HIDDEN, LATENT, predict_prop=prop)
    key = jax.random.PRNGKey(7)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jb, key))
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jb, key), has_aux=True))(
        v["params"])
    make = lambda: tv.JTVAEModel(len(tvoc), HIDDEN, LATENT, predict_prop=prop)
    tm = jtvae_from_flax(v, make())
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.tensor(np.asarray(jax.random.normal(k, (8, LATENT // 2))))
                  for k in (k1, k2))
    loss, aux = tm(tb, noise)
    loss.backward()
    assert _rel(loss, jloss) < VAL_TOL
    assert set(aux) == set(jaux)
    for k in aux:
        assert _rel(aux[k], jaux[k]) < VAL_TOL, k
    _grads_vs(tm, _np(jg), jtvae_from_flax, make)
    lat = np.random.default_rng(1).normal(size=(5, LATENT)).astype(np.float32)
    jl, jtp = jax.jit(lambda v, z: jm.apply(v, z, 8, method="decode_steps"))(
        v, lat)
    with torch.no_grad():
        tl, ttp = tm.decode_steps(torch.tensor(lat), 8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert _rel(ttp, jtp) < VAL_TOL
    # the methods: prior latents drawn by JAX from PRNGKey(seed), passed in
    j = jv.JTVAE(jvoc, HIDDEN, LATENT)
    j.model, j.params = jm, v
    t = tv.JTVAE(tvoc, HIDDEN, LATENT)
    t.model, t.params = tm, tm.state_dict()
    prior = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, LATENT)))
    if prop:
        assert _rel(t._ascend(lat, 1.0, 4), j._ascend(lat, 1.0, 4)) < VAL_TOL
    jmols = j.run_rand_gen(n_mols=4, seed=3)
    tmols = t.run_rand_gen(n_mols=4, latents=prior)
    assert [j_hash(m) for m in jmols] == [canonical_hash(m) for m in tmols]


def test_jtmpn_scorer_step():
    mols = [j_smiles(s) for s in SMILES]
    fx = jj.build_assembly_fixtures(mols)
    f = max(fx, key=lambda f: len(f["cands"]))
    feats = jj.featurize(f["cands"])
    js = jj.JTMPNScorer(hidden=16, depth=2)
    v = _np(jax.jit(js.init)(jax.random.PRNGKey(0), *feats))
    lr = 1e-3

    def jloss_fn(p):
        return -jax.nn.log_softmax(js.apply({"params": p}, *feats))[f["label"]]
    import optax
    opt = optax.adam(lr)

    @jax.jit
    def jstep(p):
        loss, g = jax.value_and_grad(jloss_fn)(p)
        upd, _ = opt.update(g, opt.init(p), p)
        return loss, g, optax.apply_updates(p, upd), js.apply({"params": p},
                                                               *feats)
    jloss, jg, jnew, jscores = _np(jstep(v["params"]))
    make = lambda: tj.JTMPNScorer(hidden=16, depth=2)
    ts = jtmpn_from_flax(v, make())
    tfeats = tj.featurize([c for c in tj.build_assembly_fixtures(
        [mol_from_smiles(s) for s in SMILES])[fx.index(f)]["cands"]])
    with torch.no_grad():
        assert _rel(ts(*tfeats), jscores) < VAL_TOL
    topt = torch.optim.Adam(ts.parameters(), lr)
    loss = tj.scorer_loss(ts, *tfeats, f["label"])
    loss.backward()
    assert _rel(loss, jloss) < VAL_TOL
    ref, top = _grads_vs(ts, _np(jg), jtmpn_from_flax, make)
    before = {k: w.detach().clone() for k, w in ts.state_dict().items()}
    topt.step()
    # Adam's first step is lr * g / (|g| + eps): an entry whose gradient is
    # rounding noise (a direction the softmax over candidates does not
    # see: the output bias, a pooled unit active in every candidate) moves
    # by up to lr with the sign of that noise, in each package its own
    want = jtmpn_from_flax({"params": jnew}, make()).state_dict()
    for k, w in ts.state_dict().items():
        noise = ref[k].abs() < NOISE * top
        for moved in (w - before[k], want[k] - before[k]):
            assert _amax(moved[noise]) <= lr * (1 + STEP_TOL), k
        assert _amax((w - want[k])[~noise]) / lr < STEP_TOL, k
    # assembly with the scorer: the same molecules
    frags = [j_smiles(s) for s in ("c1ccccc1", "CC", "CO")]
    tfrags = [mol_from_smiles(s) for s in ("c1ccccc1", "CC", "CO")]
    assert j_hash(jj.assemble_scored(frags, js, {"params": jnew})) == \
        canonical_hash(tj.assemble_scored(tfrags, ts))
