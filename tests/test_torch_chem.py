"""``dig_tpu_torch.chem`` and the ggraph host modules (``dataset``,
``environment``, ``evaluation``) against the JAX package's, bit for bit,
over ``tests/test_chem.py``'s SMILES and the synthetic generation corpus
(``_SYNTH_SMILES``). These modules import no framework; the port keeps
its own copies, and every output here must be the same value (strings,
booleans, arrays and floats compared with ``==``)."""
import numpy as np
import pytest

from dig_tpu import chem as jchem
from dig_tpu.chem import descriptors as jdesc
from dig_tpu.chem.mol import bfs_order as j_bfs
from dig_tpu.ggraph import dataset as jds
from dig_tpu.ggraph import environment as jenv
from dig_tpu.ggraph import evaluation as jev
from dig_tpu_torch import chem as tchem
from dig_tpu_torch.chem import descriptors as tdesc
from dig_tpu_torch.chem.mol import bfs_order as t_bfs
from dig_tpu_torch.ggraph import dataset as tds
from dig_tpu_torch.ggraph import environment as tenv
from dig_tpu_torch.ggraph import evaluation as tev

CHEM_SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "c1ccc2ccccc2c1",
               "C1CCCCC1", "N#Cc1ccccc1", "c1cc[nH]c1", "c1ccncc1", "c1ccoc1",
               "CN1C=NC2=C1C(=O)N(C)C(=O)N2C", "CC(C)(C)c1ccc(O)cc1",
               "O=C(O)c1ccccc1", "FC(F)(F)c1ccccc1"]
ALL = CHEM_SMILES + sorted(set(jds._SYNTH_SMILES))


def _mol_key(m):
    return ([(a.z, a.charge, a.n_explicit_h, a.aromatic) for a in m.atoms],
            sorted(m.bonds.items()))


@pytest.mark.parametrize("s", ALL)
def test_chem_bit_for_bit(s):
    jm, tm = jchem.mol_from_smiles(s), tchem.mol_from_smiles(s)
    assert _mol_key(jm) == _mol_key(tm)
    assert jchem.mol_to_smiles(jm) == tchem.mol_to_smiles(tm)
    assert jchem.check_valency(jm) == tchem.check_valency(tm)
    assert jchem.canonical_hash(jm) == tchem.canonical_hash(tm)
    jo, to = j_bfs(jm), t_bfs(tm)
    assert jo == to
    for atoms, n in (([6, 7, 8, 9], 9), (jds.ATOM_LIST_ZINC, 38)):
        if all(a.z in atoms for a in jm.atoms) and jm.num_atoms <= n:
            for a, b in zip(jchem.mol_to_dense(jm, atoms, n, jo),
                            tchem.mol_to_dense(tm, atoms, n, to)):
                np.testing.assert_array_equal(a, b)
            jx, jadj = jchem.mol_to_dense(jm, atoms, n, jo)
            assert jchem.canonical_hash(jchem.mol_from_dense(
                jx, jadj, atoms)) == tchem.canonical_hash(
                tchem.mol_from_dense(jx, jadj, atoms))
    for name in ("crippen_logp", "penalized_logp", "qed_proxy",
                 "sa_score_proxy", "num_long_cycles", "largest_cycle_len"):
        assert getattr(jdesc, name)(jm) == getattr(tdesc, name)(tm), name
    for name in ("check_chemical_validity", "calculate_min_plogp",
                 "qed_score", "steric_strain_filter", "zinc_molecule_filter"):
        assert getattr(jenv, name)(jm) == getattr(tenv, name)(tm), name
    np.testing.assert_array_equal(jenv.morgan_fingerprint(jm),
                                  tenv.morgan_fingerprint(tm))
    ref = "c1ccccc1O"
    assert jenv.reward_target_molecule_similarity(
        jm, jchem.mol_from_smiles(ref)) == \
        tenv.reward_target_molecule_similarity(tm, tchem.mol_from_smiles(ref))
    assert jchem.RDKIT_AVAILABLE == tchem.RDKIT_AVAILABLE


def test_dataset_and_loader_batches():
    for kw in (dict(repeat=2), dict(repeat=1, with_props=True),
               dict(max_size=20, repeat=1)):
        j, t = jds.synthetic_smiles_dataset(**kw), tds.synthetic_smiles_dataset(
            **kw)
        assert j.smiles == t.smiles and j.y == t.y
        for kl in (dict(batch_size=16, shuffle=True, seed=3),
                   dict(batch_size=7)):
            jl, tl = jds.DenseMolLoader(j, **kl), tds.DenseMolLoader(t, **kl)
            assert len(jl) == len(tl)
            for _ in range(2):          # two epochs: the shuffles advance
                for jb, tb in zip(jl, tl):
                    assert set(jb) == set(tb)
                    for k in jb:
                        np.testing.assert_array_equal(jb[k], tb[k])
    assert jds.ATOM_LIST_QM9 == tds.ATOM_LIST_QM9
    assert jds.ATOM_LIST_ZINC == tds.ATOM_LIST_ZINC
    for name in ("qm9_dense", "zinc250k_dense"):   # no CSV here: both raise
        for mod in (jds, tds):
            with pytest.raises(FileNotFoundError):
                getattr(mod, name)(root="/nonexistent")


def test_evaluators():
    smiles = ["CCO", "CCO", "CCC", "c1ccccc1", "CC(=O)O", "C1CC1"]
    jm = [jchem.mol_from_smiles(s) for s in smiles] + [None]
    tm = [tchem.mol_from_smiles(s) for s in smiles] + [None]
    train = ["CCO", "CCN"]
    assert jev.RandGenEvaluator().eval({"mols": jm, "train_smiles": train}) \
        == tev.RandGenEvaluator().eval({"mols": tm, "train_smiles": train})
    for prop in ("plogp", "qed"):
        assert jev.PropOptEvaluator(prop_name=prop).eval({"mols": jm}) == \
            tev.PropOptEvaluator(prop_name=prop).eval({"mols": tm})
    inp = ["CCO", "CCC", "c1ccccc1"]
    outs = ["CCCO", "CCCC", "Cc1ccccc1"]
    d = {"inp_smiles": inp}
    jd, td = dict(d), dict(d)
    for k in ("mols_0", "mols_2", "mols_4", "mols_6"):
        jd[k] = [jchem.mol_from_smiles(s) for s in outs]
        td[k] = [tchem.mol_from_smiles(s) for s in outs]
    assert jev.ConstPropOptEvaluator().eval(jd) == \
        tev.ConstPropOptEvaluator().eval(td)
