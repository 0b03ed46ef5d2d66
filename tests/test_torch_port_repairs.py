"""Repairs of the port against the reference, on the CPU:

* ``fused_triplet_product`` / ``fused_angle_product`` take ``tile_e`` in
  the JAX signature's place (``(..., mask2d, K, tile_e=128,
  basis_grads=True)``), so JAX's positional call form means the same in
  both packages (float32, 1e-5 of the largest value: sums in another
  order);
* the package namespaces mirror the JAX package's (the top level, ``ops``,
  ``models``, ``lsgraph``, ``ssl``, ``datasets``, ``auggraph``, ``chem``,
  ``ggraph``, ``ggraph.models``, ``ggraph3d``, ``xgraph``, ``oodgraph``,
  ``fairgraph``, ``parallel`` and ``train``), less a named list of names
  still to port, now empty;
* no module of the port (the ``ggraph3d`` and ``xgraph`` ones among them),
  and not ``chip_smoke.py``, imports ``jax``, ``flax``, ``optax`` or
  ``dig_tpu`` (their import statements, read with ``ast``);
* the per-graph readout and the row gathers are sums a card repeats bit
  for bit: ``readout_sum`` builds its row pointer from the running maximum
  of the masked graph ids, so a slot-aligned batch with padding rows
  inside the slots (they carry the last graph's id) sums as ``index_add_``
  does (float32, 1e-6: sums in another order), and ``gather_rows`` is
  ``x[idx]`` with the same derivatives to second order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dig_tpu
import dig_tpu.auggraph
import dig_tpu.chem
import dig_tpu.datasets
import dig_tpu.fairgraph
import dig_tpu.ggraph
import dig_tpu.ggraph.models
import dig_tpu.ggraph3d
import dig_tpu.lsgraph
import dig_tpu.models
import dig_tpu.oodgraph
import dig_tpu.ops
import dig_tpu.parallel
import dig_tpu.ssl
import dig_tpu.train
import dig_tpu.xgraph
import dig_tpu_torch
import dig_tpu_torch.auggraph
import dig_tpu_torch.chem
import dig_tpu_torch.datasets
import dig_tpu_torch.fairgraph
import dig_tpu_torch.ggraph
import dig_tpu_torch.ggraph.models
import dig_tpu_torch.ggraph3d
import dig_tpu_torch.lsgraph
import dig_tpu_torch.models
import dig_tpu_torch.oodgraph
import dig_tpu_torch.ops
import dig_tpu_torch.parallel
import dig_tpu_torch.ssl
import dig_tpu_torch.train
import dig_tpu_torch.xgraph
from dig_tpu.ops.pallas_triplet import fused_angle_product as j_angle
from dig_tpu.ops.pallas_triplet import fused_triplet_product as j_product
from dig_tpu_torch.datasets import MoleculeLoader, synthetic_molecules
from dig_tpu_torch.ops.segment import (gather_rows, readout_sum, segment_sum,
                                       segment_sum_sorted)
from dig_tpu_torch.ops.segment_csr import csr_block_overflow, full_window
from dig_tpu_torch.ops.triplet_product import (fused_angle_product,
                                               fused_triplet_product)

# JAX names the port has not ported yet (none is left in these sixteen
# namespaces); the port's own names beside the reference's (the JAX
# package keeps spmm_bidir_sell in dig_tpu.ops.segment only; its train
# namespace exports only the trainer's entry points and the debug and
# profiling names, its parallel namespace not the partitioner's
# refinement and edge cut; the port adds its process-group helpers)
TO_PORT = {"dig_tpu": set(), "dig_tpu.ops": set(), "dig_tpu.models": set(),
           "dig_tpu.lsgraph": set(), "dig_tpu.ssl": set(),
           "dig_tpu.datasets": set(), "dig_tpu.auggraph": set(),
           "dig_tpu.chem": set(), "dig_tpu.ggraph": set(),
           "dig_tpu.ggraph.models": set(), "dig_tpu.ggraph3d": set(),
           "dig_tpu.xgraph": set(), "dig_tpu.oodgraph": set(),
           "dig_tpu.fairgraph": set(), "dig_tpu.parallel": set(),
           "dig_tpu.train": set()}
PORT_ONLY = {"dig_tpu": {"resolve_device"},
             "dig_tpu.ops": {"fused_triplet_pt", "basis_pt", "pt_rows",
                             "cosine_cutoff", "gaussian_rbf", "MASK_DIST",
                             "cfconv_fused", "cfconv_reference",
                             "spmm_bidir_sell"},
             "dig_tpu.models": set(), "dig_tpu.lsgraph": set(),
             "dig_tpu.ssl": set(), "dig_tpu.datasets": set(),
             "dig_tpu.auggraph": set(), "dig_tpu.chem": set(),
             "dig_tpu.ggraph": set(), "dig_tpu.ggraph.models": set(),
             "dig_tpu.ggraph3d": set(), "dig_tpu.xgraph": set(),
             "dig_tpu.oodgraph": set(), "dig_tpu.fairgraph": set(),
             "dig_tpu.parallel": {"refine_partition", "edge_cut",
                                  "initialize", "init_local",
                                  "spawn_local"},
             "dig_tpu.train": {"Checkpointer", "partial_restore",
                               "Throughput", "TrainState",
                               "bucketed_force_loss", "dense_loss",
                               "energy_force", "evaluate",
                               "make_bucketed_step_fns",
                               "make_dense_step_fns", "step_lr"}}
REF = {"dig_tpu": (dig_tpu, dig_tpu_torch),
       "dig_tpu.ops": (dig_tpu.ops, dig_tpu_torch.ops),
       "dig_tpu.models": (dig_tpu.models, dig_tpu_torch.models),
       "dig_tpu.lsgraph": (dig_tpu.lsgraph, dig_tpu_torch.lsgraph),
       "dig_tpu.ssl": (dig_tpu.ssl, dig_tpu_torch.ssl),
       "dig_tpu.datasets": (dig_tpu.datasets, dig_tpu_torch.datasets),
       "dig_tpu.auggraph": (dig_tpu.auggraph, dig_tpu_torch.auggraph),
       "dig_tpu.chem": (dig_tpu.chem, dig_tpu_torch.chem),
       "dig_tpu.ggraph": (dig_tpu.ggraph, dig_tpu_torch.ggraph),
       "dig_tpu.ggraph.models": (dig_tpu.ggraph.models,
                                 dig_tpu_torch.ggraph.models),
       "dig_tpu.ggraph3d": (dig_tpu.ggraph3d, dig_tpu_torch.ggraph3d),
       "dig_tpu.xgraph": (dig_tpu.xgraph, dig_tpu_torch.xgraph),
       "dig_tpu.oodgraph": (dig_tpu.oodgraph, dig_tpu_torch.oodgraph),
       "dig_tpu.fairgraph": (dig_tpu.fairgraph, dig_tpu_torch.fairgraph),
       "dig_tpu.parallel": (dig_tpu.parallel, dig_tpu_torch.parallel),
       "dig_tpu.train": (dig_tpu.train, dig_tpu_torch.train)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_product_ops_take_jax_positional_tile_e():
    """``(..., m2d, 4, 16, False)`` (tests/test_pallas_triplet.py:57):
    tile_e 16, basis gradients off, in both packages."""
    rng = np.random.default_rng(0)
    E, K, C, S1, S2 = 9, 4, 8, 6, 10
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    d = dict(xg=f(E * K, C), sbf=f(E * K, S1), tbf=f(E * K, S2),
             ws=f(S1, C), wt=f(S2, C),
             m2d=(rng.random((E, K)) > 0.3).astype(np.float32), ct=f(E, C))
    cases = (
        (("xg", "sbf", "tbf", "ws", "wt"),
         lambda *a: fused_triplet_product(*a, 4, 16, False),
         lambda *a: j_product(*a, 4, 16, False)),
        (("xg", "sbf", "ws"),
         lambda *a: fused_angle_product(*a, 4, 16, False),
         lambda *a: j_angle(*a, 4, 16, False)))
    for names, port, jax_op in cases:
        xs = [torch.tensor(d[k], requires_grad=True) for k in names]
        out = port(*xs, torch.tensor(d["m2d"]))
        grads = torch.autograd.grad(out, xs, torch.tensor(d["ct"]))
        out_j, vjp = jax.vjp(lambda *a: jax_op(*a, jnp.asarray(d["m2d"])),
                             *(jnp.asarray(d[k]) for k in names))
        assert _rel(out.detach().numpy(), out_j) < 1e-5
        for name, a, b in zip(names, grads, vjp(jnp.asarray(d["ct"]))):
            if name in ("sbf", "tbf"):           # basis_grads=False
                assert float(a.abs().max()) == 0.0 == float(np.abs(b).max())
            else:
                assert _rel(a.numpy(), b) < 1e-5, name


@pytest.mark.parametrize("name", list(REF))
def test_namespaces_mirror_the_reference(name):
    ref, port = REF[name]
    assert TO_PORT[name] <= set(ref.__all__)
    assert set(port.__all__) - PORT_ONLY[name] == \
        set(ref.__all__) - TO_PORT[name]
    assert all(hasattr(port, n) for n in port.__all__)


def test_port_imports_no_jax():
    import ast
    import pathlib
    root = pathlib.Path(dig_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    banned = {"jax", "flax", "optax", "dig_tpu"}
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(f.name, n) for n in names
                      if n.split(".")[0] in banned]
    names = {str(f.relative_to(root.parent)) for f in files}
    for pkg in ("ggraph3d", "xgraph"):
        assert any(n.startswith(f"dig_tpu_torch/{pkg}/") for n in names), pkg
    assert len(files) > 60 and not found, found


def test_readout_of_a_slot_aligned_batch():
    """Padding rows inside the slots carry the last graph's id, so
    node_graph is not sorted over all rows: a row pointer searched over it
    (segment_sum_sorted's, with the masked rows parked past the end) is
    wrong there, and readout_sum's is right."""
    mols = synthetic_molecules(6, seed=1, min_atoms=3, max_atoms=7)
    g = next(iter(MoleculeLoader(mols, 6, slot_size=8, device="cpu")))
    ng, nm = g.node_graph, g.node_mask
    assert bool((ng[:-1] > ng[1:]).any())        # padding inside the slots
    data = torch.randn(g.num_nodes, 5, generator=torch.Generator()
                       .manual_seed(0))
    want = segment_sum(data, ng, g.num_graphs, mask=nm)
    got = readout_sum(data, ng, g.num_graphs, nm)
    assert got.dtype == data.dtype
    assert _rel(got.numpy(), want.numpy()) < 1e-6
    wrong = segment_sum_sorted(data, ng, g.num_graphs, mask=nm)
    assert _rel(wrong.numpy(), want.numpy()) > 1e-2
    flat = next(iter(MoleculeLoader(mols, 6, device="cpu")))
    data = data[:flat.num_nodes]
    assert _rel(readout_sum(data, flat.node_graph, 6, flat.node_mask),
                segment_sum(data, flat.node_graph, 6, mask=flat.node_mask)
                ) < 1e-6


def test_readout_derivatives_match_index_add():
    """readout_sum to second order (its adjoint is a row gather, whose
    adjoint is the same sum) against index_add_'s autograd."""
    mols = synthetic_molecules(5, seed=2, min_atoms=3, max_atoms=6)
    g = next(iter(MoleculeLoader(mols, 5, slot_size=6, device="cpu")))
    gen = torch.Generator().manual_seed(1)
    data = torch.randn(g.num_nodes, 3, generator=gen)
    w = torch.randn(g.num_graphs, 3, generator=gen)
    v = torch.randn(g.num_nodes, 3, generator=gen)
    res = []
    for fn in (lambda x: readout_sum(x, g.node_graph, g.num_graphs,
                                     g.node_mask),
               lambda x: segment_sum(x, g.node_graph, g.num_graphs,
                                     mask=g.node_mask)):
        x = data.clone().requires_grad_()
        (g1,) = torch.autograd.grad((w * fn(x) ** 2).sum(), x,
                                    create_graph=True)
        (g2,) = torch.autograd.grad((g1 * v * x).sum(), x)
        res.append((g1.detach(), g2))
    for a, b in zip(*res):
        assert _rel(a.numpy(), b.numpy()) < 1e-6


def test_gather_rows_is_a_closed_pair():
    """gather_rows equals x[idx] for an index of any shape (repeats,
    unsorted), and its first and second derivatives equal index_select's."""
    gen = torch.Generator().manual_seed(2)
    x0 = torch.randn(7, 3, generator=gen)
    idx = torch.randint(0, 7, (5, 4), generator=gen)
    idx[0] = 0                                  # a heavily repeated row
    w = torch.randn(5, 4, 3, generator=gen)
    v = torch.randn(7, 3, generator=gen)
    res = []
    for fn in (gather_rows,
               lambda x, i: x.index_select(0, i.reshape(-1)).reshape(
                   tuple(i.shape) + (3,))):
        x = x0.clone().requires_grad_()
        out = fn(x, idx)
        (g1,) = torch.autograd.grad((w * out ** 2).sum(), x,
                                    create_graph=True)
        (g2,) = torch.autograd.grad((g1 * v * x).sum(), x)
        res.append((out.detach(), g1.detach(), g2))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1:], res[1][1:]):
        assert _rel(a.numpy(), b.numpy()) < 1e-6


def test_full_window_never_overflows():
    """A window of E + 127 edges holds every block's edges, whatever the
    row pointer (here one row holds all of them), so the card path needs
    no overflow check for the readout and the gathers."""
    E = 1000
    rowptr = torch.tensor([0, 3, E, E, E], dtype=torch.int32)
    assert int(csr_block_overflow(rowptr, 4, 2, full_window(E))) == 0
    assert int(csr_block_overflow(rowptr, 4, 2, full_window(E) - 200)) > 0
