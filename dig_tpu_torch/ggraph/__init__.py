"""Molecular graph generation (port of ``dig_tpu.ggraph``; reference
``dig/ggraph``, SURVEY.md §2.3).

* :mod:`generator` — the 3-task Generator ABC
  (``dig/ggraph/method/generator.py:1-52``).
* :mod:`models` — dense-tensor generative models: GraphDF (discrete flow),
  GraphAF (continuous masked flow), GraphEBM (Langevin EBM), shared RGCN.
  No sparse op and no kernel of ``dig_tpu_torch.ops``: the products are
  batched ``torch.einsum`` over dense one-hot tensors.
* :mod:`methods` — train/run entry points for rand-gen / prop-opt /
  const-prop-opt; :mod:`rl` — the PPO fine-tune.
* :mod:`jtvae` / :mod:`jtmpn` — the junction-tree VAE and its assembly
  scorer.
* :mod:`dataset` — SMILES -> dense one-hot (x, adj) datasets with BFS
  ordering (``dig/ggraph/dataset/PygDataset.py:16-376``), numpy batches.
* :mod:`evaluation` — RandGen / PropOpt / ConstPropOpt evaluators
  (``dig/ggraph/evaluation/metric.py:7-163``).
* :mod:`environment` — chemical env utils (valency, validity, rewards;
  ``dig/ggraph/utils/environment.py``) on the chem kernel.

``dataset``, ``environment``, ``evaluation`` and ``generator`` are copies
of the JAX package's modules (numpy and the stdlib).
"""
from .generator import Generator
from .dataset import DenseMolDataset, DenseMolLoader, synthetic_smiles_dataset
from .evaluation import (RandGenEvaluator, PropOptEvaluator,
                         ConstPropOptEvaluator)
from .methods import GraphDF, GraphAF, GraphEBM
from .jtvae import JTVAE, Vocab, MolTree, tree_decomp

__all__ = [
    "Generator", "DenseMolDataset", "DenseMolLoader",
    "synthetic_smiles_dataset",
    "RandGenEvaluator", "PropOptEvaluator", "ConstPropOptEvaluator",
    "GraphDF", "GraphAF", "GraphEBM",
    "JTVAE", "Vocab", "MolTree", "tree_decomp",
]
