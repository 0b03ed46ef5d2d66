"""dig_tpu_torch — the PyTorch/CUDA port of dig_tpu.

The JAX package ``dig_tpu`` is the reference; this package mirrors it
module for module and never imports it (nor JAX). Plain tensor code is
PyTorch; each Pallas TPU kernel becomes a CUDA kernel written for Hopper
(``csrc/``), built with ``nvcc`` on first use and bound through ctypes.

Layering (mirrors ``dig_tpu``):
  device        ``resolve_device``: entry points default to the CUDA card
  graph_dense   dense per-graph molecular batches
  graph         flat padded graph batches (and the slot-aligned layout)
  ops           segment reductions, gather / scatter, bases, flat, NK
                and periodic radius graphs, triplet tables, the fused
                cfconv kernel, the triplet product, packed-basis and slot
                triplet kernels (to second order), the sorted-CSR
                segment-sum kernel
  nn            shared blocks and initializers
  models        SchNet, SchNetDense, SphereNet, DimeNetPP, ComENet,
                ComENetOCP, ProNet
  train         train state and steps (energy, energy+force, bucketed),
                Run3D, checkpoints, metrics, the step profiler, NaN
                checks, in-place update and collective self-checks
  threed        evaluator, Run3D / run
  datasets      QM93D, MD17, synthetic molecules and crystals, the flat,
                bucketed and dense loaders, the protein data and loader,
                the graph-classification data and loader
  ssl           contrastive pretraining (GraphCL, InfoGraph, MVGRL,
                GRACE, pGRACE): encoders, views, objectives, probes
  auggraph      GraphAug (augmenter, reward model, runners) and SMixup
  chem          the RDKit-free chemistry kernel (molecules, SMILES,
                valency, canonical hashes, descriptors), numpy
  ggraph        molecule generation: GraphDF, GraphAF, GraphEBM (dense
                einsums, no kernel), the lockstep generation loop with
                host valency feedback, the PPO fine-tune, JTVAE and its
                JTMPN assembly scorer, datasets and evaluators
  ggraph3d      3D molecule generation: G-SphereNet (its encoder's edge
                sums through the sorted-CSR kernel), the placement-step
                dataset and the 3D evaluators
  xgraph        explainability: the GCN / GIN zoo whose neighbour sums
                and readouts run through the sorted-CSR kernel,
                differentiable in per-edge weights to any order;
                GNNExplainer, PGExplainer, SubgraphX and the Shapley
                family, GradCAM, GNN-GI, DeepLIFT, FlowX, GNN-LRP; the
                fidelity metrics and the synthetic benchmark data
  oodgraph      GOOD datasets and OOD splits (numpy)
  fairgraph     Graphair (dense products) and the fair-graph data
  parallel      the partitioner and, on torch.distributed (one process
                a rank), device meshes, data / graph / tensor / pipeline /
                expert parallelism and the halo exchanges; the GP models'
                neighbour sums through the sorted-CSR kernel
  config        the configuration tree
  convert       flax parameter trees -> torch modules
"""

__version__ = "0.1.0"

from . import graph, graph_dense, ops
from .config import Config
from .device import resolve_device

__all__ = ["graph", "graph_dense", "ops", "Config", "resolve_device",
           "__version__"]
