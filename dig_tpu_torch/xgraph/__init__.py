"""GNN explainability: port of ``dig_tpu.xgraph`` (SURVEY.md §2.5).

* :mod:`models` — explain-friendly GCN/GIN zoo (2/3 layers, graph & node
  level) whose forwards take per-edge weights and return intermediate
  activations; every neighbour sum and readout through the sorted-CSR
  kernel on the card, differentiable in the edge weights to any order
  (``dig/xgraph/models/models.py:22-947``).
* :mod:`base` — ExplainerBase: mask application, k-hop subgraphs, sparsity
  control, related-prediction evaluation, runs over disjoint unions
  (``dig/xgraph/method/base_explainer.py:25-498``).
* :mod:`gnnexplainer` / :mod:`pgexplainer` / :mod:`subgraphx` /
  :mod:`shapley` / :mod:`gradient` — the explainer set (GNNExplainer,
  PGExplainer, SubgraphX+MCTS, Shapley family, GradCAM / GNN-GI /
  DeepLIFT-style / FlowX / GNN-LRP).
* :mod:`metrics` — fidelity+/-, sparsity control, XCollector,
  ExplanationProcessor (``dig/xgraph/evaluation/metrics.py:19-360``).
* :mod:`datasets` — synthetic benchmark generators (BA-shapes,
  BA-community, tree-cycle, tree-grid, BA-LRP, BA-2Motifs) and the cached
  molecule / SentiGraph readers (numpy copies).
"""
from .models import GCN_2l, GCN_3l, GIN_2l, GIN_3l, GNNModel
from .base import ExplainerBase
from .gnnexplainer import GNNExplainer
from .pgexplainer import PGExplainer
from .subgraphx import SubgraphX, MCTS
from .gradient import GradCAM, GNN_GI, DeepLIFT, FlowX, GNN_LRP
from .metrics import (XCollector, ExplanationProcessor, fidelity,
                      fidelity_inv, control_sparsity)
from . import shapley, datasets

__all__ = [
    "GCN_2l", "GCN_3l", "GIN_2l", "GIN_3l", "GNNModel",
    "ExplainerBase", "GNNExplainer", "PGExplainer", "SubgraphX", "MCTS",
    "GradCAM", "GNN_GI", "DeepLIFT", "FlowX", "GNN_LRP",
    "XCollector", "ExplanationProcessor", "fidelity", "fidelity_inv",
    "control_sparsity", "shapley", "datasets",
]
