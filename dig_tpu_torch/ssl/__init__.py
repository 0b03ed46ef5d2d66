"""Contrastive self-supervised learning on graphs. Port of ``dig_tpu.ssl``
(``dig/sslgraph``).

Components (reference files in parens):
* :mod:`encoders` — Encoder wrapper over GIN / GCN / ResGCN stacks with
  per-layer sum/mean pooling (``dig/sslgraph/utils/encoders.py``); their
  neighbour sums and poolings run through the sorted-CSR segment sum.
* :mod:`views` — graph augmentations ``(gen, GraphBatch) -> GraphBatch``
  with a ``torch.Generator``, each a draw and an apply
  (``.../views_fn/{sample,structure,feature,combination}.py``).
* :mod:`objectives` — InfoNCE / NT-Xent family and JSE family
  (``.../objectives/{infonce,jse}.py``).
* :mod:`contrastive` — the generic pretrain engine
  (``.../model/contrastive.py:86-140``).
* :mod:`methods` — GraphCL, InfoGraph, MVGRL, GRACE, pGRACE
  (``.../model/*.py``).
* :mod:`evaluation` — GraphUnsupervised / GraphSemisupervised /
  NodeUnsupervised harnesses (``dig/sslgraph/evaluation/``); their probes
  need scikit-learn.
* :mod:`adaptive` — centrality-weighted augmentation probabilities for
  GCA/pGRACE (``dig/sslgraph/utils/adaptive.py``).
"""
from .encoders import Encoder, GIN, GCN, ResGCN
from .views import (UniformSample, RWSample, EdgePerturbation, NodeAttrMask,
                    Diffusion, DiffusionWithSample, RandomView,
                    SequentialView, identity_view)
from .objectives import nce_loss, jse_loss, nt_xent, intra_node_nce
from .contrastive import Contrastive
from .methods import GraphCL, InfoGraph, MVGRL, GRACE, pGRACE, NodeMVGRL
from .evaluation import (GraphUnsupervised, GraphSemisupervised,
                         NodeUnsupervised)

__all__ = [
    "Encoder", "GIN", "GCN", "ResGCN",
    "UniformSample", "RWSample", "EdgePerturbation", "NodeAttrMask",
    "Diffusion", "DiffusionWithSample", "RandomView", "SequentialView",
    "identity_view",
    "nce_loss", "jse_loss", "nt_xent", "intra_node_nce",
    "Contrastive", "GraphCL", "InfoGraph", "MVGRL", "GRACE", "pGRACE",
    "NodeMVGRL",
    "GraphUnsupervised", "GraphSemisupervised", "NodeUnsupervised",
]
