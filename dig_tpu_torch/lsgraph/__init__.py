"""Large-scale / scalable GNN training. Port of ``dig_tpu/lsgraph``
(``dig/lsgraph`` of the reference, its only native-code module).

The reference trains GNNs on graphs too big for one device by METIS
partitioning + per-partition minibatches, with out-of-batch neighbor
embeddings served from a pinned-CPU *history* cache. Here:

* partitioning & one-hop relabeling run in C++
  (``dig_tpu_torch/native/partition.cpp``, built with g++ at first use)
  with numpy fallbacks;
* histories are device tensors the train step threads through
  (push = a masked row write of fresh in-batch embeddings, pull = a
  gather for halo rows);
* the GCN / GCNII aggregation runs through the sorted-CSR kernel in both
  directions on the card, or through SELL plans (``lsgraph.models``);
* ``FeatureMomentum`` (GraphFM-OB) blends history with fresh boundary
  estimates exactly as ``dig/lsgraph/method/FM.py:67-70``; ``GraphFMIB``
  is the in-batch variant over neighbour-sampled batches.
"""
from .data import get_data, synthetic_large_graph
from .fm_ib import GraphFMIB, NeighborBatch, NeighborSampledLoader
from .history import FeatureMomentum, History
from .loader import EvalSubgraphLoader, SubData, SubgraphLoader, metis_permute
from .models import ScalableGCN, ScalableGCN2, ScalableGNN, ScalablePNA

__all__ = [
    "History", "FeatureMomentum",
    "SubgraphLoader", "EvalSubgraphLoader", "metis_permute", "SubData",
    "ScalableGNN", "ScalableGCN", "ScalableGCN2", "ScalablePNA",
    "synthetic_large_graph", "get_data",
    "GraphFMIB", "NeighborSampledLoader", "NeighborBatch",
]
