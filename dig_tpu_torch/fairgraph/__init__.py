"""Fair graph representation learning. Port of ``dig_tpu/fairgraph``: the
Graphair method (adversarial learned augmentation + contrastive encoder +
sensitive-attribute adversary) with the ``run`` entry point reporting
accuracy / demographic parity / equalized odds, and POKEC/NBA-style
dataset loading (cached csv; synthetic generator for offline work).
Dense matrix products in PyTorch, no kernel of the port's.
"""
from .graphair import Graphair, GCNBody, AugModule, SensAdv, Classifier
from .dataset import load_fair_dataset, synthetic_fair_graph
from .run import run

__all__ = [
    "Graphair", "GCNBody", "AugModule", "SensAdv", "Classifier",
    "load_fair_dataset", "synthetic_fair_graph", "run",
]
