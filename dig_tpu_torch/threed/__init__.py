"""3D molecular GNN task module (parity with ``dig/threedgraph``)."""
from ..train.trainer import Run3D
from ..train.trainer import Run3D as run  # the reference exposes class `run`
from .evaluation import ThreeDEvaluator

__all__ = ["ThreeDEvaluator", "Run3D", "run"]
