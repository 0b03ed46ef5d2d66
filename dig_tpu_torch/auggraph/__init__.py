"""Graph augmentation methods. Port of ``dig_tpu.auggraph``
(``dig/auggraph``).

* :mod:`graphaug` — GraphAug: learned augmentation policy (per-step
  category + magnitude choices with straight-through sampling), a
  graph-matching reward model scoring label-invariance, and the three
  runners (reward-model training, generator training, augmented
  classification) mirroring ``dig/auggraph/method/GraphAug/runner_*.py``.
* :mod:`smixup` — SMixup: graph mixup via GMNET soft matching + Sinkhorn
  OT alignment and mixup classifier training
  (``dig/auggraph/method/SMixup/smixup.py:25-303``).
"""
from .graphaug import Augmenter, RewardGMNet, RunnerRewardGen, \
    RunnerGenerator, RunnerAugCls
from .smixup import SMixup, sinkhorn

__all__ = [
    "Augmenter", "RewardGMNet", "RunnerRewardGen", "RunnerGenerator",
    "RunnerAugCls", "SMixup", "sinkhorn",
]
