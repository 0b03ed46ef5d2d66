"""Train Graphair then report accuracy / DP / EO. Port of
``dig_tpu/fairgraph/run.py``."""
from __future__ import annotations

from typing import Dict

from ..device import DeviceLike
from .graphair import Graphair


def run(data: Dict, epochs: int = 500, warmup: int = 0,
        alpha: float = 20.0, beta: float = 0.9, gamma: float = 0.7,
        lam: float = 1.0, num_hidden: int = 64, verbose: bool = False,
        classifier_epochs: int = 500, seed: int = 0,
        device: DeviceLike = None) -> Dict[str, float]:
    model = Graphair(feat_dim=data["x"].shape[1], num_hidden=num_hidden,
                     alpha=alpha, beta=beta, gamma=gamma, lam=lam,
                     device=device)
    model.fit_whole(epochs, data["adj"], data["x"], data["sens"],
                    data["idx_sens_train"], warmup=warmup, seed=seed,
                    verbose=verbose)
    res = model.test(data["y"], data["sens"], data["idx_train"],
                     data["idx_test"], epochs=classifier_epochs)
    if verbose:
        print(f"acc {res['accuracy']:.4f}  DP {res['dp']:.2f}  "
              f"EO {res['eo']:.2f}")
    return res
