"""Explainability metrics — port of ``dig_tpu/xgraph/metrics.py`` (numpy),
parity with ``dig/xgraph/evaluation/metrics.py:19-360``."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..graph import GraphBatch


def control_sparsity(mask: np.ndarray, sparsity: Optional[float] = None):
    """Top (1 - sparsity) entries -> +inf, rest -> -inf
    (metrics.py:19-57)."""
    if sparsity is None:
        sparsity = 0.7
    mask = np.asarray(mask, np.float32)
    order = np.argsort(-mask)
    split = int((1 - sparsity) * len(mask))
    out = mask.copy()
    out[order[:split]] = np.inf
    out[order[split:]] = -np.inf
    return out


def fidelity(ori_probs, unimportant_probs) -> float:
    """Fidelity+: prob drop when removing important edges
    (metrics.py:59-78)."""
    return float(np.mean(np.asarray(ori_probs)
                         - np.asarray(unimportant_probs)))


def fidelity_inv(ori_probs, important_probs) -> float:
    """Fidelity-: prob drop when keeping only important edges
    (metrics.py:81-100)."""
    return float(np.mean(np.asarray(ori_probs)
                         - np.asarray(important_probs)))


class XCollector:
    """Aggregates related predictions; exposes fidelity / fidelity_inv /
    sparsity (metrics.py:101-260)."""

    def __init__(self, sparsity: Optional[float] = None):
        self.__sparsity = sparsity
        self.new()

    def new(self):
        self.__related_preds = {k: [] for k in
                                ("zero", "masked", "maskout", "origin",
                                 "sparsity", "accuracy", "stability")}
        self.__targets: List[int] = []
        self.masks: List = []
        self.__fidelity = None
        self.__fidelity_inv = None

    @property
    def targets(self):
        return self.__targets

    def collect_data(self, masks, related_preds, label: int = 0):
        if self.__fidelity is not None or self.__fidelity_inv is not None:
            self.__fidelity = self.__fidelity_inv = None
            print("#W# collect_data() after metric computation; resetting")
        if not np.isnan(label):
            rp = (related_preds[label] if isinstance(related_preds, list)
                  else related_preds)
            for key, value in rp.items():
                if key in self.__related_preds:
                    self.__related_preds[key].append(value)
            for key in self.__related_preds:
                if key not in rp:
                    self.__related_preds[key].append(None)
            self.__targets.append(label)
            self.masks.append(masks)

    @property
    def fidelity(self):
        if self.__fidelity is not None:
            return self.__fidelity
        mo = self.__related_preds["maskout"]
        ori = self.__related_preds["origin"]
        if None in mo or None in ori or not ori:
            return None
        self.__fidelity = fidelity(np.asarray(ori), np.asarray(mo))
        return self.__fidelity

    @property
    def fidelity_inv(self):
        if self.__fidelity_inv is not None:
            return self.__fidelity_inv
        ma = self.__related_preds["masked"]
        ori = self.__related_preds["origin"]
        if None in ma or None in ori or not ori:
            return None
        self.__fidelity_inv = fidelity_inv(np.asarray(ori), np.asarray(ma))
        return self.__fidelity_inv

    @property
    def sparsity(self):
        if self.__sparsity is not None:
            return self.__sparsity
        sp = self.__related_preds["sparsity"]
        if None in sp or not sp:
            return None
        return float(np.mean(sp))


class ExplanationProcessor:
    """Drives explainer -> XCollector over a dataset
    (metrics.py:262-360)."""

    def __init__(self, model, params=None, model_level: str = "graph"):
        self.model = model
        self.params = params
        self.model_level = model_level

    def forward(self, g: GraphBatch, masks: List[np.ndarray],
                x_collector: XCollector, node_idx: Optional[int] = None,
                label: Optional[int] = None):
        from .base import ExplainerBase, to_numpy
        base = ExplainerBase(self.model, self.params)
        if label is None:
            probs = base.predict_proba(g)
            row = 0 if node_idx is None else node_idx
            label = int(np.argmax(to_numpy(probs)[row]))
        related = base.eval_related_pred(g, masks, node_idx=node_idx)
        x_collector.collect_data(masks, related, label)
        return related
