"""GOOD dataset loading + OOD split generation. Port of
``dig_tpu/oodgraph/datasets.py``, which is numpy only: copied, over the
port's ``datasets.graphs``.

Reference: ``dig/oodgraph/good_*.py`` — each class downloads a
pre-processed cache and selects (domain, shift, subset). The split
*semantics* reproduced by :func:`make_ood_splits`:

* ``no_shift``: random 60/20/20.
* ``covariate``: sort by domain value; train = first 80% of domains,
  val = next 10%, test = last 10% (unseen domains), with id_val/id_test
  carved from train domains.
* ``concept``: split so the label/domain correlation differs between train
  and test (spurious-correlation protocol): training keeps graphs where
  label agrees with the domain-majority label, test keeps disagreeing ones.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

SUBSETS = ("train", "id_val", "id_test", "val", "test")


def make_ood_splits(graphs: Sequence[Dict], shift: str = "covariate",
                    domain_fn: Optional[Callable[[Dict], float]] = None,
                    seed: int = 0) -> Dict[str, List[Dict]]:
    """Split a list of graph dicts into the GOOD subsets."""
    domain_fn = domain_fn or (lambda g: g["num_nodes"])  # 'size' domain
    rng = np.random.default_rng(seed)
    n = len(graphs)
    if shift == "no_shift":
        order = rng.permutation(n)
        a, b = int(0.6 * n), int(0.8 * n)
        return {"train": [graphs[i] for i in order[:a]],
                "id_val": [], "id_test": [],
                "val": [graphs[i] for i in order[a:b]],
                "test": [graphs[i] for i in order[b:]]}
    dom = np.array([domain_fn(g) for g in graphs], np.float64)
    if shift == "covariate":
        order = np.argsort(dom, kind="stable")
        a, b = int(0.8 * n), int(0.9 * n)
        train_ids = order[:a]
        rng.shuffle(train_ids)
        k = max(int(0.1 * len(train_ids)), 1)
        return {"train": [graphs[i] for i in train_ids[2 * k:]],
                "id_val": [graphs[i] for i in train_ids[:k]],
                "id_test": [graphs[i] for i in train_ids[k:2 * k]],
                "val": [graphs[i] for i in order[a:b]],
                "test": [graphs[i] for i in order[b:]]}
    if shift == "concept":
        med = np.median(dom)
        env = (dom > med).astype(int)
        y = np.array([int(g["y"]) for g in graphs])
        # spurious rule: label == env majority
        agree = y == env
        agree_idx = np.flatnonzero(agree)
        dis_idx = np.flatnonzero(~agree)
        rng.shuffle(agree_idx)
        rng.shuffle(dis_idx)
        # train mostly agreeing (spurious corr), test mostly disagreeing
        n_tr = int(0.8 * len(agree_idx))
        k = max(int(0.05 * n), 1)
        train_ids = agree_idx[:n_tr]
        return {"train": [graphs[i] for i in train_ids[2 * k:]],
                "id_val": [graphs[i] for i in train_ids[:k]],
                "id_test": [graphs[i] for i in train_ids[k:2 * k]],
                "val": [graphs[i] for i in np.concatenate(
                    [agree_idx[n_tr:], dis_idx[:len(dis_idx) // 2]])],
                "test": [graphs[i] for i in dis_idx[len(dis_idx) // 2:]]}
    raise ValueError(f"unknown shift {shift}")


class GOODDataset:
    """Base loader. ``load`` mirrors the reference's static API: returns
    (meta_info, splits-dict)."""

    name = "GOODDataset"
    task = "Binary classification"
    metric = "ROC-AUC"
    domains = ("size",)

    @classmethod
    def load(cls, dataset_root: str, domain: str, shift: str = "no_shift",
             generate: bool = False):
        path = os.path.join(dataset_root, cls.name, domain,
                            f"{shift}.npz")
        if os.path.exists(path):
            splits = cls._from_npz(path)
        elif generate:
            splits = cls._generate(shift)
        else:
            raise FileNotFoundError(
                f"{path} missing; stage the cache or pass generate=True "
                "(synthetic data)")
        meta = {"dataset_type": "mol", "model_level": "graph",
                "task": cls.task, "metric": cls.metric,
                "domain": domain, "shift": shift}
        return meta, splits

    @classmethod
    def _from_npz(cls, path):
        raw = np.load(path, allow_pickle=True)
        return {k: list(raw[k]) for k in SUBSETS if k in raw.files}

    @classmethod
    def _generate(cls, shift):
        from ..datasets.graphs import synthetic_graph_dataset
        # the JAX package's seed: Python's salted string hash, so the
        # synthetic splits repeat within a process (PYTHONHASHSEED fixes
        # them across processes)
        graphs = synthetic_graph_dataset(200, seed=hash(cls.name) % 1000)
        return make_ood_splits(graphs, shift=shift if shift != "no_shift"
                               else "no_shift")


class GOODHIV(GOODDataset):
    name = "GOODHIV"
    domains = ("scaffold", "size")


class GOODPCBA(GOODDataset):
    name = "GOODPCBA"
    task = "Multi-label classification"
    metric = "AP"
    domains = ("scaffold", "size")


class GOODZINC(GOODDataset):
    name = "GOODZINC"
    task = "Regression"
    metric = "MAE"
    domains = ("scaffold", "size")


class GOODCMNIST(GOODDataset):
    name = "GOODCMNIST"
    task = "Multi-class classification"
    metric = "Accuracy"
    domains = ("color",)


class GOODMotif(GOODDataset):
    name = "GOODMotif"
    task = "Multi-class classification"
    metric = "Accuracy"
    domains = ("basis", "size")


class GOODCora(GOODDataset):
    name = "GOODCora"
    task = "Multi-class classification"
    metric = "Accuracy"
    domains = ("word", "degree")


class GOODArxiv(GOODDataset):
    name = "GOODArxiv"
    task = "Multi-class classification"
    metric = "Accuracy"
    domains = ("time", "degree")


class GOODCBAS(GOODDataset):
    name = "GOODCBAS"
    task = "Multi-class classification"
    metric = "Accuracy"
    domains = ("color",)
