"""GOOD out-of-distribution datasets. Port of ``dig_tpu/oodgraph``
(datasets only, no methods, as the JAX package), numpy on the host.

The reference ships 8 dataset classes that gdown pre-processed PyG caches
and expose ``load(dataset_root, domain, shift)`` returning train / id_val /
id_test / val(ood) / test(ood) splits plus meta info
(``dig/oodgraph/good_hiv.py:14-146`` etc.). Here:

* :class:`GOODDataset` reads the same logical layout from a local npz
  cache (per split: graph lists for graph tasks, one big graph + masks for
  node tasks); nothing is downloaded, so caches must be staged.
* :func:`make_ood_splits` *generates* covariate/concept/no-shift splits
  from any graph-classification dataset by an environment/domain feature
  (size or a provided domain value per graph), reproducing the GOOD split
  protocol so OOD experiments run end-to-end offline.
* Named classes GOODHIV / GOODPCBA / GOODZINC / GOODCMNIST / GOODMotif /
  GOODCora / GOODArxiv / GOODCBAS mirror the reference surface.
"""
from .datasets import (GOODDataset, GOODHIV, GOODPCBA, GOODZINC, GOODCMNIST,
                       GOODMotif, GOODCora, GOODArxiv, GOODCBAS,
                       make_ood_splits)

__all__ = [
    "GOODDataset", "make_ood_splits",
    "GOODHIV", "GOODPCBA", "GOODZINC", "GOODCMNIST", "GOODMotif",
    "GOODCora", "GOODArxiv", "GOODCBAS",
]
