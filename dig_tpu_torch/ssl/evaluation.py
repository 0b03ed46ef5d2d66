"""SSL evaluation harnesses. Port of ``dig_tpu/ssl/evaluation.py``.

Parity with ``dig/sslgraph/evaluation/eval_graph.py:33-533`` and
``eval_node.py:29-312``:

* :class:`GraphUnsupervised` — pretrain, embed the whole dataset, then
  StratifiedKFold SVC (grid-searched C) / logistic regression on the frozen
  embeddings (eval_graph.py:105-152).
* :class:`GraphSemisupervised` — pretrain, then finetune encoder+classifier
  on a labeled fraction with k-fold (eval_graph.py:154-533).
* :class:`NodeUnsupervised` — node-level embeddings + logistic regression
  over provided masks (eval_node.py:29-145).

The probes and the k-fold splits are scikit-learn on the host, imported
inside the functions that use them, as in the JAX package: they need
scikit-learn installed. The pretraining, the embedding passes and the
finetuning run on ``device`` (None: the card) and do not need it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..datasets.graphs import GraphClsLoader
from ..device import DeviceLike, resolve_device
from ..graph import GraphBatch


def _adam(lr):
    return lambda params: torch.optim.Adam(params, lr=lr)


@torch.no_grad()
def _graph_embeddings(encoder, params, g):
    out = (encoder(g) if params is None
           else functional_call(encoder, params, (g,)))
    return out[0] if isinstance(out, tuple) else out


def _embed_dataset(encoder, params, loader, device: DeviceLike = None):
    """Frozen-encoder embeddings for every real graph (numpy, as the JAX
    function returns): the encoder at ``params`` (a state dict; None: its
    current weights), each batch moved to ``device`` (None: the
    encoder's); read on the host once, after the last batch."""
    dev = (next(encoder.parameters()).device if device is None
           else resolve_device(device))
    zs, ms, ys = [], [], []
    for g in loader:
        g = g.to(dev)
        zs.append(_graph_embeddings(encoder, params, g))
        ms.append(g.graph_mask)
        ys.append(g.globals["y"])
    gm = torch.cat(ms).cpu().numpy()
    z = torch.cat(zs).cpu().numpy()[gm]
    y = torch.cat(ys).cpu().numpy()[gm]
    return z, y.astype(int).ravel()


def _lecun_normal_linear(in_dim, out_dim, generator):
    """``nn.Linear`` with flax ``Dense``'s default initialisers: LeCun
    normal (truncated at 2 standard deviations) kernel, zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(out_dim, in_dim)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        lin.weight.copy_(w)
        lin.bias.zero_()
    return lin


class GraphUnsupervised:
    """Pretrain -> frozen embeddings -> k-fold SVC, as eval_graph.py:33-152.

    Args:
      dataset: list of graph dicts (see GraphClsLoader).
      classifier: 'SVC' or 'LogReg'.
      epoch_select: 'test_max' (best epoch by test acc, reference default)
        or 'val_max'.
      device: where the pretraining and embedding run (None: the card).
    """

    def __init__(self, dataset: Sequence[Dict], classifier: str = "SVC",
                 log_interval: int = 1, epoch_select: str = "test_max",
                 n_folds: int = 10, batch_size: int = 128, seed: int = 42,
                 device: DeviceLike = None):
        self.dataset = list(dataset)
        self.classifier = classifier
        self.log_interval = log_interval
        self.epoch_select = epoch_select
        self.n_folds = n_folds
        self.batch_size = batch_size
        self.seed = seed
        self.device = device
        self.search = True

    def setup_train_config(self, batch_size: int = 128,
                           p_lr: float = 0.01, p_epoch: int = 20, **kw):
        self.batch_size = batch_size
        self.p_lr = p_lr
        self.p_epoch = p_epoch

    def evaluate(self, learning_model, encoder,
                 fold_seed: Optional[int] = None):
        """Returns (mean_acc, std_acc) over folds at the best epoch."""
        loader = GraphClsLoader(self.dataset, self.batch_size, shuffle=True,
                                seed=self.seed)
        eval_loader = GraphClsLoader(self.dataset, self.batch_size)
        p_epoch = getattr(self, "p_epoch", 20)
        p_lr = getattr(self, "p_lr", 0.01)
        accs = []
        for res in learning_model.train(encoder, loader, _adam(p_lr),
                                        p_epoch, per_epoch_out=True,
                                        device=self.device):
            z, y = _embed_dataset(encoder, res["encoder_params"][0],
                                  eval_loader, self.device)
            accs.append(self._kfold_probe(z, y, fold_seed or self.seed))
        best = max(range(len(accs)), key=lambda i: accs[i][0])
        return accs[best]

    def _kfold_probe(self, z, y, fold_seed):
        from sklearn.model_selection import StratifiedKFold, GridSearchCV
        from sklearn.svm import SVC
        from sklearn.linear_model import LogisticRegression
        from sklearn.preprocessing import StandardScaler

        skf = StratifiedKFold(n_splits=self.n_folds, shuffle=True,
                              random_state=fold_seed)
        accs = []
        for tr, te in skf.split(z, y):
            sc = StandardScaler().fit(z[tr])
            ztr, zte = sc.transform(z[tr]), sc.transform(z[te])
            if self.classifier == "SVC":
                params = {"C": [1e-3, 1e-2, 1e-1, 1, 10, 100, 1000]}
                clf = GridSearchCV(SVC(), params, cv=5, scoring="accuracy",
                                   n_jobs=-1) if self.search else SVC(C=10)
            else:
                clf = LogisticRegression(max_iter=1000)
            clf.fit(ztr, y[tr])
            accs.append(clf.score(zte, y[te]))
        return float(np.mean(accs)), float(np.std(accs))


class GraphSemisupervised:
    """Pretrain then finetune on a labeled fraction with k-fold
    (eval_graph.py:154-533); ``device`` as GraphUnsupervised's."""

    def __init__(self, dataset: Sequence[Dict],
                 dataset_pretrain: Optional[Sequence[Dict]] = None,
                 label_rate: float = 1.0, n_folds: int = 10,
                 batch_size: int = 128, seed: int = 42,
                 device: DeviceLike = None):
        self.dataset = list(dataset)
        self.dataset_pretrain = (list(dataset_pretrain)
                                 if dataset_pretrain is not None
                                 else self.dataset)
        self.label_rate = label_rate
        self.n_folds = n_folds
        self.batch_size = batch_size
        self.seed = seed
        self.device = device
        self.p_epoch = 20
        self.f_epoch = 20
        self.p_lr = 0.01
        self.f_lr = 0.001

    def setup_train_config(self, batch_size: int = 128, p_lr: float = 0.01,
                           p_epoch: int = 20, f_lr: float = 0.001,
                           f_epoch: int = 20, **kw):
        self.batch_size = batch_size
        self.p_lr, self.p_epoch = p_lr, p_epoch
        self.f_lr, self.f_epoch = f_lr, f_epoch

    def evaluate(self, learning_model, encoder,
                 fold_seed: Optional[int] = None):
        from sklearn.model_selection import StratifiedKFold

        pre_loader = GraphClsLoader(self.dataset_pretrain, self.batch_size,
                                    shuffle=True, seed=self.seed)
        res = list(learning_model.train(encoder, pre_loader,
                                        _adam(self.p_lr), self.p_epoch,
                                        per_epoch_out=False,
                                        device=self.device))[-1]
        pre_params = res["encoder_params"][0]
        y_all = np.array([g["y"] for g in self.dataset])
        num_classes = int(y_all.max()) + 1
        skf = StratifiedKFold(n_splits=self.n_folds, shuffle=True,
                              random_state=fold_seed or self.seed)
        rng = np.random.default_rng(self.seed)
        accs = []
        for tr, te in skf.split(np.zeros(len(y_all)), y_all):
            if self.label_rate < 1.0:
                keep = rng.permutation(len(tr))[:int(len(tr) * self.label_rate)]
                tr = tr[keep]
            accs.append(self._finetune(encoder, pre_params,
                                       [self.dataset[i] for i in tr],
                                       [self.dataset[i] for i in te],
                                       num_classes))
        return float(np.mean(accs)), float(np.std(accs))

    def _finetune(self, encoder, pre_params, train_set, test_set,
                  num_classes):
        """Finetune ``encoder`` from ``pre_params`` with a linear head
        (flax ``Dense``'s initialisers from seed 0) on ``train_set``
        for ``f_epoch`` epochs (Adam(f_lr), cross-entropy over the real
        graphs); the test accuracy. An epoch reads nothing on the host; the
        accuracy is read once."""
        dev = resolve_device(self.device)
        tr_loader = GraphClsLoader(train_set, min(self.batch_size,
                                                  max(len(train_set), 1)),
                                   shuffle=True, seed=self.seed,
                                   drop_last=False)
        te_loader = GraphClsLoader(test_set, min(self.batch_size,
                                                 max(len(test_set), 1)))
        encoder.load_state_dict(pre_params)
        encoder.to(dev)
        head = _lecun_normal_linear(encoder.z_dim, num_classes,
                                    torch.Generator().manual_seed(0)).to(dev)
        opt = torch.optim.Adam(list(encoder.parameters())
                               + list(head.parameters()), lr=self.f_lr)
        for _ in range(self.f_epoch):
            for g in [b.to(dev) for b in tr_loader]:
                opt.zero_grad(set_to_none=True)
                finetune_loss(encoder, head, g).backward()
                opt.step()
        correct = total = 0
        with torch.no_grad():
            for g in te_loader:
                g = g.to(dev)
                zg = _graph_embeddings(encoder, None, g)
                pred = torch.argmax(head(zg), -1)
                y = g.globals["y"].reshape(-1).long()
                correct = correct + torch.sum((pred == y) & g.graph_mask)
                total = total + torch.sum(g.graph_mask)
        return int(correct) / max(int(total), 1)


def finetune_loss(encoder, head, g: GraphBatch):
    """Cross-entropy of ``head(encoder(g))`` over the real graphs."""
    zg = encoder(g)
    zg = zg[0] if isinstance(zg, tuple) else zg
    ls = F.cross_entropy(head(zg), g.globals["y"].reshape(-1).long(),
                         reduction="none")
    m = g.graph_mask
    return torch.sum(torch.where(m, ls, 0.0)) / torch.clamp(torch.sum(m),
                                                            min=1)


class NodeUnsupervised:
    """Node-level probe: pretrain on the full graph, logistic-regress node
    labels over provided split masks (eval_node.py:29-145); ``device`` as
    GraphUnsupervised's."""

    def __init__(self, full_batch: GraphBatch, y: np.ndarray,
                 train_mask: np.ndarray, test_mask: np.ndarray,
                 val_mask: Optional[np.ndarray] = None, seed: int = 42,
                 device: DeviceLike = None):
        self.g = full_batch
        self.y = np.asarray(y).astype(int)
        self.train_mask = np.asarray(train_mask)
        self.test_mask = np.asarray(test_mask)
        self.val_mask = val_mask
        self.seed = seed
        self.device = device
        self.p_epoch = 50
        self.p_lr = 0.001

    def setup_train_config(self, p_lr: float = 0.001, p_epoch: int = 50,
                           **kw):
        self.p_lr, self.p_epoch = p_lr, p_epoch

    def evaluate(self, learning_model, encoder):
        from sklearn.linear_model import LogisticRegression
        from sklearn.preprocessing import StandardScaler

        res = list(learning_model.train(encoder, [self.g], _adam(self.p_lr),
                                        self.p_epoch, per_epoch_out=False,
                                        device=self.device))[-1]
        with torch.no_grad():
            out = functional_call(encoder, res["encoder_params"][0],
                                  (self.g.to(resolve_device(self.device)),))
        z_n = out[1] if isinstance(out, tuple) else out
        z_n = z_n.cpu().numpy()
        sc = StandardScaler().fit(z_n[self.train_mask])
        clf = LogisticRegression(max_iter=2000)
        clf.fit(sc.transform(z_n[self.train_mask]), self.y[self.train_mask])
        return float(clf.score(sc.transform(z_n[self.test_mask]),
                               self.y[self.test_mask]))
