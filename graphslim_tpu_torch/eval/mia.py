"""Membership-inference attack via confidence thresholding.

Counterpart of ``graphslim_tpu/eval/mia.py`` (reference
``inference_via_confidence``, ``graphslim/evaluation/utils.py:80-113``):
sweep a confidence threshold and report the best membership-inference
accuracy between the train (member) and test (non-member) confidences.
The forward runs on the dataset's device: a transductive graph whole
through its normalized ``SparseAdj`` (the blocked SpMM on the card; GAT
through the ELL layout its edge softmax reads), where the JAX package takes
its ELL layout for every model; an inductive one on the train and test
subgraphs through their normalizations cached on the dataset.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch.models.gat import GAT


def inference_via_confidence(conf_train: np.ndarray,
                             conf_test: np.ndarray,
                             y_train: np.ndarray,
                             y_test: np.ndarray) -> float:
    """Max over thresholds of 0.5·(TPR + 1 − FPR), in float64."""
    conf_train = np.asarray(conf_train, dtype=np.float64)
    conf_test = np.asarray(conf_test, dtype=np.float64)
    c1 = conf_train[np.arange(len(y_train)), y_train]
    c2 = conf_test[np.arange(len(y_test)), y_test]
    thresholds = np.sort(np.concatenate([c1, c2]))
    # share of members / non-members at or above each threshold
    r1 = 1.0 - np.searchsorted(np.sort(c1), thresholds, side="left") / \
        max(len(c1), 1)
    r2 = 1.0 - np.searchsorted(np.sort(c2), thresholds, side="left") / \
        max(len(c2), 1)
    acc = 0.5 * (r1 + 1.0 - r2)
    return float(max(0.5, acc.max()))


@torch.no_grad()
def mia_attack(model, params, data, metric_probs=True) -> float:
    """The confidence attack on a trained model (reference
    ``eval_agent.py:193-224``, MIA branch)."""
    d = data
    if d.setting == "ind":
        out_tr = model.apply(params, d.feat_train, d.view_norm("train"))
        out_te = model.apply(params, d.feat_test, d.view_norm("test"))
        y_tr = d.labels_train.cpu().numpy()
        y_te = d.labels_test.cpu().numpy()
    else:
        adj = d.adj_norm_ell() if isinstance(model, GAT) else d.adj_norm()
        out = model.apply(params, d.feat, adj)
        tr = torch.as_tensor(d.idx_train, device=out.device)
        te = torch.as_tensor(d.idx_test, device=out.device)
        out_tr, out_te = out[tr], out[te]
        labels = d.labels.cpu().numpy()
        y_tr, y_te = labels[d.idx_train], labels[d.idx_test]
    conf_tr = torch.exp(out_tr).cpu().numpy()
    conf_te = torch.exp(out_te).cpu().numpy()
    return inference_via_confidence(conf_tr, conf_te, y_tr, y_te)
