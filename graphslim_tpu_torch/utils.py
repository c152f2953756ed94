"""Shared utilities: device resolution, seeding, losses, metrics, Adam, SGD.

Counterpart of ``graphslim_tpu/utils.py`` (only what the ported paths
need).  ``Adam`` and ``SGD`` are written out so their arithmetic is exactly
optax's ``adam`` (bias-corrected moments, ``eps`` added after the square
root) and ``sgd`` (momentum as ``optax.trace``).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def host_array(x) -> np.ndarray:
    """``x`` on the host: a tensor detached and copied back, anything
    else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def seed_everything(seed: int) -> torch.Generator:
    """Seed host RNGs and return a CPU ``torch.Generator``."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts/lists of tensors, leaves in JAX's order:
# dict keys sorted)
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def trainable(tree):
    """Fresh leaf tensors (detached copies) that require grad."""
    return tree_map(lambda x: x.detach().clone().requires_grad_(True), tree)


# ---------------------------------------------------------------------------
# Metrics and losses
# ---------------------------------------------------------------------------

def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    return (pred == labels).to(torch.float32).mean(dim=-1)


def f1_macro(logits: torch.Tensor, labels: torch.Tensor,
             nclass: int) -> torch.Tensor:
    """Macro-averaged F1 over ``nclass`` classes; a class with no true and
    no predicted row counts 0, as in the JAX package."""
    pred = torch.argmax(logits, dim=-1)
    classes = torch.arange(nclass, device=logits.device)
    pred_oh = pred.unsqueeze(-2) == classes[:, None]          # [..., C, N]
    true_oh = labels.unsqueeze(-2) == classes[:, None]
    tp = (pred_oh & true_oh).sum(-1).to(torch.float32)
    fp = (pred_oh & ~true_oh).sum(-1).to(torch.float32)
    fn = (~pred_oh & true_oh).sum(-1).to(torch.float32)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall,
                                              min=1e-12)
    return f1.mean(-1)


def roc_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary ROC-AUC by the rank statistic of the positive-class
    ``scores`` (ranks in sort order, as the JAX package assigns them)."""
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(scores)
    ranks[order] = torch.arange(1, scores.shape[0] + 1,
                                dtype=scores.dtype, device=scores.device)
    pos = labels == 1
    n_pos = pos.sum().to(scores.dtype)
    n_neg = scores.shape[0] - n_pos
    rank_sum = torch.where(pos, ranks, torch.zeros_like(ranks)).sum()
    return (rank_sum - n_pos * (n_pos + 1) / 2) / torch.clamp(
        n_pos * n_neg, min=1.0)


def metric_fn(name: str, nclass: int):
    """Metric by name: ``f1_macro`` (yelp, amazon), ``roc_auc`` on the
    class-1 score, accuracy otherwise."""
    if name == "f1_macro":
        return lambda logits, labels: f1_macro(logits, labels, nclass)
    if name == "roc_auc":
        return lambda logits, labels: roc_auc(logits[:, 1], labels)
    return accuracy


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood over the (optionally masked) rows of
    the last-but-one axis; leading axes are a batch."""
    ll = torch.gather(log_probs, -1, labels.unsqueeze(-1)).squeeze(-1)
    if mask is not None:
        m = mask.to(ll.dtype)
        return -(ll * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    return -ll.mean(-1)


def soft_ce_loss(log_probs: torch.Tensor,
                 soft_targets: torch.Tensor) -> torch.Tensor:
    """Soft-label cross entropy: the mean over rows of
    ``-Σ_c target_c · log p_c``."""
    return -(soft_targets * log_probs).sum(-1).mean(-1)


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances [n_a, n_b] by the expansion
    ‖a‖² + ‖b‖² − 2·a·bᵀ (the JAX package's formula, so argmins agree)."""
    a2 = (a * a).sum(1)[:, None]
    b2 = (b * b).sum(1)[None, :]
    return torch.sqrt(torch.clamp(a2 + b2 - 2 * (a @ b.T), min=0.0))


# ---------------------------------------------------------------------------
# Adam over lists of tensors (optax.adam / scale_by_adam arithmetic)
# ---------------------------------------------------------------------------

class Adam:
    """Adam with optax's arithmetic: ``u = m̂ / (sqrt(v̂) + eps)``.

    ``weight_decay`` is coupled (added to the gradient before the moments),
    as ``optax.chain(add_decayed_weights, scale_by_adam)`` and
    ``torch.optim.Adam`` do.  Parameters are updated in place.
    """

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: list) -> dict:
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params], "t": 0}

    @torch.no_grad()
    def step(self, params: list, grads: list, state: dict,
             lr: Optional[float] = None) -> None:
        lr = self.lr if lr is None else lr
        state["t"] += 1
        t = state["t"]
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            if self.weight_decay:
                g = g + self.weight_decay * p
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.sub_(lr * u)


class SGD:
    """SGD with optax's arithmetic: ``t = g + momentum · t``, then
    ``p -= lr · t``; ``weight_decay`` is added to the gradient first, as
    ``optax.chain(add_decayed_weights, sgd)`` does.  Parameters are
    updated in place."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        self.lr, self.momentum = lr, momentum
        self.weight_decay = weight_decay

    def init(self, params: list) -> dict:
        return {"trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: list, grads: list, state: dict) -> None:
        for p, g, t in zip(params, grads, state["trace"]):
            if self.weight_decay:
                g = g + self.weight_decay * p
            t.mul_(self.momentum).add_(g)
            p.sub_(self.lr * t)
