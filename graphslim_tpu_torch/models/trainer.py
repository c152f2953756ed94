"""GNN trainer with per-epoch validation.

Counterpart of ``graphslim_tpu/models/trainer.py``; the epoch ``lax.scan``
is a Python loop, and the best-by-validation selection stays on the device
(``torch.where``), so an epoch never waits for the host.  Semantics as
there: Adam with coupled weight decay, lr ×0.1 from the halfway epoch when
lr > 1e-3, best weights by validation metric, and the loss chosen as there:
the soft-label cross entropy when ``loss == "soft"`` or the labels are 2-D
(GCSNTK's and GEOM's soft labels), else ``mse`` (on the log-softmax
output, as the reference does), ``bce`` (the first output column as a
logit) or NLL.  ``fit_multi_seed`` runs the seeds one after another (the
JAX package vmaps them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.models.base import GNNModel, select_rows


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 300
    lr: float = 0.01
    weight_decay: float = 5e-4
    metric: str = "accuracy"
    loss: str = "nll"   # 'nll' | 'soft' | 'mse' | 'bce'


def prepare_adj(adj: Any) -> Any:
    """GCN-normalize any adjacency form (None stays the identity)."""
    if adj is None:
        return None
    if isinstance(adj, G.SparseAdj):
        return G.gcn_norm(adj)
    return G.normalize_adj_dense(adj)


def _loss(cfg: TrainConfig, log_probs: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    if cfg.loss == "soft" or y.ndim == 2:
        return utils.soft_ce_loss(log_probs, y)
    if cfg.loss == "mse":
        return torch.mean((log_probs - y) ** 2)
    if cfg.loss == "bce":
        logit = log_probs[..., 0] if log_probs.ndim == 2 else log_probs
        yf = y.to(logit.dtype)
        return torch.mean(torch.clamp(logit, min=0) - logit * yf
                          + torch.log1p(torch.exp(-logit.abs())))
    return utils.nll_loss(log_probs, y)


def fit_with_val(model: GNNModel, gen: torch.Generator, *, train: tuple,
                 val: tuple, cfg: TrainConfig,
                 params0: Optional[dict] = None):
    """Train with per-epoch validation → (best_params, best_val, losses).

    ``train``/``val`` are ``(x, adj_normalized, y, idx_or_None)``.
    """
    tx, tadj, ty, tidx = train
    vx, vadj, vy, vidx = val
    metric = utils.metric_fn(cfg.metric, model.cfg.nclass)
    params = utils.trainable(model.init(gen) if params0 is None
                             else params0)
    leaves = utils.tree_leaves(params)
    opt = utils.Adam(cfg.lr, weight_decay=cfg.weight_decay)
    state = opt.init(leaves)
    best_acc = torch.tensor(-1.0, device=tx.device)
    best_params = utils.tree_map(lambda p: p.detach().clone(), params)
    best = utils.tree_leaves(best_params)
    half = cfg.epochs // 2
    losses = []
    for i in range(cfg.epochs):
        lr_t = cfg.lr * 0.1 if (i >= half and cfg.lr > 1e-3) else cfg.lr
        with torch.enable_grad():
            out = model.apply(params, tx, tadj, training=True, gen=gen)
            loss = _loss(cfg, select_rows(out, tidx), ty)
            # a leaf the forward never reads (SGFormer's ``g_bn``) takes
            # a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
        opt.step(leaves, grads, state, lr=lr_t)
        with torch.no_grad():
            val_out = select_rows(model.apply(params, vx, vadj), vidx)
            acc = metric(val_out, vy)
            better = acc > best_acc
            best_acc = torch.where(better, acc, best_acc)
            for b, p in zip(best, leaves):
                b.copy_(torch.where(better, p, b))
        losses.append(loss.detach())
    return best_params, best_acc, torch.stack(losses)


def fit_multi_seed(model: GNNModel, gens: list, *, train: tuple,
                   val: tuple, cfg: TrainConfig):
    """One :func:`fit_with_val` per generator (initial parameters drawn
    from it), one after another → (params stacked on a leading seed axis,
    best validation metrics ``[S]``, losses ``[S, epochs]``)."""
    runs = [fit_with_val(model, g, train=train, val=val, cfg=cfg)
            for g in gens]
    params = utils.tree_map(lambda *ps: torch.stack(ps),
                            *[r[0] for r in runs])
    return (params, torch.stack([r[1] for r in runs]),
            torch.stack([r[2] for r in runs]))


@torch.no_grad()
def evaluate(model: GNNModel, params: dict, x, adj_norm: Any, y,
             idx=None, metric: str = "accuracy") -> torch.Tensor:
    """Metric of model predictions on (x, adj) at rows ``idx``."""
    out = select_rows(model.apply(params, x, adj_norm), idx)
    return utils.metric_fn(metric, model.cfg.nclass)(out, y)
