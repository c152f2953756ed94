"""Aggregation hoisting: move input-side SpMMs out of the training loop.

Counterpart of ``graphslim_tpu/models/hoist.py`` for SGC and GCN.  The
leading aggregations commute with the first (linear) transformation::

    A^k (X W + 1 bᵀ) = (A^k [X | 1]) · [W ; bᵀ]

so ``A^k [X|1]`` is computed once: all propagations of eval-mode SGC
(ntrans = 1) and the first of GCN leave the 300-epoch loop.
"""

from __future__ import annotations

from typing import Any

import torch

from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.models.base import GNNModel, aggregate
from graphslim_tpu_torch.models.zoo import GCN, SGC


def _propagate_aug(x: torch.Tensor, adj: Any, hops: int) -> torch.Tensor:
    """A^hops [X | 1]."""
    aug = torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)
    for _ in range(hops):
        aug = aggregate(adj, aug)
    return aug


def _aug_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    out = x[:, :-1] @ p["w"]
    if "b" in p:
        out = out + x[:, -1:] * p["b"]
    return out


class HoistedSGC(GNNModel):
    """SGC (ntrans = 1) on ``x_pre = A^nlayers [X|1]``."""

    def init(self, gen):
        return SGC(self.cfg).init(gen)

    def _forward(self, params, x, adj, *, training, gen):
        return _aug_linear(params["layers"][0], x)


class HoistedGCN(GNNModel):
    """GCN whose first aggregation is pre-applied: ``x_pre = A [X|1]``."""

    def init(self, gen):
        return GCN(self.cfg).init(gen)

    def _forward(self, params, x, adj, *, training, gen):
        c = self.cfg
        layers = params["layers"]
        h = _aug_linear(layers[0], x)
        if len(layers) == 1:
            return h
        if c.with_bn:
            h = nn.bn_apply(params["bns"][0], h)
        h = nn.dropout(gen, torch.relu(h), c.dropout, training)
        for i, p in enumerate(layers[1:], start=1):
            h = aggregate(adj, nn.linear_apply(p, h))
            if i != len(layers) - 1:
                if c.with_bn:
                    h = nn.bn_apply(params["bns"][i], h)
                h = nn.dropout(gen, torch.relu(h), c.dropout, training)
        return h


def hoist_plan(model: GNNModel):
    """(hoisted_model, hops, keep_adj) or None when not hoistable."""
    if isinstance(model, SGC) and model.cfg.ntrans == 1:
        return HoistedSGC(model.cfg), model.cfg.nlayers, False
    if isinstance(model, GCN) and not model.cfg.with_bn:
        return HoistedGCN(model.cfg), 1, True
    return None


def hoist_batch(batch: tuple, hops: int, keep_adj: bool) -> tuple:
    """Pre-propagate one (x, adj, y, idx) tuple for a hoisted model.  When
    the adjacency is not kept, rows are independent, so the batch is cut
    to its ``idx`` rows here (exact, and the epoch loop then touches only
    those rows)."""
    x, adj, y, idx = batch
    x_pre = _propagate_aug(x, adj, hops)
    if keep_adj:
        return x_pre, adj, y, idx
    if idx is not None:
        x_pre, idx = x_pre[idx], None
    return x_pre, None, y, idx
