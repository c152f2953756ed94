"""Aggregation hoisting: move input-side SpMMs out of the training loop.

Counterpart of ``graphslim_tpu/models/hoist.py``.  The leading
aggregations commute with the first (linear) transformation::

    A^k (X W + 1 bᵀ) = (A^k [X | 1]) · [W ; bᵀ]

so ``A^k [X|1]`` is computed once: all propagations of eval-mode SGC
(ntrans = 1) and the first of GCN leave the 300-epoch loop.  Cheby's
first layer shares one weight across its recurrence, so it is
``lin(Σ_k T_k(A) X) + b``: the Chebyshev sum (the plan ``("chebsum",
K)``, ``X + A X`` at K = 2) is computed once and its later layers run as
they are.
"""

from __future__ import annotations

from typing import Any

import torch

from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.models.base import GNNModel, aggregate
from graphslim_tpu_torch.models.zoo import GCN, SGC, Cheby, _between


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
        for i, p in enumerate(layers[1:], start=1):
            h = _between(params, c, i - 1, h, training, gen)
            h = aggregate(adj, nn.linear_apply(p, h))
        return h


class HoistedCheby(GNNModel):
    """Cheby whose first layer reads the pre-applied Chebyshev sum
    ``x_pre = Σ_k T_k(A) X``."""

    def init(self, gen):
        return Cheby(self.cfg).init(gen)

    def _forward(self, params, x, adj, *, training, gen):
        c = self.cfg
        base = Cheby(c)
        layers = params["layers"]
        p0 = layers[0]
        h = nn.linear_apply(p0["lin"], x) + p0["b"]
        for i, p in enumerate(layers[1:], start=1):
            h = _between(params, c, i - 1, h, training, gen)
            h = base.cheb_layer(p, h, adj, i)
        return h


def _chebsum(x: torch.Tensor, adj: Any, K: int) -> torch.Tensor:
    """Σ_{k<K} T_k(A) X."""
    out = tx0 = x
    if K >= 2:
        tx1 = aggregate(adj, x)
        out = out + tx1
        for _ in range(K - 2):
            tx2 = 2.0 * aggregate(adj, tx1) - tx0
            out = out + tx2
            tx0, tx1 = tx1, tx2
    return out


def hoist_plan(model: GNNModel):
    """(hoisted_model, hops, keep_adj) or None when not hoistable.
    ``hops`` is a power of A, or ``("chebsum", K)``."""
    if isinstance(model, SGC) and model.cfg.ntrans == 1:
        return HoistedSGC(model.cfg), model.cfg.nlayers, False
    if isinstance(model, GCN) and not model.cfg.with_bn:
        return HoistedGCN(model.cfg), 1, True
    if isinstance(model, Cheby) and not model.cfg.with_bn:
        return HoistedCheby(model.cfg), ("chebsum", Cheby.K), True
    return None


def hoist_batch(batch: tuple, hops: int, keep_adj: bool) -> tuple:
    """Pre-propagate one (x, adj, y, idx) tuple for a hoisted model.  When
    the adjacency is not kept, rows are independent, so the batch is cut
    to its ``idx`` rows here (exact, and the epoch loop then touches only
    those rows)."""
    x, adj, y, idx = batch
    if isinstance(hops, tuple):
        # the identity adjacency: every T_k(I) X is X
        x_pre = x * float(hops[1]) if adj is None else \
            _chebsum(x, adj, hops[1])
        return x_pre, (adj if keep_adj else None), y, idx
    x_pre = _propagate_aug(x, adj, hops)
    if keep_adj:
        return x_pre, adj, y, idx
    if idx is not None:
        x_pre, idx = x_pre[idx], None
    return x_pre, None, y, idx
