"""The model zoo: MLP, GCN, SGC, APPNP, Cheby, GraphSage.

Counterparts of the same classes in ``graphslim_tpu/models/zoo.py``:

* MLP: ``nlayers`` linears, the adjacency ignored.
* GCN: per layer ``A @ (X W) + b``; BN?/ReLU/dropout between layers.
* SGC: ``ntrans`` linears (ReLU/dropout between) then ``nlayers``
  propagations ``x = A @ x``.
* APPNP: ``ntrans`` linears (the table's activation between), then
  ``nlayers`` steps ``x = (1 - α)·A@x + α·h``.
* Cheby: per layer ``lin(x) + lin(A x) + b``, K = 2 terms of the
  Chebyshev recurrence ``T_k = 2·A·T_{k-1} − T_{k-2}`` under one shared
  weight.
* GraphSage: per layer ``lin(A x) + lin(x)``, one shared weight.

On a :class:`graphslim_tpu_torch.kernels.sample.BlockSample` APPNP's
teleport term and GraphSage's root are the targets' own rows: the last
(self) slot of each group.  Params may carry a leading batch axis (the
engine's per-class gradients).
"""

from __future__ import annotations

import torch

from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.models.base import (
    GNNModel, ModelConfig, block_level_adj, layer_aggregate,
)


def _block_self_rows(x: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """Rows of ``x`` at the block's targets (the last slot of a group)."""
    m_out, s = weights.shape[-2:]
    return x.reshape(*x.shape[:-2], m_out, s, x.shape[-1])[..., -1, :]


def _stack_dims(c: ModelConfig, depth: int) -> list[int]:
    return ([c.nfeat] + [c.nhid] * (depth - 1) + [c.nclass]
            if depth > 1 else [c.nfeat, c.nclass])


def _stack_init(gen: torch.Generator, c: ModelConfig, depth: int) -> dict:
    dims = _stack_dims(c, depth)
    params = {"layers": [nn.linear_init(gen, a, b)
                         for a, b in zip(dims[:-1], dims[1:])]}
    if c.with_bn and len(dims) > 2:
        params["bns"] = [nn.bn_init(d, gen.device) for d in dims[1:-1]]
    return params


def _between(params, c: ModelConfig, i: int, x, training, gen,
             act=torch.relu):
    """BN (when built with it), the activation and dropout between two
    layers."""
    if c.with_bn:
        x = nn.bn_apply(params["bns"][i], x)
    return nn.dropout(gen, act(x), c.dropout, training)


class GCN(GNNModel):
    def init(self, gen):
        return _stack_init(gen, self.cfg, self.cfg.nlayers)

    def _forward(self, params, x, adj, *, training, gen):
        c = self.cfg
        layers = params["layers"]
        for i, p in enumerate(layers):
            x = nn.linear_apply(p, x)
            x = layer_aggregate(adj, i, x)
            if i != len(layers) - 1:
                x = _between(params, c, i, x, training, gen)
        return x

    def n_layer_features(self):
        return len(_stack_dims(self.cfg, self.cfg.nlayers)) - 1

    def layer_features(self, params, x, adj, depth=None):
        """Each layer's output (the linear map, the aggregation, then BN
        and ReLU below the top) for the first ``depth`` layers only."""
        layers = params["layers"]
        depth = len(layers) if depth is None else depth
        feats = []
        for i, p in enumerate(layers[:depth]):
            x = nn.linear_apply(p, x)
            x = layer_aggregate(adj, i, x)
            if i != len(layers) - 1:
                if self.cfg.with_bn:
                    x = nn.bn_apply(params["bns"][i], x)
                x = torch.relu(x)
            feats.append(x)
        return feats


def _trans_stack_apply(params, c: ModelConfig, x, training, gen,
                       act=torch.relu):
    layers = params["layers"]
    for i, p in enumerate(layers):
        x = nn.linear_apply(p, x)
        if i != len(layers) - 1:
            x = _between(params, c, i, x, training, gen, act)
    return x


class MLP(GNNModel):
    """``nlayers`` linears; the adjacency is ignored."""

    def init(self, gen):
        return _stack_init(gen, self.cfg, self.cfg.nlayers)

    def _forward(self, params, x, adj, *, training, gen):
        return _trans_stack_apply(params, self.cfg, x, training, gen)


class SGC(GNNModel):
    """``nlayers`` = number of propagations; ``ntrans`` transformations."""

    def init(self, gen):
        return _stack_init(gen, self.cfg, self.cfg.ntrans)

    def _forward(self, params, x, adj, *, training, gen):
        x = _trans_stack_apply(params, self.cfg, x, training, gen)
        for i in range(self.cfg.nlayers):
            x = layer_aggregate(adj, i, x)
        return x


class APPNP(GNNModel):
    """``nlayers`` = K power-iteration steps, teleport ``alpha``."""

    def init(self, gen):
        return _stack_init(gen, self.cfg, self.cfg.ntrans)

    def _forward(self, params, x, adj, *, training, gen):
        c = self.cfg
        act = nn.ACTIVATIONS.get(c.activation, torch.relu)
        x = _trans_stack_apply(params, c, x, training, gen, act)
        h = x
        for i in range(c.nlayers):
            kind, a = block_level_adj(adj, i)
            if kind == "block":
                h = _block_self_rows(h, a)
            x = layer_aggregate(adj, i, x)
            x = (1 - c.alpha) * x + c.alpha * h
        return x


def _cheb_init(gen, c: ModelConfig, bias: bool) -> dict:
    dims = _stack_dims(c, c.nlayers)
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        p = {"lin": nn.linear_init(gen, a, b, bias=False)}
        if bias:
            p["b"] = torch.zeros(b, device=gen.device)
        layers.append(p)
    params = {"layers": layers}
    if c.with_bn and len(dims) > 2:
        params["bns"] = [nn.bn_init(d, gen.device) for d in dims[1:-1]]
    return params


class Cheby(GNNModel):
    """Chebyshev stack; each layer shares one weight across its K-term
    recurrence and adds a separate bias."""

    K = 2

    def init(self, gen):
        return _cheb_init(gen, self.cfg, bias=True)

    def cheb_layer(self, p, x, adj, layer: int):
        lin = p["lin"]
        tx0 = x
        out = nn.linear_apply(lin, tx0)
        tx1 = layer_aggregate(adj, layer, x)
        out = out + nn.linear_apply(lin, tx1)
        for _ in range(self.K - 2):
            tx2 = 2.0 * layer_aggregate(adj, layer, tx1) - tx0
            out = out + nn.linear_apply(lin, tx2)
            tx0, tx1 = tx1, tx2
        return out + nn._row(p["b"], lin["w"])

    def _forward(self, params, x, adj, *, training, gen):
        layers = params["layers"]
        for i, p in enumerate(layers):
            x = self.cheb_layer(p, x, adj, i)
            if i != len(layers) - 1:
                x = _between(params, self.cfg, i, x, training, gen)
        return x


class GraphSage(GNNModel):
    """Per layer ``lin(A x) + lin(root)``, one weight for both."""

    def init(self, gen):
        return _cheb_init(gen, self.cfg, bias=False)

    def _forward(self, params, x, adj, *, training, gen):
        layers = params["layers"]
        for i, p in enumerate(layers):
            h = layer_aggregate(adj, i, x)
            kind, a = block_level_adj(adj, i)
            root = _block_self_rows(x, a) if kind == "block" else x
            x = nn.linear_apply(p["lin"], h) + nn.linear_apply(p["lin"],
                                                               root)
            if i != len(layers) - 1:
                x = _between(params, self.cfg, i, x, training, gen)
        return x
