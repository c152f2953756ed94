"""The model zoo of this slice: GCN and SGC.

Counterparts of the same classes in ``graphslim_tpu/models/zoo.py``:

* GCN: per layer ``A @ (X W) + b``; BN?/ReLU/dropout between layers.
* SGC: ``ntrans`` linears (ReLU/dropout between) then ``nlayers``
  propagations ``x = A @ x``.
"""

from __future__ import annotations

import torch

from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.models.base import (
    GNNModel, ModelConfig, layer_aggregate,
)


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
                if c.with_bn:
                    x = nn.bn_apply(params["bns"][i], x)
                x = torch.relu(x)
                x = nn.dropout(gen, x, c.dropout, training)
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


def _trans_stack_apply(params, c: ModelConfig, x, training, gen):
    layers = params["layers"]
    for i, p in enumerate(layers):
        x = nn.linear_apply(p, x)
        if i != len(layers) - 1:
            if c.with_bn:
                x = nn.bn_apply(params["bns"][i], x)
            x = torch.relu(x)
            x = nn.dropout(gen, x, c.dropout, training)
    return x


class SGC(GNNModel):
    """``nlayers`` = number of propagations; ``ntrans`` transformations."""

    def init(self, gen):
        return _stack_init(gen, self.cfg, self.cfg.ntrans)

    def _forward(self, params, x, adj, *, training, gen):
        x = _trans_stack_apply(params, self.cfg, x, training, gen)
        for i in range(self.cfg.nlayers):
            x = layer_aggregate(adj, i, x)
        return x
