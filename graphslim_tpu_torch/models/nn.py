"""Minimal functional NN primitives: linear, batchnorm, dropout, inits.

Counterpart of ``graphslim_tpu/models/nn.py``.  Params are plain dicts of
tensors in the JAX package's layout (a linear's ``w`` is ``[in, out]``), so
weights carry across unchanged and nested ``torch.autograd.grad`` stays
simple.  Every function also takes params with leading batch axes
(``w`` of shape ``[C, in, out]``): that is how per-class gradients are
computed in one pass (the port's stand-in for ``jax.vmap``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def glorot_uniform(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (shape[0] + shape[-1])), for any rank (GAT's
    ``(2, nheads, h)`` attention vectors take fan-in 2, fan-out h)."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (u * 2.0 - 1.0) * limit


def linear_init(gen: torch.Generator, nin: int, nout: int,
                bias: bool = True) -> dict:
    p = {"w": glorot_uniform(gen, (nin, nout))}
    if bias:
        p["b"] = torch.zeros(nout, device=gen.device)
    return p


def _row(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over the rows of a (batched)
    activation: ``[..., out]`` → ``[..., 1, out]`` when params are
    batched."""
    return v.unsqueeze(-2) if w.ndim > 2 else v


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    out = torch.matmul(x, p["w"])
    if "b" in p:
        out = out + _row(p["b"], p["w"])
    return out


def bn_init(dim: int, device) -> dict:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def bn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Batch norm over the node axis with batch statistics."""
    mu = x.mean(-2, keepdim=True)
    var = x.var(-2, unbiased=False, keepdim=True)
    xhat = (x - mu) * torch.rsqrt(var + 1e-5)
    scale, bias = p["scale"], p["bias"]
    if scale.ndim > 1:
        scale, bias = scale.unsqueeze(-2), bias.unsqueeze(-2)
    return xhat * scale + bias


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            training: bool) -> torch.Tensor:
    if not training or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "linear": lambda x: x,
    "softplus": F.softplus,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "relu6": F.relu6,
    "elu": F.elu,
}
