"""Carry parameters across from the JAX package, as numpy arrays.

The port keeps the JAX package's parameter layout (a linear's ``w`` is
``[in, out]``), so conversion is a walk that turns every array into a
float32 tensor.  The functions take numpy arrays (``np.asarray`` of the
JAX leaves), so this module never imports JAX.  The tensors land on the
CUDA card unless ``device`` says otherwise.

:func:`flatten_params` and :func:`unflatten_params` are the flat layout of
``jax.flatten_util.ravel_pytree``: the leaves in JAX's order (dict keys
sorted, so a linear's ``b`` comes before its ``w``), each raveled row-major,
concatenated.  SFGC's and GEOM's expert buffers hold parameter vectors in
this layout, so a buffer written by either package reads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch.utils import resolve_device, tree_leaves


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32),
                           device=resolve_device(device))


def pge_params_from_jax(tree: dict, device=None) -> dict:
    """JAX PGE params ``{"layers": [{"w", "b"}], "bns": [{"scale",
    "bias"}]}`` → the port's, same structure.  MSGC's edge scorer has
    the same layout and converts the same way."""
    return {
        "layers": [{"w": _t(p["w"], device), "b": _t(p["b"], device)}
                   for p in tree["layers"]],
        "bns": [{"scale": _t(p["scale"], device),
                 "bias": _t(p["bias"], device)} for p in tree["bns"]],
    }


def _linear(p: dict, device) -> dict:
    return {k: _t(v, device) for k, v in p.items()}


def ignr_params_from_jax(tree: dict, device=None) -> dict:
    """JAX IGNR params (``net0``/``net1``: three linears each, ``bn0``/
    ``bn1``: two BatchNorms each, ``P``: the transport plan) → the
    port's, same structure."""
    out = {k: [_linear(p, device) for p in tree[k]]
           for k in ("net0", "net1", "bn0", "bn1")}
    out["P"] = _t(tree["P"], device)
    return out


_MODELS = ("MLP", "GCN", "SGC", "APPNP", "Cheby", "ChebNet", "GraphSage",
           "SAGE", "GAT", "SGFormer")


def model_params_from_jax(name: str, tree: dict, device=None) -> dict:
    """JAX params of any model of the zoo → the port's, same structure:
    MLP/GCN/SGC/APPNP ``{"layers": [{"w", "b"}], "bns"?: [...]}``; Cheby
    ``layers[i] = {"lin": {"w"}, "b"}``; GraphSage ``{"lin": {"w"}}``;
    GAT ``w1, a1, w2, a2``; SGFormer ``t_fc, t_ln[], t_conv[]{wq, wk,
    wv}, g_fc, g_bn[], g_conv[], out``."""
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_MODELS)}")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _t(t, device)

    return walk(tree)


def flatten_params(tree) -> torch.Tensor:
    """The parameter tree as one vector, in ``ravel_pytree``'s layout."""
    return torch.cat([p.reshape(-1) for p in tree_leaves(tree)])


def unflatten_params(flat: torch.Tensor, like):
    """A tree shaped as ``like`` whose leaves are views of ``flat``
    (differentiable in ``flat``); the inverse of :func:`flatten_params`."""
    pos = 0

    def take(leaf):
        nonlocal pos
        n = leaf.numel()
        out = flat[pos:pos + n].view(leaf.shape)
        pos += n
        return out

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return take(t)

    out = walk(like)
    if pos != flat.shape[0]:
        raise ValueError(f"a vector of {flat.shape[0]} values for a tree of "
                         f"{pos}")
    return out
