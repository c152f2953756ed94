"""Carry parameters across from the JAX package, as numpy arrays.

The port keeps the JAX package's parameter layout (a linear's ``w`` is
``[in, out]``), so conversion is a walk that turns every array into a
float32 tensor.  The functions take numpy arrays (``np.asarray`` of the
JAX leaves), so this module never imports JAX.  The tensors land on the
CUDA card unless ``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch.utils import resolve_device


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


def model_params_from_jax(name: str, tree: dict, device=None) -> dict:
    """JAX SGC/GCN params (``{"layers": [{"w", "b"}], "bns"?: [...]}``,
    the BatchNorms of a model built ``with_bn``) → the port's."""
    if name not in ("SGC", "GCN"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, queue 1, "
            "item 12)")
    out = {"layers": [_linear(p, device) for p in tree["layers"]]}
    if "bns" in tree:
        out["bns"] = [_linear(p, device) for p in tree["bns"]]
    return out
