"""Model base: adjacency dispatch + the shared GNN skeleton.

Counterpart of ``graphslim_tpu/models/base.py``.  ``aggregate`` takes:

* :class:`graphslim_tpu_torch.graph.SparseAdj` — its ``matmul``, the SpMM
  dispatch (on the card: the blocked SpMM kernel);
* :class:`graphslim_tpu_torch.kernels.ell.EllAdj` — the degree-bucketed
  ELL product (GAT's layout; plain tensor ops);
* a dense ``[n, n]`` tensor — matmul (synthetic condensed graphs; ``x``
  may carry a leading batch axis);
* a dense batch ``[B, n, n]`` (MSGC's skeletons) — the batched matmul;
  ``apply`` then merges the skeleton and node axes of the output to
  ``[..., B·n, nclass]``, as the JAX package flattens its output;
* :class:`graphslim_tpu_torch.kernels.sample.BlockSample` — the
  contiguous-slot weighted reshape-sum of sampled neighbourhoods;
* ``None`` — identity (structure-free methods).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.kernels.ell import EllAdj
from graphslim_tpu_torch.kernels.sample import BlockSample


def is_skeleton_batch(adj: Any) -> bool:
    """Whether ``adj`` is a batch of dense synthetic graphs ``[B, n, n]``
    (MSGC's skeletons)."""
    return isinstance(adj, torch.Tensor) and adj.ndim == 3


def aggregate(adj: Any, x: torch.Tensor) -> torch.Tensor:
    """One propagation step A @ x for any supported adjacency form."""
    if adj is None:
        return x
    if isinstance(adj, (G.SparseAdj, EllAdj)):
        return adj.matmul(x)
    if is_skeleton_batch(adj) and x.ndim == 4:
        return _skeleton_matmul(adj, x)
    return torch.matmul(adj, x)


def _skeleton_matmul(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[B, n, n] @ [C, B or 1, n, h]`` → ``[C, B, n, h]`` as one product
    per skeleton, the class axis folded into the columns (a broadcast
    ``torch.matmul`` would copy the adjacency once per class)."""
    C, b, n, h = x.shape
    cols = x.permute(1, 2, 0, 3).reshape(b, n, C * h)
    out = torch.matmul(adj, cols[0] if b == 1 else cols)
    return out.reshape(adj.shape[0], n, C, h).permute(2, 0, 1, 3)


def aggregate_block(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One sampled-block level: ``weights [..., m_out, s]``,
    ``x [..., m_out * s, d]`` → ``[..., m_out, d]``."""
    m_out, s = weights.shape[-2:]
    xr = x.reshape(*x.shape[:-2], m_out, s, x.shape[-1])
    return torch.einsum("...ms,...msd->...md", weights.to(x.dtype), xr)


def block_level_adj(adj: Any, layer: int):
    """Per-layer adjacency for list/BlockSample forms; identity otherwise."""
    if isinstance(adj, BlockSample):
        return ("block", adj.weights[layer])
    if isinstance(adj, (list, tuple)):
        return ("plain", adj[layer])
    return ("plain", adj)


def layer_aggregate(adj: Any, layer: int, x: torch.Tensor) -> torch.Tensor:
    kind, a = block_level_adj(adj, layer)
    if kind == "block":
        return aggregate_block(a, x)
    return aggregate(a, x)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static hyperparameters shared by the zoo."""

    nfeat: int
    nhid: int
    nclass: int
    nlayers: int = 2
    dropout: float = 0.5
    alpha: float = 0.1
    ntrans: int = 1
    with_bn: bool = False
    activation: str = "relu"
    nheads: int = 8             # GAT
    trans_layers: int = 2       # SGFormer's transformer depth
    multi_label: bool = False   # sigmoid scores in place of log-softmax


class GNNModel:
    """Base: subclasses define ``init`` and ``_forward``; ``apply``
    returns log-probabilities over the last axis, or sigmoid scores when
    ``multi_label``."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, gen: torch.Generator) -> dict:
        raise NotImplementedError

    def _forward(self, params: dict, x: torch.Tensor, adj: Any, *,
                 training: bool, gen: Optional[torch.Generator]
                 ) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params: dict, x: torch.Tensor, adj: Any, *,
              training: bool = False,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self._forward(params, x, adj, training=training, gen=gen)
        if is_skeleton_batch(adj):
            out = out.flatten(-3, -2)
        if self.cfg.multi_label:
            return torch.sigmoid(out)
        return torch.log_softmax(out, dim=-1)

    def embed(self, params: dict, x: torch.Tensor, adj: Any
              ) -> torch.Tensor:
        """Pre-softmax output, rows flattened to ``[-1, nclass]``."""
        out = self._forward(params, x, adj, training=False, gen=None)
        return out.reshape(-1, out.shape[-1])

    def n_layer_features(self) -> int:
        """How many activations :meth:`layer_features` returns."""
        return 1

    def layer_features(self, params: dict, x: torch.Tensor, adj: Any,
                       depth: Optional[int] = None) -> list:
        """Per-layer activations (distribution matching, GCDM).  A model
        with a stacked structure overrides this and computes only the
        first ``depth`` layers (all when None); the default is the final
        pre-softmax embedding alone."""
        return [self._forward(params, x, adj, training=False, gen=None)]
