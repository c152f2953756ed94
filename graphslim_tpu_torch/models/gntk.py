"""GNTK: the graph neural tangent kernel in its dense, whole-graph form.

Counterpart of ``graphslim_tpu/models/gntk.py``: ``num_layers``
aggregation rounds with the operator ``A + I`` (row-normalized under the
``degree`` scale), each followed by ``num_mlp_layers - 1`` arc-cosine
kernel recursions.  Dense tensor ops; nothing in either package calls it
on a reduction path.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class GNTK:
    num_layers: int = 2
    num_mlp_layers: int = 2
    scale: str = "degree"   # 'degree' | 'uniform'

    @staticmethod
    def _next(S, diag1, diag2):
        S = torch.clamp(S / diag1[:, None] / diag2[None, :], -0.9999, 0.9999)
        DS = (math.pi - torch.arccos(S)) / math.pi
        S = (S * (math.pi - torch.arccos(S))
             + torch.sqrt(1 - S * S)) / math.pi
        return S * diag1[:, None] * diag2[None, :], DS

    @staticmethod
    def _diag(S):
        return torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))

    def _agg_op(self, A):
        op = A + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        if self.scale == "degree":
            op = op / torch.clamp(op.sum(1, keepdim=True), min=1e-12)
        return op

    def diag_list(self, x, A) -> list:
        op = self._agg_op(A)
        sigma = x @ x.T
        diags = []
        for _ in range(self.num_layers):
            sigma = op @ sigma @ op.T
            for _ in range(self.num_mlp_layers - 1):
                d = self._diag(sigma)
                diags.append(d)
                sigma, _ = self._next(sigma, d, d)
        return diags

    def gntk(self, x1, x2, A1, A2) -> torch.Tensor:
        """The kernel's values ``[n1, n2]`` between two graphs' nodes."""
        op1, op2 = self._agg_op(A1), self._agg_op(A2)
        sigma = theta = x1 @ x2.T
        d1 = self.diag_list(x1, A1)
        d2 = self.diag_list(x2, A2)
        k = 0
        for _ in range(self.num_layers):
            sigma = op1 @ sigma @ op2.T
            theta = op1 @ theta @ op2.T
            for _ in range(self.num_mlp_layers - 1):
                sigma, DS = self._next(sigma, d1[k], d2[k])
                theta = theta * DS + sigma
                k += 1
        return theta
