"""SNTK — the structure-based neural tangent kernel of GCSNTK.

Counterpart of ``graphslim_tpu/models/sntk.py``.  The aggregation
``(E1 ⊗ E2) vec(S)`` is written as the two dense products ``E1 S E2ᵀ``, and
kernel ridge regression solves with ``torch.linalg.solve``: plain tensor
ops (the JAX package has no Pallas kernel here either), differentiable in
the synthetic features and labels.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SNTK:
    K: int = 2
    L: int = 2
    scale: str = "average"   # 'add' | 'average'

    def _scale_mat(self, E1: torch.Tensor, E2: torch.Tensor):
        if self.scale == "add":
            return 1.0
        denom = E1.sum(1)[:, None] * E2.sum(1)[None, :]
        return 1.0 / torch.clamp(denom, min=1e-12)

    @staticmethod
    def _aggr(S, E1, E2, scale_mat):
        return (E1 @ S @ E2.T) * scale_mat

    @staticmethod
    def _arccos_step(Sn: torch.Tensor) -> torch.Tensor:
        return (Sn * (math.pi - torch.arccos(Sn))
                + torch.sqrt(1 - Sn * Sn)) / math.pi

    @classmethod
    def _update_diag(cls, S: torch.Tensor):
        diag = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        Sn = torch.clamp(S / diag[:, None] / diag[None, :], -0.9999, 0.9999)
        return cls._arccos_step(Sn) * diag[:, None] * diag[None, :], diag

    @classmethod
    def _update_sigma(cls, S, diag1, diag2):
        Sn = torch.clamp(S / diag1[:, None] / diag2[None, :], -0.9999,
                         0.9999)
        degree_sigma = (math.pi - torch.arccos(Sn)) / math.pi
        return cls._arccos_step(Sn) * diag1[:, None] * diag2[None, :], \
            degree_sigma

    def _diag_list(self, g: torch.Tensor, E: torch.Tensor) -> list:
        scale_mat = self._scale_mat(E, E)
        sigma = g @ g.T
        diags = []
        for _ in range(self.K):
            sigma = self._aggr(sigma, E, E, scale_mat)
            sigma, diag = self._update_diag(sigma)
            diags.append(diag)
        return diags

    def nodes_gram(self, g1: torch.Tensor, g2: torch.Tensor,
                   E1: torch.Tensor, E2: torch.Tensor) -> torch.Tensor:
        """NTK gram matrix [n1, n2] between two node sets with dense
        aggregation matrices ``E1`` [n1, n1] and ``E2`` [n2, n2]."""
        scale_mat = self._scale_mat(E1, E2)
        sigma = g1 @ g2.T
        theta = sigma
        d1 = self._diag_list(g1, E1)
        d2 = self._diag_list(g2, E2)
        for k in range(self.K):
            sigma = self._aggr(sigma, E1, E2, scale_mat)
            theta = self._aggr(theta, E1, E2, scale_mat)
            for _ in range(self.L):
                sigma, degree_sigma = self._update_sigma(sigma, d1[k], d2[k])
                theta = theta * degree_sigma + sigma
        return theta


def krr_forward(kernel, ridge: float, g_t, g_s, y_s, E_t, E_s):
    """Kernel ridge regression prediction
    ``softmax(K_ts (K_ss + ridge·tr(K_ss)/n·I)⁻¹ y_s)``."""
    K_ss = kernel(g_s, g_s, E_s, E_s)
    K_ts = kernel(g_t, g_s, E_t, E_s)
    n = g_s.shape[0]
    reg = ridge * torch.trace(K_ss) * torch.eye(
        n, dtype=K_ss.dtype, device=K_ss.device) / n
    b = torch.linalg.solve(K_ss + reg, y_s)
    return torch.softmax(K_ts @ b, dim=1)
