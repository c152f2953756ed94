"""IGNR — the graphon learner SGDD uses as its structure generator.

Counterpart of ``graphslim_tpu/models/ignr.py`` (reference
``graphslim/models/ignr.py``): two edge-MLP stacks, one over feature pairs
and one over a 2-D coordinate grid, mixed per layer; a learnable transport
plan ``P``; a Laplacian spectral-OT loss through SVD pseudo-inverses.  The
JAX package composes it from XLA ops (no Pallas kernel), so the port is
plain tensor ops, ``torch.linalg.eigh``/``svd`` and ``eigvalsh``
included, all in float32.  The generated adjacency is symmetric, so its
thresholded inverses come from ``eigh`` with a backward of its own
(:class:`_SymPinvParts` says why).

The first linear of the pair stack acts on the concatenation
``[f_i | f_j]``; it is computed as ``f_i·W_i + f_j·W_j + b`` (a linear map
of a concatenation is the sum of two products), so the ``[n², 2·d]``
concatenation is never materialized: ``[n², 128]`` activations are the
largest tensors.  Its BatchNorm takes statistics over all ``n²`` pairs.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from graphslim_tpu_torch.models import nn


def _kept(s: torch.Tensor, eps: float) -> torch.Tensor:
    """Which of the singular values ``s`` the thresholded inverse keeps:
    all when the smallest is at least ``eps``, else all but those equal to
    the smallest (reference ``mx_inv``)."""
    smin = s.min()
    return (s > smin) | (smin >= eps)


def mx_inv(mx: torch.Tensor, eps: float = 0.009) -> torch.Tensor:
    """M^-1 through a thresholded SVD, for any square ``mx`` (the real
    adjacency's corner: computed once, not differentiated)."""
    U, D, Vh = torch.linalg.svd(mx, full_matrices=False)
    inv = torch.where(_kept(D, eps), 1.0 / torch.clamp(D, min=1e-12),
                      torch.zeros_like(D))
    return (U * inv) @ Vh


class _SymPinvParts(torch.autograd.Function):
    """(M^-1/2, M^-1) of a symmetric ``M`` with the SVD threshold rule.

    For M = Q diag(λ) Qᵀ the SVD has U = Q, S = |λ|, Vᵀ = diag(sign λ) Qᵀ,
    so U f(S) Vᵀ = Q diag(sign(λ)·f(|λ|)) Qᵀ: the forward is one ``eigh``.
    Autograd of an SVD or ``eigh`` divides by s_j² − s_i² or λ_j − λ_i,
    which is NaN where two of them are equal, and IGNR's adjacency
    (entries near 0.5, zero diagonal) has a bulk of eigenvalues near
    −0.5: in float32 two can come out equal (one synth-hard run's did,
    and every gradient went NaN).  The backward here is the Daleckii–Krein
    form, Q (L ∘ Qᵀ sym(G) Q) Qᵀ with L_ij the divided difference of
    h(λ) = sign(λ)·f(|λ|), written in closed form so that it stays exact
    and finite at ties (where it is h'): −h_i·h_j for f = 1/s, and
    −1/(r_i r_j (r_i + r_j)) (same signs) or (1/r_i + 1/r_j)/(r_i² + r_j²)
    (opposite signs) for f = 1/√s, r = √|λ|.  A dropped value has h = 0.
    The gradient is symmetric, which is all a symmetric input needs."""

    @staticmethod
    def forward(ctx, mx: torch.Tensor, eps: float):
        lam, Q = torch.linalg.eigh(mx)
        keep = _kept(lam.abs(), eps)
        sgn = torch.sign(lam)
        r = torch.clamp(torch.sqrt(lam.abs()), min=1e-6)
        zero = torch.zeros_like(lam)
        h_rt = torch.where(keep, sgn / r, zero)
        h_inv = torch.where(keep, sgn / (r * r), zero)
        ctx.save_for_backward(Q, lam, keep, r, h_rt, h_inv)
        return (Q * h_rt) @ Q.T, (Q * h_inv) @ Q.T

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rt, g_inv):
        Q, lam, keep, r, h_rt, h_inv = ctx.saved_tensors
        both = keep[:, None] & keep[None, :]
        one = keep[:, None] ^ keep[None, :]
        gap = lam[:, None] - lam[None, :]
        gap = torch.where(one, gap, torch.ones_like(gap))

        def divided(h, kept_pair):
            mixed = (h[:, None] - h[None, :]) / gap
            return torch.where(both, kept_pair, torch.where(
                one, mixed, torch.zeros_like(mixed)))

        ri, rj = r[:, None], r[None, :]
        same = (lam[:, None] * lam[None, :]) > 0
        L_rt = divided(h_rt, torch.where(
            same, -1.0 / (ri * rj * (ri + rj)),
            (1.0 / ri + 1.0 / rj) / (ri * ri + rj * rj)))
        L_inv = divided(h_inv, -h_inv[:, None] * h_inv[None, :])
        inner = torch.zeros_like(Q)
        for g, L in ((g_rt, L_rt), (g_inv, L_inv)):
            if g is not None:
                inner = inner + L * (Q.T @ ((g + g.T) / 2) @ Q)
        return Q @ inner @ Q.T, None


def _pinv_parts(mx: torch.Tensor, eps: float = 0.009) -> tuple:
    """(M^-1/2, M^-1) of the symmetric ``mx`` through the thresholded
    spectrum: when the smallest singular value is under ``eps`` it (and
    any equal to it) is dropped."""
    return _SymPinvParts.apply(mx, eps)


def _mgrid(n: int, device) -> torch.Tensor:
    """The ``[n², 2]`` coordinate grid of the positional stack, in
    [-1, 1], row-major over (i, j), in float32."""
    t = (torch.arange(n, dtype=torch.float32, device=device)
         / max(n - 1, 1) - 0.5) * 2.0
    gi, gj = torch.meshgrid(t, t, indexing="ij")
    return torch.stack([gi, gj], dim=-1).reshape(-1, 2)


@dataclasses.dataclass(frozen=True)
class IGNRConfig:
    node_feature: int
    nnodes: int
    nfeat: int = 128
    ep_ratio: float = 0.5
    mx_size: int = 100


class IGNR:
    def __init__(self, cfg: IGNRConfig):
        self.cfg = cfg

    def init(self, gen: torch.Generator) -> dict:
        c, dev = self.cfg, gen.device
        return {
            "net0": [nn.linear_init(gen, c.node_feature * 2, c.nfeat),
                     nn.linear_init(gen, c.nfeat, c.nfeat),
                     nn.linear_init(gen, c.nfeat, 1)],
            "bn0": [nn.bn_init(c.nfeat, dev), nn.bn_init(c.nfeat, dev)],
            "net1": [nn.linear_init(gen, 2, c.nfeat),
                     nn.linear_init(gen, c.nfeat, c.nfeat),
                     nn.linear_init(gen, c.nfeat, 1)],
            "bn1": [nn.bn_init(c.nfeat, dev), nn.bn_init(c.nfeat, dev)],
            "P": torch.rand((c.mx_size, c.nnodes), generator=gen,
                            device=dev),
        }

    def apply(self, params: dict, feats: torch.Tensor) -> torch.Tensor:
        """The ``[n, n]`` adjacency: symmetrized, sigmoid, zero diagonal."""
        cfg = self.cfg
        n, d = feats.shape
        w0 = params["net0"][0]
        # pair k = (i, j) = (k // n, k % n): [f_i | f_j] W + b
        a = feats @ w0["w"][:d]
        b = feats @ w0["w"][d:] + w0["b"]
        c = (a[:, None, :] + b[None, :, :]).reshape(n * n, -1)
        x = nn.linear_apply(params["net1"][0],
                            _mgrid(n, feats.device).to(feats.dtype))
        for layer in range(3):
            if layer:
                c = nn.linear_apply(params["net0"][layer], c)
                x = nn.linear_apply(params["net1"][layer], x)
            if layer != 2:
                c = torch.relu(nn.bn_apply(params["bn0"][layer], c))
                x = torch.relu(nn.bn_apply(params["bn1"][layer], x))
                x = x * c
            else:
                x = (1 - cfg.ep_ratio) * x + cfg.ep_ratio * c
        adj = x.reshape(n, n)
        adj = torch.sigmoid((adj + adj.T) / 2)
        return adj - torch.diag(torch.diagonal(adj))

    def inference(self, params: dict, feats: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.apply(params, feats)

    def opt_loss(self, params: dict, adj: torch.Tensor,
                 lx_inv: torch.Tensor) -> torch.Tensor:
        """Spectral OT distance between the real Laplacian corner and the
        synthetic graph (reference ``ignr.py:190-208``); ``adj`` is
        symmetric, as :meth:`apply` makes it.  As in the JAX
        package (and the reference), the bilinear form uses the raw ``P``,
        not its Sinkhorn-normalized copy."""
        ly_inv_rt, ly_inv = _pinv_parts(adj)
        P = params["P"]
        inner = ly_inv_rt @ P.T @ lx_inv @ P @ ly_inv_rt
        evals = torch.linalg.eigvalsh((inner + inner.T) / 2)
        return torch.abs(torch.trace(ly_inv) * self.cfg.nnodes
                         - 2 * torch.sqrt(torch.clamp(evals, min=2e-20))
                         .sum())
