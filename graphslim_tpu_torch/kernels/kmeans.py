"""K-means (Lloyd's), incremental k-means++ and fuzzy c-means.

Counterpart of ``graphslim_tpu/kernels/kmeans.py`` (and of
``graphslim_tpu/reduce/gecc.py::fuzzy_cmeans``): composed of tensor ops
there (no Pallas kernel), and plain tensor ops here, on the data's device.
The arithmetic is the JAX package's step for step: squared distances by the
expansion ``x² + c² − 2x·c``, the weighted centroid update as a segment
sum, an empty cluster keeping its previous centroid, and ``argmin`` taking
the first index among ties (as ``torch.argmin`` documents).

The random draws cannot follow the JAX key stream, so they come from a
``torch.Generator``: :func:`random_rows` draws the initial centroid rows
(the JAX package's ``jax.random.choice(..., replace=False)``), and the
k-means++ picks are ``torch.multinomial`` draws in place of
``jax.random.categorical``.  The fuzzy c-means always starts from the
centroids its caller gives.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphslim_tpu_torch.kernels.segment import segment_sum


def random_rows(n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """``k`` distinct row indices out of ``n``, drawn from ``gen``."""
    return torch.randperm(n, generator=gen, device=gen.device)[:k]


def sq_distances(x: torch.Tensor, centers: torch.Tensor,
                 x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, k] squared distances ``x² + c² − 2x·c`` (not clamped)."""
    x2 = (x * x).sum(1) if x2 is None else x2
    return (x2[:, None] + (centers * centers).sum(1)[None, :]
            - 2.0 * x @ centers.T)


@torch.no_grad()
def kmeans(x: torch.Tensor, k: int, iters: int = 30,
           weights: Optional[torch.Tensor] = None,
           init: Optional[torch.Tensor] = None,
           gen: Optional[torch.Generator] = None):
    """Return ``(centroids [k, d], assignment [n])``.

    ``init`` warm-starts Lloyd from given centroids; without it the
    initial centroids are ``k`` distinct rows of ``x`` drawn from ``gen``.
    ``weights`` are per-row sample weights of the centroid update.
    """
    if init is None:
        if gen is None:
            raise ValueError("kmeans needs init or a generator")
        init = x[random_rows(x.shape[0], k, gen)]
    centroids = init.to(x.dtype)
    w = x.new_ones(x.shape[0]) if weights is None else weights.to(x.dtype)
    xw = x * w[:, None]
    x2 = (x * x).sum(1)
    for _ in range(iters):
        assign = torch.argmin(sq_distances(x, centroids, x2), dim=1)
        wsum = segment_sum(w, assign, k)
        csum = segment_sum(xw, assign, k)
        new = csum / torch.clamp(wsum, min=1e-12)[:, None]
        # an empty cluster keeps its previous centroid
        centroids = torch.where((wsum > 0)[:, None], new, centroids)
    return centroids, torch.argmin(sq_distances(x, centroids, x2), dim=1)


def kmeanspp_distances(x: torch.Tensor, old_centers: torch.Tensor
                       ) -> torch.Tensor:
    """D² of every row to its nearest old center, clamped at 0; all ones
    when there is no old center (the first pick is then uniform)."""
    if old_centers.shape[0] == 0:
        return x.new_ones(x.shape[0])
    return torch.clamp(sq_distances(x, old_centers).min(dim=1).values,
                       min=0.0)


@torch.no_grad()
def incremental_kmeanspp(x: torch.Tensor, old_centers: torch.Tensor,
                         needed: int, gen: torch.Generator) -> torch.Tensor:
    """Pick ``needed`` new centroids from ``x`` by D² (k-means++) sampling,
    seeded with the distance to ``old_centers`` (which may be empty,
    [0, d]).  All-zero distances fall back to a uniform pick."""
    x2 = (x * x).sum(1)
    nearest = kmeanspp_distances(x, old_centers.to(x.dtype))
    picks = []
    for _ in range(needed):
        total = nearest.sum()
        probs = torch.where(total > 1e-12, nearest,
                            torch.ones_like(nearest))
        idx = torch.multinomial(probs, 1, generator=gen)[0]
        center = x[idx]
        dn = torch.clamp(x2 + (center * center).sum() - 2.0 * (x @ center),
                         min=0.0)
        nearest = torch.minimum(nearest, dn)
        picks.append(center)
    if not picks:
        return x.new_zeros((0, x.shape[1]))
    return torch.stack(picks)


@torch.no_grad()
def fuzzy_cmeans(x: torch.Tensor, k: int, m: float, iters: int,
                 init: torch.Tensor) -> torch.Tensor:
    """Fuzzy c-means centroids (closed-form membership updates) from the
    ``k`` centroids ``init``, with fuzziness exponent ``m``."""
    centers = init.to(x.dtype)
    expo = 2.0 / (m - 1.0)
    x2 = (x * x).sum(1)
    for _ in range(iters):
        d2 = torch.clamp(sq_distances(x, centers, x2), min=1e-12)
        # overflow-safe memberships: normalized by the row minimum before
        # the negative power, so the largest term is exactly 1
        ratio = d2 / d2.min(dim=1, keepdim=True).values
        inv = ratio ** (-expo / 2.0)
        u = inv / inv.sum(dim=1, keepdim=True)
        um = u ** m
        centers = (um.T @ x) / torch.clamp(um.sum(dim=0)[:, None],
                                           min=1e-12)
    return centers
