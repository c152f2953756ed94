"""Graph-property preservation evaluation.

Counterpart of ``graphslim_tpu/eval/property.py`` (reference
``graphslim/evaluation/graph_property.py:25-173``): density, the trace of
the smallest normalized-Laplacian eigenvalues, spectral radius, mean
clustering coefficient, edge homophily and the Davies–Bouldin index (raw
and Â²X-aggregated features) of the original and the reduced graph.  A
post-hoc analysis on the host in SciPy, as there: a ``SparseAdj`` is read
from its host mirror (the original graph is never read back from the
card), a dense adjacency is copied back once.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.utils import host_array

log = logging.getLogger("graphslim_tpu_torch")


def _to_csr(adj) -> sp.csr_matrix:
    if isinstance(adj, G.SparseAdj):
        h = G.host_of(adj)
        n = h.n_rows
        return sp.csr_matrix((h.values_or_ones(), (h.row, h.col)),
                             shape=(n, n))
    return sp.csr_matrix(host_array(adj))


def density(W: sp.csr_matrix) -> float:
    n = W.shape[0]
    return float(W.nnz / max(n * (n - 1), 1))


def laplacian_trace(W: sp.csr_matrix, k: int = 10) -> float:
    """Sum of the k smallest normalized-Laplacian eigenvalues: a dense
    ``eigvalsh`` up to 2000 nodes, ARPACK above (shift-invert at
    σ = −0.01, ``'SA'`` if that fails; ``tol`` 1e-4)."""
    n = W.shape[0]
    deg = np.asarray(W.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    L = sp.eye(n) - sp.diags(dinv) @ W @ sp.diags(dinv)
    k = min(k, n - 2)
    if k < 1:
        return 0.0
    if n <= 2000:
        vals = np.linalg.eigvalsh(L.toarray())[:k]
    else:
        # 'LM' on (L - σI)^-1 converges in a few iterations where 'SA' on
        # L can take thousands
        try:
            vals = sp.linalg.eigsh(L.tocsc(), k=k, sigma=-0.01,
                                   which="LM", return_eigenvectors=False,
                                   tol=1e-4)
        except Exception:
            vals = sp.linalg.eigsh(L, k=k, which="SA",
                                   return_eigenvectors=False, tol=1e-4,
                                   maxiter=2000)
    return float(np.sum(vals))


def spectral_radius(W: sp.csr_matrix) -> float:
    n = W.shape[0]
    if n <= 2000:
        return float(np.max(np.abs(
            np.linalg.eigvalsh(W.toarray().astype(np.float64)))))
    v = sp.linalg.eigsh(W.astype(np.float64), k=1, which="LM",
                        return_eigenvectors=False, tol=1e-4)
    return float(abs(v[0]))


def clustering_coefficient(W: sp.csr_matrix) -> float:
    """Mean local clustering coefficient (binary graph)."""
    A = (W > 0).astype(np.float64)
    A = A - sp.diags(A.diagonal())
    deg = np.asarray(A.sum(1)).ravel()
    tri = (A @ A).multiply(A).sum(axis=1)
    tri = np.asarray(tri).ravel() / 2.0
    denom = deg * (deg - 1) / 2.0
    cc = np.where(denom > 0, tri / np.maximum(denom, 1), 0.0)
    return float(cc.mean())


def homophily(W: sp.csr_matrix, labels: np.ndarray) -> float:
    coo = W.tocoo()
    if coo.nnz == 0:
        return 0.0
    same = labels[coo.row] == labels[coo.col]
    return float(same.mean())


def davies_bouldin(feat: np.ndarray, labels: np.ndarray) -> float:
    """DB index (lower = better-separated class clusters)."""
    classes = np.unique(labels)
    if len(classes) < 2:
        return 0.0
    cents, scatter = [], []
    for c in classes:
        x = feat[labels == c]
        mu = x.mean(0)
        cents.append(mu)
        scatter.append(np.linalg.norm(x - mu, axis=1).mean())
    cents = np.stack(cents)
    k = len(classes)
    db = 0.0
    for i in range(k):
        worst = 0.0
        for j in range(k):
            if i == j:
                continue
            d = np.linalg.norm(cents[i] - cents[j])
            worst = max(worst, (scatter[i] + scatter[j]) / max(d, 1e-12))
        db += worst
    return float(db / k)


class PropertyEvaluator:
    """Compare structural and feature properties of original vs reduced."""

    def __init__(self, data: G.Dataset, args):
        self.data = data
        self.args = args

    def properties(self, adj, feat, labels) -> dict:
        feat_np = host_array(feat)
        W = _to_csr(adj) if adj is not None else sp.csr_matrix(
            (feat_np.shape[0], feat_np.shape[0]))
        labels_np = host_array(labels)
        if labels_np.ndim == 2:
            labels_np = labels_np.argmax(1)
        out = {
            "density": density(W),
            "laplacian_trace": laplacian_trace(W),
            "spectral_radius": spectral_radius(W),
            "cluster_coefficient": clustering_coefficient(W),
            "homophily": homophily(W, labels_np),
            "davies_bouldin": davies_bouldin(feat_np, labels_np),
        }
        # the aggregated-feature DB index (reference
        # graph_property.py:150-173), by a host SciPy product
        if W.nnz:
            n = W.shape[0]
            A = (W + sp.eye(n, format="csr")).tocsr()
            deg = np.asarray(A.sum(1)).ravel()
            with np.errstate(divide="ignore"):
                dinv = np.where(deg > 0, deg ** -0.5, 0.0)
            Dn = sp.diags(dinv)
            An = Dn @ A @ Dn
            agg = An @ (An @ feat_np.astype(np.float64))
            out["davies_bouldin_agg"] = davies_bouldin(
                np.asarray(agg, dtype=np.float32), labels_np)
        return out

    def compare(self, reduced: G.Reduced) -> dict:
        d = self.data
        ori = self.properties(d.adj, d.feat, d.labels)
        red = self.properties(reduced.adj, reduced.feat, reduced.labels)
        return {"original": ori, "reduced": red}
