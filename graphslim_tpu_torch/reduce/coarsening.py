"""Structural coarsening: variation families, proximity matching, Kron.

Counterpart of ``graphslim_tpu/reduce/coarsening.py``:

* Per-component multi-level loop (components of more than 10 nodes that
  hold a train node; ``scipy.sparse.csgraph.connected_components``).
* Local-variation costs (Loukas 2019): candidate sets scored by
  ``‖B_setᵀ L_set B_set‖ / (nc−1)`` with B from the first-K Laplacian
  eigenbasis (:meth:`CoarsenBase.basis`): a dense float32
  ``torch.linalg.eigh`` on the dataset's device for components of at most
  ``_DENSE_EIG_CUTOFF`` nodes, ARPACK in float64 on the host above.  Only
  the variation family computes it; the proximity family never reads it.
* Greedy non-overlapping selection with exact re-costing (heap).
* Proximity matching (ten measures: heavy-edge, algebraic-JC and
  affinity-GS test vectors, Lanczos and Chebyshev variants) and Kron
  reduction (Schur complement, dense on the host in float64).
* The matchings (greedy and the exact blossom) are the native host
  library's (:mod:`graphslim_tpu_torch.native`).

Everything else is host NumPy and SciPy, as in the JAX package; the lifted
features, labels and coarse adjacency land on the dataset's device.  A
component's submatrix is cut as ``W[nodes][:, nodes]`` (the same entries
in the same order as ``W[np.ix_(nodes, nodes)]``, without its n² index).
"""

from __future__ import annotations

import heapq
import logging

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import native
from graphslim_tpu_torch.reduce.base import Reducer
from graphslim_tpu_torch.reduce.edge_sparsify import _to_scipy

log = logging.getLogger("graphslim_tpu_torch")

_DENSE_EIG_CUTOFF = 3000


def _laplacian(W: sp.csr_matrix) -> sp.csr_matrix:
    deg = np.asarray(W.sum(1)).ravel()
    return sp.diags(deg) - W


def _eigsh_smallest(L, W, k, tol, return_eigenvectors=True):
    """Smallest-k Laplacian eigenpairs via the shifted-LM transform:
    ARPACK ``which='LM'`` on ``offset·I − L`` (offset = the Gershgorin
    bound 2·max_deg ≥ λ_max).  ``tol`` is divided by the offset, so it
    bounds the eigenvalues' absolute error.  Eigenvalues ascending."""
    n = L.shape[0]
    offset = 2.0 * float(np.asarray(W.sum(1)).max()) or 1.0
    tol = tol / offset
    T = offset * sp.eye(n, format="csc") - L.tocsc()
    if return_eigenvectors:
        lk, Uk = sp.linalg.eigsh(T, k=k, which="LM", tol=tol)
        return (offset - lk)[::-1], Uk[:, ::-1]
    lk = sp.linalg.eigsh(T, k=k, which="LM", tol=tol,
                         return_eigenvectors=False)
    return np.sort(offset - lk)


def _first_k_basis(W: sp.csr_matrix, K: int, device) -> np.ndarray:
    """B = U_K diag(λ_K^-1/2) of the Laplacian (λ_0 zeroed); the dense
    eigensolve runs in float32 on ``device`` and comes back as float32."""
    n = W.shape[0]
    K = min(K, n - 1)
    L = _laplacian(W)
    if n <= _DENSE_EIG_CUTOFF:
        lk, Uk = torch.linalg.eigh(torch.as_tensor(
            L.toarray(), dtype=torch.float32, device=device))
        lk = lk.cpu().numpy()[: K]
        Uk = Uk.cpu().numpy()[:, : K]
    else:
        lk, Uk = _eigsh_smallest(L, W, K, tol=1e-5)
    mask = lk < 1e-10
    lk = np.where(mask, 1.0, lk)
    lsinv = lk ** -0.5
    lsinv[mask] = 0.0
    return Uk * lsinv[None, :]


def _get_coarsening_matrix(n: int, partitioning: list[np.ndarray]
                           ) -> sp.csr_matrix:
    """Projection-style C: supernode rows carry 1/sqrt(nc)."""
    keep = np.ones(n, dtype=bool)
    rows, cols, vals = [], [], []
    super_of = {}
    for part in partitioning:
        keep[part[1:]] = False
        super_of[part[0]] = part
    new_ids = np.cumsum(keep) - 1
    for i in np.flatnonzero(keep):
        if i in super_of:
            part = super_of[i]
            rows.extend([new_ids[i]] * len(part))
            cols.extend(part.tolist())
            vals.extend([1.0 / np.sqrt(len(part))] * len(part))
        else:
            rows.append(new_ids[i])
            cols.append(i)
            vals.append(1.0)
    m = int(keep.sum())
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, n))


def _coarsen_matrix(W: sp.spmatrix, C: sp.csr_matrix) -> sp.csr_matrix:
    """Pinvᵀ W Pinv with Pinv = (C D)ᵀ, D = diag(1/colsum C)."""
    D = sp.diags(1.0 / np.asarray(C.sum(0)).ravel())
    Pinv = (C @ D).T
    return sp.csr_matrix(Pinv.T @ (W @ Pinv))


def _zero_diag(A: sp.spmatrix) -> sp.csr_matrix:
    A = sp.csr_matrix(A)
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def _set_cost(W_lil, deg, B, nodes: np.ndarray) -> float:
    """Local variation cost of contracting ``nodes``."""
    nc = len(nodes)
    if nc < 2:
        return np.inf
    Wl = W_lil[np.ix_(nodes, nodes)]
    Wl = np.asarray(Wl.todense()) if sp.issparse(Wl) else Wl
    Ll = np.diag(2 * deg[nodes] - Wl.sum(1)) - Wl
    Bl = B[nodes, :]
    Bl = Bl - Bl.mean(0, keepdims=True)
    return float(np.linalg.norm(Bl.T @ Ll @ Bl)) / (nc - 1)


def _edge_cost(deg, B, i, j, w) -> float:
    """The cost of contracting one edge (the 2-node set)."""
    deg_new = 2 * deg[[i, j]] - w
    L = np.array([[deg_new[0], -w], [-w, deg_new[1]]])
    Bl = B[[i, j], :]
    Bl = Bl - Bl.mean(0, keepdims=True)
    return float(np.linalg.norm(Bl.T @ L @ Bl))


def _greedy_set_selection(costs, sets, n, r_cur,
                          recost=None) -> list[np.ndarray]:
    """Pop lowest-cost candidate sets; overlapping sets are stripped of
    marked nodes, re-costed exactly by ``recost(nodes)`` and pushed back;
    sets larger than the remaining budget are skipped."""
    heap = [(c, k) for k, c in enumerate(costs)]
    heapq.heapify(heap)
    marked = np.zeros(n, dtype=bool)
    out = []
    n_reduce = int(np.floor(r_cur * n))
    stale = {}
    while heap and n_reduce > 0:
        cost, k = heapq.heappop(heap)
        nodes = stale.get(k, sets[k])
        live = nodes[~marked[nodes]]
        if len(live) != len(nodes):
            # shrunk: requeue at its exact recomputed cost
            if len(live) > 1:
                stale[k] = live
                new_cost = (recost(live) if recost is not None
                            else cost * len(live) / len(nodes))
                heapq.heappush(heap, (new_cost, k))
            continue
        if len(nodes) < 2:
            continue
        n_gain = len(nodes) - 1
        if n_gain > n_reduce:
            continue
        marked[nodes] = True
        out.append(nodes)
        n_reduce -= n_gain
    return out


def _greedy_matching(edges: np.ndarray, weights: np.ndarray, n: int,
                     r: float) -> list[np.ndarray]:
    """Heavy-weight-first disjoint matching (native)."""
    return list(native.greedy_matching(edges[0], edges[1], weights, n, r))


def _optimal_matching(edges: np.ndarray, costs: np.ndarray, n: int,
                      r: float) -> list[np.ndarray]:
    """Exact minimum-cost matching: maximize Σ(max_cost − cost) over a
    matching with the native Edmonds blossom (O(n³)), then keep the
    ``ceil(r·n)`` cheapest matched pairs.  Greedy above 3000 nodes."""
    costs = np.asarray(costs, dtype=np.float64)
    if n > 3000:  # O(n³): minutes beyond this
        log.warning("optimal matching: component n=%d > 3000, using greedy",
                    n)
        return _greedy_matching(edges, -costs, n, r)
    pairs = native.max_weight_matching(edges[0], edges[1],
                                       costs.max() - costs, n)
    lut: dict[tuple[int, int], float] = {}
    for e in range(edges.shape[1]):
        a, b = int(edges[0, e]), int(edges[1, e])
        key = (a, b) if a < b else (b, a)
        c = float(costs[e])
        if key not in lut or c < lut[key]:
            lut[key] = c
    pair_costs = np.array([lut[(min(i, j), max(i, j))] for i, j in pairs])
    keep = min(int(np.ceil(r * n)), len(pairs))
    idx = np.argsort(pair_costs)[:keep]
    return [np.asarray(pairs[k]) for k in idx]


def _jacobi_vectors(W, num_vectors=10, iterations=20, seed=0):
    """x ← x/2 + D⁻¹(D−L)x/2 smoothing of random vectors."""
    n = W.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, num_vectors)) / np.sqrt(n)
    L = _laplacian(W)
    deg = np.asarray(W.sum(1)).ravel()
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    M = sp.diags(dinv) @ (sp.diags(deg) - L)
    for _ in range(iterations):
        X = 0.5 * X + 0.5 * (M @ X)
    return X


def _gauss_seidel_vectors(W, num_vectors=10, iterations=1, seed=0):
    n = W.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, num_vectors)) / np.sqrt(n)
    L = _laplacian(W).tocsc()
    L_upper = sp.triu(L, 1, format="csc")
    L_lower = sp.triu(L, 0, format="csc").T.tocsr()
    # guard zero diagonal (isolated nodes)
    diag = L_lower.diagonal()
    if (diag == 0).any():
        L_lower = L_lower + sp.diags((diag == 0) * 1.0)
    for j in range(num_vectors):
        x = X[:, j]
        for _ in range(iterations):
            x = -sp.linalg.spsolve_triangular(L_lower, L_upper @ x,
                                              lower=True)
        X[:, j] = x
    return X


def _chebyshev_vectors(W, num_vectors=10, K=10, order=50, seed=0):
    """Low-pass (λ ≤ λ_{K+1}) Chebyshev-filtered random vectors (an
    order-50 filter)."""
    n = W.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, num_vectors)) / np.sqrt(n)
    L = _laplacian(W).tocsr()
    # spectrum bounds: λ_max upper bound (Gershgorin) + cutoff λ_{K+1}
    lmax = float(2.0 * np.asarray(W.sum(1)).max()) or 1.0
    k_cut = min(K + 2, n - 1)
    if n <= _DENSE_EIG_CUTOFF:
        lk = np.linalg.eigvalsh(L.toarray())[:k_cut]
    else:
        lk = _eigsh_smallest(L, W, k_cut, tol=1e-2,
                             return_eigenvectors=False)
    lam_cut = float(lk[-1])
    # Chebyshev coefficients of the ideal step h(λ) = 1[λ <= λ_cut] on
    # [0, lmax] (quadrature at the Chebyshev nodes)
    N = order + 1
    j = np.arange(N)
    grid = lmax / 2.0 * (np.cos(np.pi * (j + 0.5) / N) + 1.0)
    h = (grid <= lam_cut).astype(np.float64)
    c = np.array([2.0 / N * (h * np.cos(np.pi * k * (j + 0.5) / N)).sum()
                  for k in range(N)])
    # three-term recurrence on the shifted operator
    a = lmax / 2.0
    T0, T1 = X, (L @ X) / a - X
    out = 0.5 * c[0] * T0 + c[1] * T1
    for k in range(2, N):
        T2 = 2.0 * ((L @ T1) / a - T1) - T0
        out = out + c[k] * T2
        T0, T1 = T1, T2
    return out


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------

class CoarsenBase(Reducer):
    """Component decomposition + multi-level coarsening + label lifting."""

    K = 10
    max_levels = 10
    # whether contract_sets reads the Laplacian basis
    uses_basis = True

    def basis(self, W: sp.csr_matrix) -> np.ndarray:
        """The first-K Laplacian basis of a component (its first level)."""
        return _first_k_basis(W, self.K, self.data.device)

    # subclass hook: choose contraction sets for one level
    def contract_sets(self, W, B, r_cur) -> list[np.ndarray]:
        raise NotImplementedError

    # subclass hook: the coarse adjacency emitted for one component.
    # Default: lift W through the coarsening matrix; Kron returns its
    # Schur complement instead.
    def component_adj(self, W: sp.csr_matrix,
                      C: sp.csr_matrix) -> sp.csr_matrix:
        return _zero_diag(_coarsen_matrix(W, C))

    def coarsen_component(self, W: sp.csr_matrix) -> sp.csr_matrix:
        """Multi-level loop: returns C [n_coarse, n]."""
        r = float(np.clip(self.args.reduction_rate, 0, 0.999))
        N = W.shape[0]
        n, n_target = N, np.ceil(r * N)
        C = sp.eye(N, format="csr")
        B = A_basis = None
        Wc = W
        for level in range(1, self.max_levels + 1):
            r_cur = float(np.clip(1 - n_target / n, 0.0, 0.99))
            if r_cur <= 0:
                break
            if self.uses_basis and B is None:
                B = self.basis(Wc)
                A_basis = B
            elif self.uses_basis:
                # lift basis through the previous level and re-orthonorm
                d, V = np.linalg.eig(B.T @ (_laplacian(Wc) @ B))
                d, V = np.real(d), np.real(V)
                mask = d <= 0
                d = np.where(mask, 1.0, d)
                dinvsqrt = (d + 1e-9) ** -0.5
                dinvsqrt[mask] = 0.0
                A_basis = B @ V @ np.diag(dinvsqrt)
            parts = self.contract_sets(Wc, A_basis, r_cur)
            if not parts:
                break
            iC = _get_coarsening_matrix(n, parts)
            if iC.shape[1] - iC.shape[0] <= 2:
                break
            C = iC @ C
            Wc = _zero_diag(_coarsen_matrix(Wc, iC))
            Wc = (Wc + Wc.T) / 2
            if B is not None:
                B = iC @ B
            n = Wc.shape[0]
            if n <= n_target:
                break
        return sp.csr_matrix(C)

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        # the full graph, or the train subgraph in the inductive setting
        feat, _, labels = data.train_graph()
        feats = feat.cpu().numpy()
        labels = labels.cpu().numpy()
        n = feats.shape[0]
        train_mask = np.zeros(n, dtype=bool)
        train_mask[data.pool_ids()] = True
        W = _to_scipy(data.train_host())
        n_comp, comp = csgraph.connected_components(W, directed=False)

        nclass = data.nclass
        feat_out, label_out, mask_out = [], [], []
        rows_out, cols_out, vals_out = [], [], []
        offset = 0
        for ci in range(n_comp):
            nodes = np.flatnonzero(comp == ci)
            if len(nodes) <= 10 or not train_mask[nodes].any():
                continue  # tiny components are dropped
            Wc = sp.csr_matrix(W[nodes][:, nodes])
            C = self.coarsen_component(Wc)
            # features / labels / masks lifted through C; labels of
            # non-train nodes are zeroed first, so a supernode is kept iff
            # it holds a train node and its train labels agree
            onehot = np.eye(nclass, dtype=np.float32)[labels[nodes]]
            onehot[~train_mask[nodes]] = 0.0
            lifted_labels = C @ onehot
            new_mask = lifted_labels.sum(1) > 0
            mixed = (lifted_labels > 0).sum(1) > 1
            new_mask[mixed] = False
            feat_out.append(C @ feats[nodes])
            label_out.append(np.argmax(lifted_labels, 1))
            mask_out.append(new_mask)
            Wcc = self.component_adj(Wc, C).tocoo()
            rows_out.append(Wcc.row + offset)
            cols_out.append(Wcc.col + offset)
            vals_out.append(Wcc.data)
            offset += C.shape[0]

        feat = np.concatenate(feat_out, 0)
        lab = np.concatenate(label_out, 0)
        msk = np.concatenate(mask_out, 0)
        ei = np.stack([np.concatenate(rows_out), np.concatenate(cols_out)])
        ew = np.concatenate(vals_out)
        keep = np.flatnonzero(msk)
        lookup = -np.ones(offset, dtype=np.int64)
        lookup[keep] = np.arange(len(keep))
        er, ec = lookup[ei[0]], lookup[ei[1]]
        sel = (er >= 0) & (ec >= 0)
        dev = data.device
        adj_syn = G.from_edge_index(np.stack([er[sel], ec[sel]]),
                                    len(keep), edge_weight=ew[sel],
                                    dedup=True, device=dev)
        return G.Reduced(
            feat=torch.as_tensor(feat[keep], dtype=torch.float32,
                                 device=dev),
            adj=adj_syn,
            labels=torch.as_tensor(lab[keep].astype(np.int64), device=dev))


# ---------------------------------------------------------------------------
# Variation family
# ---------------------------------------------------------------------------

class VariationNeighborhoods(CoarsenBase):
    """Candidate sets = closed neighborhoods."""

    def contract_sets(self, W, B, r_cur):
        n = W.shape[0]
        deg = np.asarray(W.sum(1)).ravel()
        W_lil = W.tolil()
        Wb = (W > 0) + sp.eye(n, dtype=bool, format="csr")
        sets = [np.asarray(Wb[i].indices) for i in range(n)]
        costs = [_set_cost(W_lil, deg, B, s) for s in sets]
        return _greedy_set_selection(
            costs, sets, n, r_cur,
            recost=lambda s: _set_cost(W_lil, deg, B, s))


class VariationEdges(CoarsenBase):
    """Candidate sets = edges, matched greedily (or exactly) by the
    2-node cost."""

    def contract_sets(self, W, B, r_cur):
        n = W.shape[0]
        deg = np.asarray(W.sum(1)).ravel()
        Wu = sp.triu(W, 1).tocoo()
        edges = np.stack([Wu.row, Wu.col])
        costs = np.array([
            _edge_cost(deg, B, int(i), int(j), float(w))
            for i, j, w in zip(Wu.row, Wu.col, Wu.data)])
        if self.args.coarsen_strategy == "optimal":
            return _optimal_matching(edges, costs, n, r_cur)
        return _greedy_matching(edges, -costs, n, r_cur)


class VariationCliques(CoarsenBase):
    """Candidate sets = cliques grown greedily from each node (at most
    ``max_clique`` nodes)."""

    max_clique = 6

    def contract_sets(self, W, B, r_cur):
        n = W.shape[0]
        deg = np.asarray(W.sum(1)).ravel()
        W_lil = W.tolil()
        adj_sets = [set(W.getrow(i).indices.tolist()) for i in range(n)]
        sets, seen = [], set()
        for i in range(n):
            clique = [i]
            for j in sorted(adj_sets[i]):
                if all(j in adj_sets[k] for k in clique):
                    clique.append(j)
                    if len(clique) >= self.max_clique:
                        break
            key = frozenset(clique)
            if len(clique) >= 2 and key not in seen:
                seen.add(key)
                sets.append(np.asarray(sorted(clique)))
        costs = [_set_cost(W_lil, deg, B, s) for s in sets]
        return _greedy_set_selection(
            costs, sets, n, r_cur,
            recost=lambda s: _set_cost(W_lil, deg, B, s))


# ---------------------------------------------------------------------------
# Proximity-matching family
# ---------------------------------------------------------------------------

class _ProximityCoarsen(CoarsenBase):
    """Proximity-measure matching; ``args.coarsen_measure`` picks any of
    the ten measures, else the class's own."""

    proximity = "heavy_edge"
    uses_basis = False

    def _lanczos_pairs(self, W):
        """First-K smallest Laplacian eigenpairs (dense ``eigh`` on the
        host below the cutoff, ARPACK above)."""
        L = _laplacian(W)
        K = min(self.K, W.shape[0] - 1)
        if W.shape[0] <= _DENSE_EIG_CUTOFF:
            lk, Uk = np.linalg.eigh(L.toarray())
            return lk[:K], Uk[:, :K]
        return _eigsh_smallest(L, W, K, tol=1e-2)

    def _proximity(self, W) -> tuple[np.ndarray, np.ndarray]:
        Wu = sp.triu(W, 1).tocoo()
        edges = np.stack([Wu.row, Wu.col])
        w = Wu.data
        deg = np.asarray(W.sum(1)).ravel()
        name = self.args.coarsen_measure or self.proximity
        if name == "heavy_edge":
            wmax = np.asarray(W.max(0).todense()).ravel() + 1e-5
            prox = w / np.maximum(wmax[edges[0]], wmax[edges[1]])
        elif name == "heavy_edge_degree":
            prox = deg[edges[0]] + deg[edges[1]] + 2.0 * w
        elif name == "algebraic_JC":
            X = _jacobi_vectors(W, num_vectors=self.K, iterations=20,
                                seed=self.args.seed)
            diff2 = (X[edges[0]] - X[edges[1]]) ** 2   # [M, K]
            prox = (1.0 / np.maximum(diff2, 1e-6)).min(axis=1)
        elif name == "algebraic_GS":
            # the JC formula on Gauss-Seidel-smoothed test vectors
            X = _gauss_seidel_vectors(W, num_vectors=self.K,
                                      iterations=1, seed=self.args.seed)
            diff2 = (X[edges[0]] - X[edges[1]]) ** 2
            prox = (1.0 / np.maximum(diff2, 1e-6)).min(axis=1)
        elif name == "affinity_GS":
            X = _gauss_seidel_vectors(W, num_vectors=self.K, iterations=1,
                                      seed=self.args.seed)
            ii = np.einsum("md,md->m", X[edges[0]], X[edges[0]]) ** 2
            jj = np.einsum("md,md->m", X[edges[1]], X[edges[1]]) ** 2
            ij = np.einsum("md,md->m", X[edges[0]], X[edges[1]]) ** 2
            c = ij / np.maximum(ii * jj, 1e-12)
            cmax = np.zeros(W.shape[0])
            np.maximum.at(cmax, edges[0], c)
            np.maximum.at(cmax, edges[1], c)
            prox = c / np.maximum(cmax[edges[0]] * cmax[edges[1]], 1e-12)
        elif name in ("min_expected_loss", "min_expected_gradient_loss"):
            # Σ_k (x_k[i]-x_k[j])² (times the degree term for the gradient
            # variant), negated: proximal edges carry small loss
            _, X = self._lanczos_pairs(W)
            diff2 = (X[edges[0], 1:] - X[edges[1], 1:]) ** 2
            if name == "min_expected_gradient_loss":
                diff2 = diff2 * (deg[edges[0]] + deg[edges[1]]
                                 + 2.0 * w)[:, None]
            prox = -diff2.sum(axis=1)
        elif name in ("rss", "rss_lanczos"):
            # over the first-K Lanczos pairs, negated
            lk, X = self._lanczos_pairs(W)
            diff2 = (X[edges[0], 1:] - X[edges[1], 1:]) ** 2
            d_term = (deg[edges[0]] + deg[edges[1]] + 2.0 * w) / 4.0
            lk_safe = np.maximum(lk[1:], 1e-12)
            if name == "rss":
                terms = diff2 * d_term[:, None] / lk_safe[None, :]
            else:
                terms = diff2 * (d_term[:, None] - lk_safe[None, :]) \
                    / lk_safe[None, :]
            prox = -terms.sum(axis=1)
        elif name == "rss_cheby":
            # Chebyshev-filtered random vectors (low-pass at λ_{K+1}),
            # each scaled by its Rayleigh quotient
            X = _chebyshev_vectors(W, num_vectors=self.K,
                                   K=self.K, seed=self.args.seed)
            L = _laplacian(W)
            prox = np.zeros(edges.shape[1])
            d_term = (deg[edges[0]] + deg[edges[1]] + 2.0 * w) / 4.0
            for k in range(X.shape[1]):
                xk = X[:, k]
                lk = float(xk @ (L @ xk))
                diff2 = (xk[edges[0]] - xk[edges[1]]) ** 2
                prox += diff2 * d_term / max(lk, 1e-12)
            prox = -prox
        else:
            raise ValueError(name)
        return edges, prox

    def contract_sets(self, W, B, r_cur):
        edges, prox = self._proximity(W)
        if self.args.coarsen_strategy == "optimal":
            # minimize −proximity exactly
            return _optimal_matching(edges, -prox, W.shape[0], r_cur)
        return _greedy_matching(edges, prox, W.shape[0], r_cur)


class HeavyEdge(_ProximityCoarsen):
    proximity = "heavy_edge"


class AlgebraicJC(_ProximityCoarsen):
    proximity = "algebraic_JC"


class AffinityGS(_ProximityCoarsen):
    proximity = "affinity_GS"


def kron_reduction(L: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Schur complement of the Laplacian onto ``keep``:
    ``L_r = L[keep, keep] − L[keep, drop] L[drop, drop]⁻¹ L[drop, keep]``."""
    n = L.shape[0]
    drop = np.setdiff1d(np.arange(n), keep)
    if len(drop) == 0:
        return L[np.ix_(keep, keep)]
    L11 = L[np.ix_(keep, keep)]
    L12 = L[np.ix_(keep, drop)]
    L22 = L[np.ix_(drop, drop)]
    Lr = L11 - L12 @ np.linalg.solve(
        L22 + 1e-8 * np.eye(len(drop)), L12.T)
    return (Lr + Lr.T) / 2


def _kron_adjacency(Lr: np.ndarray) -> sp.csr_matrix:
    """W = diag(L_r) − L_r with numerical dust clipped (positive
    off-diagonals of L_r and entries below 1e-10 removed)."""
    W = np.diag(np.diag(Lr)) - Lr
    np.fill_diagonal(W, 0.0)
    W = np.maximum((W + W.T) / 2, 0.0)
    W[W < 1e-10] = 0.0
    return sp.csr_matrix(W)


class Kron(CoarsenBase):
    """Kron reduction: per level, keep the ``max(n/2, n_target)`` nodes
    with the largest entries of the largest-eigenvalue Laplacian
    eigenvector (polarity downsampling), Schur-complement the rest, and
    emit the Schur complement's off-diagonal as the coarse adjacency.
    Features and labels lift through a membership matrix where each
    dropped node joins its most-connected kept node.  The Laplacian is
    dense on the host, in float64."""

    def coarsen_component(self, W: sp.csr_matrix) -> sp.csr_matrix:
        r = float(np.clip(self.args.reduction_rate, 0, 0.999))
        N = W.shape[0]
        n_target = max(int(np.ceil(r * N)), 2)
        levels = max(int(np.ceil(np.log2(N / n_target))), 1)
        C = sp.eye(N, format="csr")
        W_cur = sp.csr_matrix(W, dtype=np.float64)
        for _ in range(levels):
            n = W_cur.shape[0]
            if n <= n_target:
                break
            L = _laplacian(W_cur).toarray()
            # largest-eigenvector polarity downsampling
            if n <= _DENSE_EIG_CUTOFF:
                _, U = np.linalg.eigh(L)
                V = U[:, -1]
            else:
                _, U = sp.linalg.eigsh(sp.csc_matrix(L), k=1, which="LA")
                V = U[:, 0]
            V = V * np.sign(V[0]) if V[0] != 0 else V
            n_keep = max(n // 2, n_target)
            keep = np.sort(np.argsort(-V)[:n_keep])
            drop = np.setdiff1d(np.arange(n), keep)
            Lr = kron_reduction(L, keep)
            # membership for the feature/label lift: dropped nodes join
            # their most-connected kept node in the pre-reduction graph
            iC = sp.lil_matrix((n_keep, n))
            for a, i in enumerate(keep):
                iC[a, i] = 1.0
            if len(drop):
                Wdk = W_cur[drop][:, keep].toarray()
                owner = np.argmax(Wdk + 1e-12, axis=1)
                for b, j in enumerate(drop):
                    iC[owner[b], j] = 1.0
            iC = sp.csr_matrix(iC)
            counts = np.asarray((iC > 0).sum(1)).ravel()
            iC = sp.diags(1.0 / np.sqrt(counts)) @ (iC > 0)
            C = sp.csr_matrix(iC) @ C
            W_cur = _kron_adjacency(Lr)
        self._kron_W = sp.csr_matrix(W_cur)
        return sp.csr_matrix(C)

    def component_adj(self, W: sp.csr_matrix,
                      C: sp.csr_matrix) -> sp.csr_matrix:
        # the Schur complement computed in coarsen_component is the
        # coarse graph, not a membership lift of W
        return _zero_diag(self._kron_W)
