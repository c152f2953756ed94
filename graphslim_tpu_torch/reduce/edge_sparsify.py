"""Edge sparsification: thin the edge set, keep all nodes.

Counterpart of ``graphslim_tpu/reduce/edge_sparsify.py``: RandomEdge,
GSpar (Jaccard), Scan, LocalDegree, SpanningForest, RankDegree and
TSpanner score or select the upper-triangle edges on the host (NumPy and
SciPy, draws from ``np.random.default_rng(args.seed)``), as the JAX
package does, and keep the same edges.  The graph is read from the host
mirror of the graph reducers consume (``Dataset.train_host``: the full
graph, or the train subgraph in the inductive setting); the t-spanner is
the exact greedy one of the native host library
(:mod:`graphslim_tpu_torch.native`).  The result keeps every node: the
features and labels of ``Dataset.train_graph`` with the kept edges,
symmetrized, on the dataset's device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import native
from graphslim_tpu_torch.reduce.base import Reducer


def _to_scipy(adj: G.HostAdj) -> sp.csr_matrix:
    n = adj.n_rows
    return sp.csr_matrix((adj.values_or_ones(), (adj.row, adj.col)),
                         shape=(n, n))


def _upper_edges(W: sp.csr_matrix):
    Wu = sp.triu(W, 1).tocoo()
    return np.stack([Wu.row, Wu.col]), Wu.data


def _common_neighbors(W: sp.csr_matrix, edges: np.ndarray,
                      chunk: int = 200_000) -> np.ndarray:
    """|N(u) ∩ N(v)| per edge via chunked sparse row gather+multiply."""
    Wb = (W > 0).astype(np.float32).tocsr()
    out = np.zeros(edges.shape[1], dtype=np.float32)
    for lo in range(0, edges.shape[1], chunk):
        hi = min(lo + chunk, edges.shape[1])
        a = Wb[edges[0, lo:hi]]
        b = Wb[edges[1, lo:hi]]
        out[lo:hi] = np.asarray(a.multiply(b).sum(axis=1)).ravel()
    return out


class EdgeSparsifier(Reducer):
    """Base: score edges, keep the top ``r`` fraction, rebuild the triple."""

    # subclass hook: higher score = keep
    def edge_scores(self, W: sp.csr_matrix, edges: np.ndarray,
                    weights: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def select_edges(self, W, edges, weights) -> np.ndarray:
        scores = self.edge_scores(W, edges, weights)
        m_keep = max(int(edges.shape[1] * self.args.reduction_rate), 1)
        return np.argsort(-scores, kind="stable")[:m_keep]

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        feat, _, labels = data.train_graph()
        W = _to_scipy(data.train_host())
        edges, weights = _upper_edges(W)
        keep = self.select_edges(W, edges, weights)
        adj_syn = G.from_edge_index(edges[:, keep], W.shape[0],
                                    edge_weight=weights[keep],
                                    symmetrize=True, device=data.device)
        return G.Reduced(feat=feat, adj=adj_syn, labels=labels)


class RandomEdge(EdgeSparsifier):
    """Uniform random edge keep."""

    def edge_scores(self, W, edges, weights):
        rng = np.random.default_rng(self.args.seed)
        return rng.random(edges.shape[1])


class GSpar(EdgeSparsifier):
    """Jaccard similarity of the endpoints' neighborhoods."""

    def edge_scores(self, W, edges, weights):
        common = _common_neighbors(W, edges)
        deg = np.asarray((W > 0).sum(1)).ravel()
        union = deg[edges[0]] + deg[edges[1]] - common
        return common / np.maximum(union, 1.0)


class Scan(EdgeSparsifier):
    """SCAN structural similarity over closed neighborhoods."""

    def edge_scores(self, W, edges, weights):
        common = _common_neighbors(W, edges)
        deg = np.asarray((W > 0).sum(1)).ravel()
        # closed neighborhoods: +2 shared (u,v themselves), sizes +1
        return (common + 2.0) / np.sqrt(
            (deg[edges[0]] + 1.0) * (deg[edges[1]] + 1.0))


class LocalDegree(EdgeSparsifier):
    """Keep edges ranked high in the *neighbor's* degree order."""

    def edge_scores(self, W, edges, weights):
        deg = np.asarray((W > 0).sum(1)).ravel()
        n = W.shape[0]
        Wb = (W > 0).tocsr()
        indptr, indices = Wb.indptr, Wb.indices
        # rank of each directed edge target within its source's neighbor
        # list sorted by degree descending
        rank_score = np.zeros_like(indices, dtype=np.float32)
        for u in range(n):
            lo, hi = indptr[u], indptr[u + 1]
            if hi == lo:
                continue
            nbrs = indices[lo:hi]
            order = np.argsort(-deg[nbrs], kind="stable")
            d = hi - lo
            r = np.empty(d)
            r[order] = 1.0 - np.log(np.arange(1, d + 1)) / max(
                np.log(d + 1), 1e-9)
            rank_score[lo:hi] = r
        S = sp.csr_matrix((rank_score, indices, indptr), shape=(n, n))
        s1 = np.asarray(S[edges[0], edges[1]]).ravel()
        s2 = np.asarray(S[edges[1], edges[0]]).ravel()
        return np.maximum(s1, s2)


class SpanningForest(EdgeSparsifier):
    """Keep only a minimum spanning forest; ignores the reduction rate."""

    def select_edges(self, W, edges, weights):
        mst = sp.coo_matrix(csgraph.minimum_spanning_tree(W))
        tree = set(zip(np.minimum(mst.row, mst.col),
                       np.maximum(mst.row, mst.col)))
        keep = [e for e in range(edges.shape[1])
                if (min(edges[0, e], edges[1, e]),
                    max(edges[0, e], edges[1, e])) in tree]
        return np.asarray(keep, dtype=np.int64)


class RankDegree(EdgeSparsifier):
    """Iterative seed/neighbor-rank growth with adaptive rho."""

    def select_edges(self, W, edges, weights):
        rng = np.random.default_rng(self.args.seed)
        n = W.shape[0]
        target = max(int(edges.shape[1] * self.args.reduction_rate), 1)
        deg = np.asarray((W > 0).sum(1)).ravel()
        Wb = (W > 0).tocsr()
        rho = 0.1
        kept = set()
        seeds = list(rng.choice(n, size=min(max(n // 100, 3), n),
                                replace=False))
        it = 0
        while len(kept) < target and it < 100:
            it += 1
            new_seeds = []
            for s in seeds:
                nbrs = Wb[s].indices
                if len(nbrs) == 0:
                    continue
                k = max(int(np.ceil(rho * len(nbrs))), 1)
                top = nbrs[np.argsort(-deg[nbrs], kind="stable")[:k]]
                for v in top:
                    e = (min(s, v), max(s, v))
                    if e not in kept:
                        kept.add(e)
                        new_seeds.append(v)
                    if len(kept) >= target:
                        break
                if len(kept) >= target:
                    break
            seeds = new_seeds or list(rng.choice(n, size=3, replace=False))
            rho = min(rho * 1.5, 1.0)
        lookup = {(min(edges[0, e], edges[1, e]),
                   max(edges[0, e], edges[1, e])): e
                  for e in range(edges.shape[1])}
        return np.asarray([lookup[e] for e in kept if e in lookup],
                          dtype=np.int64)


class TSpanner(EdgeSparsifier):
    """Greedy t-spanner: edges lightest first, an edge kept iff the kept
    edges give no path within ``t·w`` (``args.ts``), in the native host
    library."""

    def select_edges(self, W, edges, weights):
        return native.t_spanner(edges[0], edges[1], weights, W.shape[0],
                                float(self.args.ts))
