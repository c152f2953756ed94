"""Mirage: frequent message-passing-tree mining condensation.

Counterpart of ``graphslim_tpu/reduce/mirage.py`` (the JAX package's
first-party, registered version of the reference's unregistered
``condensation/mirage.py``):

1. **Node labels**: the features are quantized to a vocabulary of
   ``min(mirage_labels, n)`` labels by k-means over all nodes, the only
   step on the device (:func:`graphslim_tpu_torch.kernels.kmeans.kmeans`).
2. **Canonical computation trees**: each node's L-hop tree is hashed
   bottom-up by WL-style interning, so identical trees get identical ids.
3. **Frequent-pattern mining**: per class, each train node contributes
   the set of depth-(L-1) subtree hashes its root aggregation consumes
   (itself and its neighbours); FP-growth mines them at a support of
   ``mirage_support`` × the class size.
4. **Reconstruction**: each frequent pattern becomes the disjoint union of
   one rooted tree per hash, realized from a training-node representative
   (BFS with a deterministic fanout cap), most frequent patterns first,
   until the class budget is filled; the rest is padded with the class's
   top-degree train nodes.  Every emitted node is labelled with the class
   being filled, so no val/test label leaks.

The mining is host NumPy and Python, a copy of the JAX package's, and the
result is a sparse symmetric adjacency of the tree edges.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.kmeans import kmeans, random_rows
from graphslim_tpu_torch.reduce.base import (Reducer, budgets_of,
                                             class_budgets)

# tree depth, BFS fanout cap, relative support, label vocabulary: the
# JAX package's fallbacks, which no configuration of it overrides
HOPS, FANOUT, SUPPORT, LABELS = 2, 5, 0.1, 32


# ---------------------------------------------------------------------------
# FP-growth (first-party; replaces pyfpgrowth)
# ---------------------------------------------------------------------------

class _FPNode:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item, parent):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children = {}


def _build_tree(transactions, freq, order):
    """transactions: list of (iterable, count). Returns header table."""
    root = _FPNode(None, None)
    header = defaultdict(list)
    for items, cnt in transactions:
        items = sorted((i for i in items if i in freq),
                       key=lambda i: order[i])
        node = root
        for i in items:
            child = node.children.get(i)
            if child is None:
                child = _FPNode(i, node)
                node.children[i] = child
                header[i].append(child)
            child.count += cnt
            node = child
    return header


def _mine(header, suffix, min_support, out, max_patterns, max_len):
    # least-frequent items first (standard FP-growth order)
    items = sorted(header, key=lambda i: sum(n.count for n in header[i]))
    for item in items:
        if len(out) >= max_patterns:
            return
        support = sum(n.count for n in header[item])
        pattern = suffix | {item}
        out[frozenset(pattern)] = support
        if len(pattern) >= max_len:
            continue
        # conditional pattern base: prefix paths of every `item` node
        base = []
        for node in header[item]:
            path = []
            p = node.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                base.append((path, node.count))
        counts = Counter()
        for path, cnt in base:
            for i in path:
                counts[i] += cnt
        cfreq = {i for i, c in counts.items() if c >= min_support}
        if not cfreq:
            continue
        corder = {i: k for k, i in enumerate(
            sorted(cfreq, key=lambda i: (-counts[i], i)))}
        cheader = _build_tree(base, cfreq, corder)
        _mine(cheader, pattern, min_support, out, max_patterns, max_len)


def fpgrowth(transactions, min_support: int, max_patterns: int = 20000,
             max_len: int = 4) -> dict:
    """Frequent itemsets over set-valued transactions.

    Returns ``{frozenset(items): support}`` for every itemset with
    support ≥ ``min_support`` (bounded by ``max_patterns`` results and
    ``max_len`` items per set).
    """
    counts = Counter()
    sets = [set(t) for t in transactions]
    for t in sets:
        counts.update(t)
    freq = {i for i, c in counts.items() if c >= min_support}
    if not freq:
        return {}
    order = {i: k for k, i in enumerate(
        sorted(freq, key=lambda i: (-counts[i], i)))}
    header = _build_tree([(t, 1) for t in sets], freq, order)
    out: dict = {}
    _mine(header, frozenset(), min_support, out, max_patterns, max_len)
    return out


# ---------------------------------------------------------------------------
# Canonical computation-tree hashing (replaces pygcanl)
# ---------------------------------------------------------------------------

def wl_tree_hashes(indptr: np.ndarray, col: np.ndarray,
                   node_label: np.ndarray, depth: int) -> list[np.ndarray]:
    """Interned canonical ids of every node's depth-k computation tree.

    Returns ``levels`` with ``levels[k][v]`` = integer id such that two
    nodes get the same id at level k iff their depth-k message-passing
    trees are isomorphic (given the discrete node labels).  Level 0 ids
    are the node labels themselves.
    """
    n = node_label.shape[0]
    levels = [node_label.astype(np.int64)]
    for _ in range(depth):
        prev = levels[-1]
        intern: dict = {}
        nxt = np.empty(n, dtype=np.int64)
        for v in range(n):
            kids = prev[col[indptr[v]:indptr[v + 1]]]
            kids.sort()
            key = (int(node_label[v]), kids.tobytes())
            hid = intern.get(key)
            if hid is None:
                hid = len(intern)
                intern[key] = hid
            nxt[v] = hid
        levels.append(nxt)
    return levels


def _bfs_tree(root: int, depth: int, indptr, col, levels, fanout: int):
    """Materialize the computation tree of ``root`` (depth levels, fanout
    cap), children picked deterministically by canonical child id.

    Returns (node_origin list, edge list of (parent, child) local ids).
    """
    origin = [root]
    edges = []
    frontier = [(0, root)]
    for d in range(depth, 0, -1):
        nxt = []
        for local, v in frontier:
            kids = col[indptr[v]:indptr[v + 1]]
            if kids.shape[0] > fanout:
                # deterministic: keep the fanout most canonical children
                sel = np.argsort(levels[d - 1][kids], kind="stable")[:fanout]
                kids = kids[sel]
            for u in kids:
                lu = len(origin)
                origin.append(int(u))
                edges.append((local, lu))
                nxt.append((lu, int(u)))
        frontier = nxt
    return origin, edges


# ---------------------------------------------------------------------------
# The reducer
# ---------------------------------------------------------------------------

class Mirage(Reducer):
    """Frequent-tree condensation (see the module docstring)."""

    def __init__(self, data, args, labels_syn_override=None):
        super().__init__(data, args)
        if labels_syn_override is not None:
            self.budgets = budgets_of(np.asarray(labels_syn_override))
        else:
            self.budgets, _, _ = class_budgets(
                data.labels_for_reduction(), args.reduction_rate)

    def node_labels(self, feat: torch.Tensor, k: int) -> np.ndarray:
        """The discrete label of every node: its cluster in a k-means
        over all nodes."""
        gen = utils.make_generator(self.args.seed, feat.device)
        _, assign = kmeans(feat, k, init=feat[random_rows(feat.shape[0], k,
                                                          gen)])
        return assign.cpu().numpy()

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        hops, fanout, support_frac, n_vocab = HOPS, FANOUT, SUPPORT, LABELS

        # --- graph view: the full graph, roots = the train nodes ---------
        host = data.adj_host if data.adj_host is not None \
            else G.host_of(data.adj)
        indptr, col = np.asarray(host.indptr), np.asarray(host.col)
        labels = data.labels.cpu().numpy()
        roots = np.asarray(data.idx_train)
        feat_np = data.feat.cpu().numpy()

        # --- 1. discrete node labels by k-means over the features ------
        k = min(n_vocab, feat_np.shape[0])
        node_label = self.node_labels(data.feat, k)
        # --- 2. canonical tree ids --------------------------------------
        levels = wl_tree_hashes(indptr, col, node_label, hops - 1)
        top = levels[hops - 1]

        # Representative node per top-level tree id — TRAIN nodes only.
        # In the transductive setting the full graph (structure + features)
        # is observed but val/test *labels* are not; realizing trees rooted
        # at non-train nodes risks emitting their ground-truth labels.
        # Restricting representatives to train roots (and labeling every
        # emitted node with the class budget being filled, below) keeps the
        # synthetic graph leak-free.  Hashes with no train representative
        # are skipped; the per-class budget padding covers the shortfall.
        rep: dict[int, int] = {}
        for v in roots:
            rep.setdefault(int(top[v]), int(v))

        # --- 3. per-node transactions + per-class mining ----------------
        deg = np.diff(indptr)
        x_parts, lab_parts, edge_parts = [], [], []
        n_out = 0
        for c, budget in sorted(self.budgets.items()):
            c_roots = roots[labels[roots] == c]
            if c_roots.shape[0] == 0:
                continue
            txns = [
                set(top[col[indptr[v]:indptr[v + 1]]].tolist())
                | {int(top[v])}
                for v in c_roots
            ]
            min_sup = max(2, int(support_frac * len(txns)))
            patterns = fpgrowth(txns, min_sup)
            # most frequent first, larger patterns break ties
            ranked = sorted(patterns.items(),
                            key=lambda kv: (-kv[1], -len(kv[0])))
            used: set[int] = set()
            room = budget
            for pattern, _sup in ranked:
                if room <= 0:
                    break
                for h in sorted(pattern):
                    if h in used or room <= 0:
                        continue
                    if h not in rep:   # no train-node representative
                        continue
                    used.add(h)
                    origin, edges = _bfs_tree(
                        rep[h], hops - 1, indptr, col, levels, fanout)
                    if len(origin) > room:
                        # truncate: BFS order ⇒ prefix is a valid tree
                        origin = origin[:room]
                        edges = [(a, b) for a, b in edges if b < room]
                    x_parts.append(feat_np[origin])
                    # every node of a class-c tree is supervised as class c
                    # (condensation label-budget semantics; never emits a
                    # non-train node's ground-truth label)
                    lab_parts.append(np.full(len(origin), c,
                                             dtype=np.int64))
                    edge_parts.extend(
                        (a + n_out, b + n_out) for a, b in edges)
                    n_out += len(origin)
                    room -= len(origin)
            if room > 0:
                # pad with top-degree class train nodes (singletons)
                pad = c_roots[np.argsort(-deg[c_roots],
                                         kind="stable")[:room]]
                x_parts.append(feat_np[pad])
                lab_parts.append(np.full(pad.shape[0], c, dtype=np.int64))
                n_out += pad.shape[0]

        x_syn = np.concatenate(x_parts, axis=0)
        lab_syn = np.concatenate(lab_parts, axis=0)
        if edge_parts:
            e = np.asarray(edge_parts, dtype=np.int64).T
            ei = np.concatenate([e, e[::-1]], axis=1)  # symmetrize
        else:
            ei = np.zeros((2, 0), dtype=np.int64)
        adj_syn = G.from_edge_index(ei, x_syn.shape[0], dedup=True,
                                    device=data.device)
        return G.Reduced(
            feat=torch.as_tensor(x_syn, device=data.device), adj=adj_syn,
            labels=torch.as_tensor(lab_syn, device=data.device))
