"""Deterministic synthetic graph generation.

Zero-egress stand-ins for the reference's downloaded datasets
(reference ``graphslim/dataset/loader.py:39-97``).  Each generator is a
seeded degree-corrected stochastic block model with class-informative
features, so GNN training, reduction and evaluation behave like on the real
data (homophilous structure, learnable features, power-law degrees).

Generation is host-side NumPy — it runs once at load time.  This is the
port's own copy of ``graphslim_tpu/data/synthetic.py``, kept byte-for-byte
equal in its arithmetic so both packages build the same twins.
"""

from __future__ import annotations

import numpy as np


def generate(n_nodes: int, n_feat: int, nclass: int, avg_degree: float,
             homophily: float, seed: int, feature_noise: float = 1.0,
             degree_power: float = 0.9,
             class_skew: float = 0.3,
             center_scale: float = 2.0,
             label_noise: float = 0.0,
             feature_mix: float = 0.3,
             locality: float = 0.0,
             locality_window: float = 0.02) -> tuple[np.ndarray,
                                                     np.ndarray,
                                                     np.ndarray]:
    """Return ``(edge_index [2,E], feat [n,d] float32, labels [n] int32)``.

    * labels: Zipf-skewed class sizes (``class_skew`` controls imbalance,
      mirroring e.g. ogbn-arxiv's skewed class histogram).
    * degrees: lognormal (power-law-ish tail) scaled to ``avg_degree``.
    * edges: each endpoint slot connects within-class with probability
      ``homophily``, uniformly otherwise (degree-corrected sampling).
    * features: per-class centers in a latent space projected through a
      random matrix + one hop of structural mixing so features and
      structure are correlated like in citation graphs.

    Hardness knobs (round-2 calibration; VERDICT.md "accuracy evidence is
    saturated").  ``center_scale`` shrinks class separation in feature
    space, ``feature_noise`` raises within-class spread, and
    ``label_noise`` flips that fraction of *observed* labels uniformly to
    another class AFTER structure/features are generated — the graph still
    follows the true labels, but supervision and evaluation see the noisy
    ones, capping attainable accuracy like real datasets' inherent label
    ambiguity does (cora tops out ~0.81, arxiv ~0.71).
    """
    rng = np.random.default_rng(seed)

    # --- labels ---------------------------------------------------------
    weights = (1.0 / np.arange(1, nclass + 1) ** class_skew)
    weights /= weights.sum()
    labels = rng.choice(nclass, size=n_nodes, p=weights).astype(np.int32)

    # --- degrees --------------------------------------------------------
    raw = rng.lognormal(mean=0.0, sigma=degree_power, size=n_nodes)
    deg = np.maximum((raw / raw.mean() * avg_degree).astype(np.int64), 1)

    # --- per-class node pools ------------------------------------------
    class_nodes = [np.flatnonzero(labels == c) for c in range(nclass)]
    # degree-proportional sampling within a class
    class_probs = []
    for c in range(nclass):
        nodes = class_nodes[c]
        p = deg[nodes].astype(np.float64)
        class_probs.append(p / p.sum() if p.sum() > 0 else None)
    all_probs = deg.astype(np.float64) / deg.sum()

    # --- edges ----------------------------------------------------------
    src = np.repeat(np.arange(n_nodes), deg)
    same = rng.random(src.shape[0]) < homophily
    # ``locality``: that fraction of within-class edges attach to ring-
    # nearby nodes of the same class (two-sided geometric rank offsets,
    # window = locality_window · class size) instead of uniformly over
    # the class.  Real citation/social graphs have nested community
    # structure far below class granularity (METIS cuts a few % of
    # edges); pure SBM blocks are expanders and unpartitionable, which
    # made every distributed-halo measurement on the twins pessimistic
    # (round-3 partitioner work).  Homophily is unaffected — local edges
    # are still within-class.
    local = (rng.random(src.shape[0]) < locality) \
        if locality > 0.0 else np.zeros(src.shape[0], dtype=bool)
    rank_in_class = np.empty(n_nodes, dtype=np.int64)
    for c in range(nclass):
        rank_in_class[class_nodes[c]] = np.arange(class_nodes[c].size)
    dst = np.empty_like(src)
    # within-class endpoints, drawn per class in bulk
    for c in range(nclass):
        sel = same & ~local & (labels[src] == c)
        cnt = int(sel.sum())
        if cnt and class_nodes[c].size:
            dst[sel] = rng.choice(class_nodes[c], size=cnt,
                                  p=class_probs[c])
        elif cnt:
            dst[sel] = rng.choice(n_nodes, size=cnt, p=all_probs)
        sel_l = local & (labels[src] == c)
        cnt_l = int(sel_l.sum())
        if cnt_l and class_nodes[c].size > 1:
            size_c = class_nodes[c].size
            w = max(locality_window * size_c, 1.0)
            off = np.round(rng.laplace(0.0, w, size=cnt_l)).astype(
                np.int64)
            off[off == 0] = 1
            r = (rank_in_class[src[sel_l]] + off) % size_c
            dst[sel_l] = class_nodes[c][r]
        elif cnt_l:
            dst[sel_l] = rng.choice(n_nodes, size=cnt_l, p=all_probs)
    # cross-class endpoints: ring-local for the ``local`` fraction (real
    # graphs' cross-class edges live inside the same communities — they
    # are not global noise), uniform degree-proportional otherwise
    sel_x = ~same & local
    cnt_x = int(sel_x.sum())
    if cnt_x:
        w = max(locality_window * n_nodes, 1.0)
        off = np.round(rng.laplace(0.0, w, size=cnt_x)).astype(np.int64)
        off[off == 0] = 1
        dst[sel_x] = (src[sel_x] + off) % n_nodes
    sel_u = ~same & ~local
    n_rand = int(sel_u.sum())
    if n_rand:
        dst[sel_u] = rng.choice(n_nodes, size=n_rand, p=all_probs)
    keep = src != dst
    edge_index = np.stack([src[keep], dst[keep]])

    # --- features -------------------------------------------------------
    latent_dim = min(max(nclass * 4, 16), n_feat)
    centers = rng.normal(size=(nclass, latent_dim)) * center_scale
    z = centers[labels] + rng.normal(size=(n_nodes, latent_dim)) * \
        feature_noise
    proj = rng.normal(size=(latent_dim, n_feat)) / np.sqrt(latent_dim)
    feat = (z @ proj).astype(np.float32)
    # one hop of structural smoothing via scipy SpMM (np.add.at over
    # E×d element rows is unbuffered and ~100× slower at reddit scale)
    import scipy.sparse as sp

    E = edge_index.shape[1]
    A = sp.csr_matrix(
        (np.ones(E, dtype=np.float32),
         (edge_index[0], edge_index[1])), shape=(n_nodes, n_nodes))
    deg_out = np.maximum(np.asarray(A.sum(1)).ravel(), 1.0)
    mix = (A @ feat) / deg_out[:, None].astype(np.float32)
    # feature_mix controls how much graph smoothing is baked INTO the
    # raw features: high values hand an MLP the aggregated signal for
    # free (GCN ≈ MLP); low values keep the structural signal reachable
    # only through eval-time propagation (GCN >> MLP, like real arxiv)
    feat = (1.0 - feature_mix) * feat + \
        feature_mix * mix.astype(np.float32)

    # --- observed-label noise (after structure/features) -----------------
    if label_noise > 0.0:
        flip = rng.random(n_nodes) < label_noise
        shift = rng.integers(1, nclass, size=n_nodes).astype(np.int32)
        labels = np.where(flip, (labels + shift) % nclass, labels)
        labels = labels.astype(np.int32)
    return edge_index, feat, labels
