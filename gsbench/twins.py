"""The dataset twins the benchmark runs on, frozen.

A copy of the port's seeded twin generator
(``graphslim_tpu_torch/data/synthetic.py::generate``, itself equal in its
arithmetic to the JAX package's), kept here so that a change to the
port's generator does not change the benchmark's inputs, and a split at
the dataset's published sizes (the port's own ``fixed`` split takes 80 %
of each class for training, which would set another number of synthetic
nodes than the published dataset gives).  :func:`twin_file` writes a twin once per checkout to
``gsbench/cache/<config hash>/<dataset>.npz`` in the layout the port's
generic file reader takes (``edge_index``, ``feat``, ``labels`` and the
split as ``idx_train/idx_val/idx_test``), and every later run reads it.
The raw features are stored; the port standardizes them as it loads, and
the reference does so again on its own.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cache")


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


def make_splits(n_nodes: int, sizes: dict, seed: int):
    """The published split's sizes (``sizes``: ``train``, ``val``,
    ``test``, summing to ``n_nodes``) drawn as one seeded permutation of
    the nodes: the first ``train`` are the train nodes, the next ``val``
    the validation nodes, the rest the test nodes."""
    if sizes["train"] + sizes["val"] + sizes["test"] != n_nodes:
        raise ValueError(f"split sizes {sizes} do not cover {n_nodes} "
                         "nodes")
    perm = np.random.default_rng(seed).permutation(n_nodes)
    a, b = sizes["train"], sizes["train"] + sizes["val"]
    return np.sort(perm[:a]), np.sort(perm[a:b]), np.sort(perm[b:])


def synthesize(twin: dict) -> dict:
    """The twin's arrays from its parameters (a configuration's ``twin``
    group), seeded with ``zlib.crc32`` of its name as the port seeds it."""
    seed = zlib.crc32(twin["name"].encode()) % (2 ** 31)
    edge_index, feat, labels = generate(
        twin["n_nodes"], twin["n_feat"], twin["nclass"],
        twin["avg_degree"], twin["homophily"], seed=seed,
        feature_noise=twin["feature_noise"],
        center_scale=twin["center_scale"], label_noise=twin["label_noise"],
        feature_mix=twin["feature_mix"], locality=twin["locality"],
        locality_window=twin["locality_window"])
    tr, va, te = make_splits(twin["n_nodes"], twin["split"],
                             twin["split_seed"])
    return dict(edge_index=edge_index, feat=feat, labels=labels,
                idx_train=tr, idx_val=va, idx_test=te)


def twin_dir(twin: dict, root: str = CACHE) -> str:
    """The twin's fixed directory: named by a hash of its parameters, so
    another twin never reads a stale file."""
    key = hashlib.sha256(json.dumps(twin, sort_keys=True).encode())
    return os.path.join(root, f"{twin['name']}_{key.hexdigest()[:12]}")


def twin_file(twin: dict, root: str = CACHE) -> tuple:
    """(directory the port's ``load(data_dir=...)`` reads, seconds spent
    synthesizing: 0 when the file was there)."""
    import time

    d = twin_dir(twin, root)
    path = os.path.join(d, f"{twin['name']}.npz")
    if os.path.exists(path):
        return d, 0.0
    t0 = time.perf_counter()
    arrays = synthesize(twin)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.getpid()}.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return d, time.perf_counter() - t0


def read_twin(twin: dict, root: str = CACHE) -> dict:
    """The twin's raw arrays as stored."""
    path = os.path.join(twin_dir(twin, root), f"{twin['name']}.npz")
    with np.load(path, allow_pickle=False) as blob:
        return {k: blob[k] for k in blob.files}
