"""Dataset loading: specs of the twins, splits, transforms, inductive views.

Counterpart of ``graphslim_tpu/data/loader.py``: the same 21 dataset
profiles, the same host-NumPy synthesis seeded the same way, and the same
readers of dataset files (:mod:`graphslim_tpu_torch.data.ingest`), so both
packages load equal arrays.  Karate is Zachary's graph, kept here as a
constant (no ``networkx``).  In the inductive setting the train, val and
test subgraphs are induced on the host from the host mirror; every array
is moved to ``device`` once.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.data import ingest, synthetic
from graphslim_tpu_torch.profiling import span
from graphslim_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static profile of a twin (drives synthesis and policy)."""

    name: str
    n_nodes: int
    n_feat: int
    nclass: int
    avg_degree: float
    homophily: float
    transform: str        # 'row_norm' | 'standardize' | 'none'
    default_setting: str
    split: str = "fixed"
    metric: str = "accuracy"
    synth_ok: bool = True  # False: real files only (too large to synthesize)
    feature_noise: float = 1.2
    center_scale: float = 1.3
    label_noise: float = 0.0
    feature_mix: float = 0.3
    target_acc: float = 0.0
    locality: float = 0.0
    locality_window: float = 0.005


_SPECS = [
    # Zachary's karate club (34 nodes, 2 factions, a real graph kept as
    # _KARATE_EDGES below); identity features.
    DatasetSpec("karate", 34, 34, 2, 4.6, 0.72, "none", "trans",
                "few", synth_ok=False),
    # Test fixtures: easy (high separation), not calibrated.
    DatasetSpec("synth-small", 600, 32, 4, 6.0, 0.8, "row_norm", "trans",
                "random", feature_noise=1.0, center_scale=2.0),
    DatasetSpec("synth-ind-small", 800, 48, 5, 6.0, 0.75, "standardize",
                "ind", "random", feature_noise=1.0, center_scale=2.0),
    # Cora-like hardness at fixture scale.
    DatasetSpec("synth-hard", 900, 48, 5, 5.0, 0.78, "row_norm", "trans",
                "random", feature_noise=1.2, center_scale=0.35,
                label_noise=0.10, target_acc=0.8),
    # Planetoid twins: 'random' split = 20 train / 30 val per class.
    DatasetSpec("cora", 2708, 1433, 7, 3.9, 0.81, "row_norm", "trans",
                "random", target_acc=0.81, center_scale=0.35,
                label_noise=0.10),
    DatasetSpec("citeseer", 3327, 3703, 6, 2.7, 0.74, "row_norm", "trans",
                "random", target_acc=0.72, center_scale=0.33,
                label_noise=0.13),
    DatasetSpec("pubmed", 19717, 500, 3, 4.5, 0.80, "row_norm", "trans",
                "random", target_acc=0.79, center_scale=0.35,
                label_noise=0.17, locality=0.97),
    DatasetSpec("photo", 7650, 745, 8, 31.1, 0.83, "row_norm", "trans",
                "random", target_acc=0.91, center_scale=0.5,
                label_noise=0.05),
    DatasetSpec("computers", 13752, 767, 10, 35.8, 0.78, "row_norm",
                "trans", "random", target_acc=0.86, center_scale=0.45,
                label_noise=0.08),
    DatasetSpec("cs", 18333, 6805, 15, 8.9, 0.81, "row_norm", "trans",
                "random", target_acc=0.92, center_scale=0.55,
                label_noise=0.04),
    DatasetSpec("physics", 34493, 8415, 5, 14.4, 0.93, "row_norm", "trans",
                "random", target_acc=0.95, center_scale=0.6,
                label_noise=0.03),
    DatasetSpec("dblp", 17716, 1639, 4, 6.0, 0.83, "row_norm", "trans",
                "random", target_acc=0.80, center_scale=0.4,
                label_noise=0.12),
    DatasetSpec("ogbn-arxiv", 169343, 128, 40, 13.7, 0.65, "standardize",
                "trans", target_acc=0.71, label_noise=0.18,
                center_scale=0.45, feature_noise=1.3,
                feature_mix=0.1),
    DatasetSpec("flickr", 89250, 500, 7, 10.0, 0.32, "standardize", "ind",
                target_acc=0.47, label_noise=0.28, center_scale=0.45,
                feature_noise=1.5),
    DatasetSpec("reddit", 232965, 602, 41, 99.6, 0.76, "standardize",
                "ind", target_acc=0.94, label_noise=0.04,
                center_scale=1.5, feature_noise=1.0),
    DatasetSpec("yelp", 45954, 32, 2, 167.0, 0.77, "standardize", "ind",
                metric="f1_macro", label_noise=0.25, center_scale=0.6),
    DatasetSpec("amazon", 11944, 25, 2, 700.0, 0.65, "standardize", "ind",
                metric="f1_macro", label_noise=0.2, center_scale=0.6),
    DatasetSpec("cora_ml", 2995, 2879, 7, 5.5, 0.79, "row_norm", "trans",
                "random", target_acc=0.85, center_scale=0.4,
                label_noise=0.08),
    # ogbn-products: about 126 M directed edge slots, minutes of host
    # NumPy (disk-cached).
    DatasetSpec("ogbn-products", 2_449_029, 100, 47, 51.5, 0.81,
                "standardize", "trans", target_acc=0.76,
                label_noise=0.15, center_scale=0.5, feature_noise=1.2,
                locality=0.5, locality_window=0.02),
    # Too large to synthesize: real files only (``load(data_dir=...)``).
    DatasetSpec("ogbn-proteins", 132_534, 8, 2, 597.0, 0.6,
                "standardize", "trans", synth_ok=False),
    DatasetSpec("ogbn-papers100m", 111_059_956, 128, 172, 29.1, 0.7,
                "standardize", "trans", synth_ok=False),
]

DATASET_SPECS = {s.name: s for s in _SPECS}

# Zachary's karate club: its 78 undirected edges in networkx's
# ``karate_club_graph().edges()`` order, and the nodes of the "Officer"
# faction (label 1; the others follow "Mr. Hi", label 0).
_KARATE_EDGES = np.array([
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
    (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
    (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21),
    (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
    (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
    (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
    (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33),
    (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29),
    (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
    (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32),
    (30, 33), (31, 32), (31, 33), (32, 33)], dtype=np.int64).T
_KARATE_OFFICER = (9, 14, 15, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                   31, 32, 33)


def normalize_name(name: str) -> str:
    """Canonical twin name; case, ``-`` and ``_`` are ignored."""
    key = name.lower().replace("-", "").replace("_", "")
    for canonical in DATASET_SPECS:
        if canonical.lower().replace("-", "").replace("_", "") == key:
            return canonical
    raise ValueError(f"Dataset name not recognized: {name!r}")


def _make_splits(labels: np.ndarray, nclass: int, split: str,
                 rng: np.random.Generator):
    """Class-wise splits: ``random`` 20/30/rest, ``few`` 5/5/rest,
    ``fixed`` 80 % / 10 % / 10 % per class."""
    train, val, test = [], [], []
    for c in range(nclass):
        idx = np.flatnonzero(labels == c)
        idx = rng.permutation(idx)
        if split == "random":
            a, b = 20, 50
        elif split == "few":
            a, b = 5, 10
        else:
            a = int(idx.shape[0] * 0.8)
            b = int(idx.shape[0] * 0.9)
        train.append(idx[:a])
        val.append(idx[a:b])
        test.append(idx[b:])
    return (np.sort(np.concatenate(train)), np.sort(np.concatenate(val)),
            np.sort(np.concatenate(test)))


def cache_dir() -> str:
    """Disk cache of the large twins: ``$GRAPHSLIM_TORCH_CACHE`` or
    ``~/.cache/graphslim_tpu_torch/synth``."""
    return os.environ.get("GRAPHSLIM_TORCH_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "graphslim_tpu_torch", "synth")


def _synth_cached(name: str, spec: DatasetSpec):
    """Generate (or read from the disk cache) the deterministic twin,
    seeded with ``zlib.crc32`` of its name as the JAX package does."""
    seed = zlib.crc32(name.encode()) % (2 ** 31)
    knobs = (f"fn{spec.feature_noise:g}_cs{spec.center_scale:g}"
             f"_ln{spec.label_noise:g}_mx{spec.feature_mix:g}"
             + (f"_lc{spec.locality:g}w{spec.locality_window:g}"
                if spec.locality else ""))
    path = os.path.join(cache_dir(), f"{name}_{knobs}.npz")
    large = spec.n_nodes >= 50_000
    if large and os.path.exists(path):
        blob = np.load(path)
        return blob["edge_index"], blob["feat"], blob["labels"]
    out = synthetic.generate(spec.n_nodes, spec.n_feat, spec.nclass,
                             spec.avg_degree, spec.homophily, seed=seed,
                             feature_noise=spec.feature_noise,
                             center_scale=spec.center_scale,
                             label_noise=spec.label_noise,
                             feature_mix=spec.feature_mix,
                             locality=spec.locality,
                             locality_window=spec.locality_window)
    if large:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, edge_index=out[0], feat=out[1], labels=out[2])
        os.replace(tmp, path)
    return out


def _load_karate():
    """Zachary's karate club: (edge_index, identity features, factions)."""
    n = 34
    labels = np.zeros(n, dtype=np.int32)
    labels[list(_KARATE_OFFICER)] = 1
    return _KARATE_EDGES.copy(), np.eye(n, dtype=np.float32), labels


def load(name: str, setting: Optional[str] = None,
         split: Optional[str] = None, seed: int = 0,
         data_dir: Optional[str] = None, pre_norm: bool = False,
         device=None) -> G.Dataset:
    """Load a dataset and build its views on ``device`` (the CUDA card
    unless the caller passes another).  Files under ``data_dir`` in any
    format :func:`ingest.try_load` reads take precedence (``nclass`` from
    their labels, their own split where they ship one); otherwise the
    deterministic twin is synthesized.  With ``setting='ind'`` the dataset
    also carries the induced train, val and test subgraphs."""
    dev = resolve_device(device)
    name = normalize_name(name)
    spec = DATASET_SPECS[name]
    setting = setting or spec.default_setting
    split = split or spec.split
    with span("data.load", dataset=name):
        with span("data.read"):
            loaded = ingest.try_load(name, data_dir) if data_dir else None
            role = None
            if loaded is not None:
                edge_index, feat_np, labels_np, role = loaded
                nclass = int(labels_np.max()) + 1
            elif name == "karate":
                edge_index, feat_np, labels_np = _load_karate()
                nclass = spec.nclass
            elif not spec.synth_ok:
                raise FileNotFoundError(
                    f"{name} is ingestion-only (too large to synthesize); "
                    f"provide --load_path with {name}/adj_full.npz or "
                    f"{name}.npz")
            else:
                edge_index, feat_np, labels_np = _synth_cached(name, spec)
                nclass = spec.nclass

        n = feat_np.shape[0]
        rng = np.random.default_rng(seed)
        if role is not None:  # the split shipped with the files
            idx_train, idx_val, idx_test = (np.sort(np.asarray(role[k]))
                                            for k in ("tr", "va", "te"))
        else:
            idx_train, idx_val, idx_test = _make_splits(labels_np, nclass,
                                                        split, rng)
        splits = (("train", idx_train), ("val", idx_val),
                  ("test", idx_test))
        with span("data.graph"):
            adj_host = G.host_from_edge_index(edge_index, n,
                                              symmetrize=True)
            # induced subgraphs from the host mirror (no read-back)
            subs = ([G.host_submatrix(adj_host, idx) for _, idx in splits]
                    if setting == "ind" else [])
        with span("data.views"):
            adj = adj_host.to_sparse(dev)
            feat_np = np.asarray(feat_np, dtype=np.float32)
            if pre_norm or spec.transform != "none":
                if spec.transform == "standardize":
                    mu = feat_np[idx_train].mean(0)
                    sd = feat_np[idx_train].std(0)
                    feat_np = (feat_np - mu) / np.maximum(sd, 1e-12)
                elif spec.transform == "row_norm":
                    norms = np.linalg.norm(feat_np, axis=1, keepdims=True)
                    feat_np = feat_np / np.maximum(norms, 1e-12)
            feat = torch.as_tensor(feat_np, device=dev)
            labels = torch.as_tensor(labels_np.astype(np.int64), device=dev)
            ds = G.Dataset(name=name, feat=feat, labels=labels, adj=adj,
                           idx_train=idx_train, idx_val=idx_val,
                           idx_test=idx_test, nclass=nclass,
                           setting=setting, adj_host=adj_host)
            # each induced subgraph and its host features moved to the
            # device once
            for (split_name, idx), sub in zip(splits, subs):
                ds.set_view(split_name, torch.as_tensor(feat_np[idx],
                                                        device=dev),
                            torch.as_tensor(labels_np[idx].astype(np.int64),
                                            device=dev), sub)
    return ds
