"""Dataset loading: specs of the twins, splits, transforms.

Counterpart of ``graphslim_tpu/data/loader.py`` for the synthetic twins of
this slice (``ogbn-arxiv``, ``synth-hard``, ``cora``).  Generation is the
same host NumPy, seeded the same way, so both packages load equal arrays;
the result is moved to ``device`` once.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.data import synthetic
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
    feature_noise: float = 1.2
    center_scale: float = 1.3
    label_noise: float = 0.0
    feature_mix: float = 0.3
    target_acc: float = 0.0
    locality: float = 0.0
    locality_window: float = 0.005


_SPECS = [
    DatasetSpec("synth-hard", 900, 48, 5, 5.0, 0.78, "row_norm", "trans",
                "random", feature_noise=1.2, center_scale=0.35,
                label_noise=0.10, target_acc=0.8),
    DatasetSpec("cora", 2708, 1433, 7, 3.9, 0.81, "row_norm", "trans",
                "random", target_acc=0.81, center_scale=0.35,
                label_noise=0.10),
    DatasetSpec("ogbn-arxiv", 169343, 128, 40, 13.7, 0.65, "standardize",
                "trans", target_acc=0.71, label_noise=0.18,
                center_scale=0.45, feature_noise=1.3,
                feature_mix=0.1),
]

DATASET_SPECS = {s.name: s for s in _SPECS}


def normalize_name(name: str) -> str:
    key = name.lower().replace("-", "").replace("_", "")
    for canonical in DATASET_SPECS:
        if canonical.lower().replace("-", "").replace("_", "") == key:
            return canonical
    raise NotImplementedError(
        f"dataset {name!r} is not ported yet (ROADMAP.md, queue 1, item 1);"
        f" ported twins: {sorted(DATASET_SPECS)}")


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


def load(name: str, setting: Optional[str] = None,
         split: Optional[str] = None, seed: int = 0,
         data_dir: Optional[str] = None, pre_norm: bool = False,
         device=None) -> G.Dataset:
    """Synthesize a twin and build its views on ``device`` (the CUDA card
    unless the caller passes another)."""
    dev = resolve_device(device)
    if data_dir is not None:
        raise NotImplementedError(
            "reading dataset files is not ported yet (ROADMAP.md, queue 1,"
            " item 13: data/ingest.py)")
    name = normalize_name(name)
    spec = DATASET_SPECS[name]
    setting = setting or spec.default_setting
    if setting != "trans":
        raise NotImplementedError(
            "inductive datasets are not ported yet (ROADMAP.md, queue 1, "
            "item 1)")
    split = split or spec.split
    edge_index, feat_np, labels_np = _synth_cached(name, spec)
    nclass = spec.nclass

    n = feat_np.shape[0]
    rng = np.random.default_rng(seed)
    idx_train, idx_val, idx_test = _make_splits(labels_np, nclass, split,
                                                rng)
    adj, adj_host = G.from_edge_index(edge_index, n, symmetrize=True,
                                      device=dev, return_host=True)
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
    return G.Dataset(name=name, feat=feat, labels=labels, adj=adj,
                     idx_train=idx_train, idx_val=idx_val,
                     idx_test=idx_test, nclass=nclass, setting=setting,
                     adj_host=adj_host)
