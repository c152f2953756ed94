"""Artifact store: persist and read reduced-graph triples.

Counterpart of ``graphslim_tpu/data/artifacts.py``.  The ``.npz`` layout is
the JAX package's, so artifacts written by either package read in both:
``{save_path}/reduced_graph/{method}/{dataset}_{r}_{seed}.npz``, or under
``{save_path}/corrupt_graph/{attack}/`` for a run on an attacked graph.
:func:`read_npz` also reads the plain ``feat``/``adj``/``labels`` layout of
``benchmark/artifacts/arxiv_gcond_r0.01.npz``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.utils import is_writer


def _triple_path(save_path: str, method: str, dataset: str, r: float,
                 seed: int, attack: Optional[str] = None) -> str:
    base = os.path.abspath(os.path.expanduser(save_path))
    if attack:
        base = os.path.join(base, "corrupt_graph", attack)
    return os.path.join(base, "reduced_graph", method,
                        f"{dataset}_{r}_{seed}.npz")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_reduced(reduced: G.Reduced, save_path: str, method: str,
                 dataset: str, r: float, seed: int,
                 attack: Optional[str] = None) -> str:
    path = _triple_path(save_path, method, dataset, r, seed, attack)
    if not is_writer():   # one writer: rank 0 of a distributed run
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # labels keep their own dtype: hard labels are integers, soft labels
    # (GCSNTK's, GEOM's) float [n_syn, nclass] rows
    payload = {"feat": _np(reduced.feat), "labels": _np(reduced.labels)}
    if reduced.adj is None:
        payload["adj_kind"] = np.array("identity")
    elif isinstance(reduced.adj, G.SparseAdj):
        payload["adj_kind"] = np.array("sparse")
        payload["adj_row"] = _np(reduced.adj.row)
        payload["adj_col"] = _np(reduced.adj.col)
        payload["adj_val"] = _np(reduced.adj.values_or_ones())
        payload["adj_n"] = np.array(reduced.adj.n_rows)
    else:
        payload["adj_kind"] = np.array("dense")
        payload["adj"] = _np(reduced.adj)
    np.savez_compressed(path, **payload)
    return path


def read_npz(path: str, device=None) -> G.Reduced:
    """A reduced triple from an ``.npz`` in either layout: the artifact
    store's (``adj_kind`` + ...) or plain ``feat``/``adj``/``labels``."""
    from graphslim_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        feat = torch.as_tensor(data["feat"].astype(np.float32), device=dev)
        labels = data["labels"]
        labels = torch.as_tensor(labels.astype(
            np.float32 if np.issubdtype(labels.dtype, np.floating)
            else np.int64), device=dev)
        kind = str(data["adj_kind"]) if "adj_kind" in data.files else (
            "dense" if "adj" in data.files else "identity")
        if kind == "identity":
            adj = None
        elif kind == "sparse":
            ei = np.stack([data["adj_row"], data["adj_col"]])
            adj = G.from_edge_index(ei, int(data["adj_n"]),
                                    edge_weight=data["adj_val"],
                                    dedup=False, device=dev)
        else:
            adj = torch.as_tensor(data["adj"].astype(np.float32),
                                  device=dev)
    return G.Reduced(feat=feat, adj=adj, labels=labels)


def load_reduced(save_path: str, method: str, dataset: str, r: float,
                 seed: int, device=None,
                 attack: Optional[str] = None) -> G.Reduced:
    """The triple that :func:`save_reduced` (of either package) wrote for
    this run, on the CUDA card unless ``device`` says otherwise."""
    path = _triple_path(save_path, method, dataset, r, seed, attack)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reduced graph at {path}")
    return read_npz(path, device=device)


def get_syn_data(save_path: str, method: str, dataset: str, r: float,
                 seed: int, model_type: str = "GCN", threshold: float = 0.0,
                 device=None, attack: Optional[str] = None) -> G.Reduced:
    """Load and sparsify for ``model_type`` (reference
    ``dataset/utils.py:261-296``)."""
    reduced = load_reduced(save_path, method, dataset, r, seed, device,
                           attack)
    return sparsify(reduced, model_type, method, threshold)


def sparsify(reduced: G.Reduced, model_type: str, method: str,
             threshold: float = 0.0) -> G.Reduced:
    """Model-aware post-sparsification of a condensed dense adjacency:
    MLP → identity; GAT → hard threshold 0.5 (0.1 for trajectory
    methods); otherwise entries below ``threshold`` are zeroed."""
    if model_type == "MLP":
        return G.Reduced(feat=reduced.feat, adj=None, labels=reduced.labels)
    adj = reduced.adj
    if adj is None or isinstance(adj, G.SparseAdj):
        return reduced
    if model_type == "GAT":
        t = 0.5 if method in ("gcond", "doscond", "gcdm", "sgdd",
                              "gcsntk", "msgc") else 0.1
    else:
        t = threshold
    if t > 0:
        adj = torch.where(adj < t, torch.zeros_like(adj), adj)
    return G.Reduced(feat=reduced.feat, adj=adj, labels=reduced.labels)
