"""Interop boundary: to and from plain torch / PyG / DGL representations.

Counterpart of ``graphslim_tpu/compat.py`` (reference
``graphslim/compat.py:20-81``): converters so that downstream PyTorch
pipelines consume reduced graphs, and readers and writers of the
reference's ``.pt`` artifact layout.  PyG and DGL are optional; the port
never depends on them.  Graphs leave as CPU tensors built from the host
mirrors (nothing is read back from the card but features, labels and a
dense adjacency); graphs come in on ``device``, the CUDA card unless the
caller asks for another.  Labels keep the port's int64.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.utils import host_array, resolve_device


def to_torch(reduced_or_data: Any) -> dict:
    """{'x', 'edge_index', 'edge_weight', 'y'} as CPU tensors."""
    if isinstance(reduced_or_data, G.Reduced):
        feat = host_array(reduced_or_data.feat)
        labels = host_array(reduced_or_data.labels)
        adj = reduced_or_data.adj
        if adj is None:
            n = feat.shape[0]
            ei = np.stack([np.arange(n), np.arange(n)])
            ew = np.ones(n, dtype=np.float32)
        elif isinstance(adj, G.SparseAdj):
            h = G.host_of(adj)
            ei = np.stack([h.row, h.col])
            ew = h.values_or_ones()
        else:
            a = host_array(adj)
            r, c = np.nonzero(a)
            ei, ew = np.stack([r, c]), a[r, c]
    else:  # Dataset
        d = reduced_or_data
        feat = host_array(d.feat)
        labels = host_array(d.labels)
        ei = G.to_edge_index(d.adj)
        ew = G.host_of(d.adj).values_or_ones()
    return {
        "x": torch.from_numpy(np.array(feat, copy=True)),
        "edge_index": torch.from_numpy(np.array(ei, copy=True)).long(),
        "edge_weight": torch.from_numpy(np.array(ew, copy=True)).float(),
        "y": torch.from_numpy(np.array(labels, copy=True)),
    }


def to_pyg_data(obj: Any):
    """``torch_geometric.data.Data`` when PyG is importable (reference
    ``compat.py:20-48``)."""
    blob = to_torch(obj)
    try:
        from torch_geometric.data import Data
    except ImportError as e:
        raise ImportError("torch_geometric not installed") from e
    return Data(x=blob["x"], edge_index=blob["edge_index"],
                edge_weight=blob["edge_weight"], y=blob["y"])


def to_dgl_graph(obj: Any):
    """``dgl.graph`` when DGL is importable (reference
    ``compat.py:50-81``)."""
    blob = to_torch(obj)
    try:
        import dgl
    except ImportError as e:
        raise ImportError("dgl not installed") from e
    g = dgl.graph((blob["edge_index"][0], blob["edge_index"][1]),
                  num_nodes=blob["x"].shape[0])
    g.ndata["feat"] = blob["x"]
    g.ndata["label"] = blob["y"]
    g.edata["weight"] = blob["edge_weight"]
    return g


def from_dgl(g, hetero: bool = False, device=None) -> tuple:
    """(feat, SparseAdj, labels) from a DGL graph (duck-typed: ``edges``,
    ``ndata``, and ``etypes`` / ``canonical_etypes`` for a heterograph,
    whose edge types are merged; reference ``dataset/convertor.py:15-58``,
    FraudDataset path), symmetrized, on ``device``."""
    dev = resolve_device(device)
    if hetero or (hasattr(g, "etypes") and len(g.etypes) > 1):
        srcs, dsts = [], []
        for et in g.canonical_etypes:
            s, d = g.edges(etype=et)
            srcs.append(host_array(s))
            dsts.append(host_array(d))
        ei = np.stack([np.concatenate(srcs), np.concatenate(dsts)])
    else:
        s, d = g.edges()
        ei = np.stack([host_array(s), host_array(d)])
    feat = host_array(g.ndata["feature" if "feature" in g.ndata
                               else "feat"])
    labels = host_array(g.ndata["label"])
    adj = G.from_edge_index(ei, feat.shape[0], symmetrize=True, device=dev)
    return (torch.as_tensor(feat, dtype=torch.float32, device=dev), adj,
            torch.as_tensor(labels.astype(np.int64), device=dev))


def from_torch(x, edge_index, y, edge_weight=None, name: str = "external",
               device=None) -> tuple:
    """(feat, SparseAdj, labels) from torch tensors, duplicate edges
    summed, on ``device``."""
    dev = resolve_device(device)
    ew = None if edge_weight is None else host_array(edge_weight)
    adj = G.from_edge_index(host_array(edge_index), x.shape[0],
                            edge_weight=ew, dedup=True, device=dev)
    return x.detach().to(dev), adj, y.detach().to(dev)


class SalvageError(RuntimeError):
    """Raised when a mangled torch archive cannot be recovered losslessly."""


def _salvage_mangled_pt(path: str) -> np.ndarray:
    """Recover a tensor from a UTF-8-mangled torch zip archive.

    Some of the reference's checked-in artifacts
    (``interface/reduced_graph/*/label_*.pt`` and the ``*_0.25_*``
    adjacencies) were once decoded as UTF-8 with ``errors='replace'`` and
    re-encoded: every valid multi-byte sequence survives while invalid
    bytes became U+FFFD and are lost.  int64 label payloads are pure
    ASCII (values below 0x80) and survive bit for bit; the payload is
    found from the ``data/0`` zip local header, and :class:`SalvageError`
    is raised if any lost byte falls inside it.  float32 payloads are
    typically unrecoverable.
    """
    s = open(path, "rb").read().decode("utf-8")
    by = bytearray()
    lost: set[int] = set()
    for c in s:
        if c == "�":
            lost.add(len(by))
            by.append(0)
        else:
            by.extend(c.encode("utf-8"))
    data = bytes(by)

    # storage dtype from the (mostly ASCII) pickle
    if b"LongStorage" in data:
        dtype, isize = "<i8", 8
    elif b"IntStorage" in data:
        dtype, isize = "<i4", 4
    elif b"FloatStorage" in data:
        dtype, isize = "<f4", 4
    elif b"DoubleStorage" in data:
        dtype, isize = "<f8", 8
    else:
        raise SalvageError(f"{path}: no recognizable storage dtype")

    j = data.find(b"data/0")
    if j < 0:
        raise SalvageError(f"{path}: no data/0 entry")
    hdr = data.rfind(b"PK\x03\x04", 0, j)
    if hdr < 0:
        # a 'data/0' substring with no local-file header before it is not
        # a torch archive
        raise SalvageError(f"{path}: no local header before data/0")
    nlen, elen = struct.unpack("<HH", data[hdr + 26:hdr + 30])
    start = hdr + 30 + nlen + elen
    # end anchor: the local header of the 'version' member that follows
    # the payload in torch's archive layout
    v = data.find(b"version", start)
    if v < 0:
        raise SalvageError(f"{path}: no trailing version member")
    end = data.rfind(b"PK\x03\x04", start, v)
    if end < 0:
        end = v
    # drop a trailing data descriptor (PK\x07\x08 + 12 bytes) if present
    dd = data.rfind(b"PK\x07\x08", start, end)
    if dd >= 0:
        end = dd
    end = start + ((end - start) // isize) * isize
    if any(start <= u < end for u in lost):
        raise SalvageError(f"{path}: lost bytes inside tensor payload")
    return np.frombuffer(data[start:end], dtype=dtype).copy()


def load_torch_artifact(path: str) -> np.ndarray:
    """A ``.pt`` tensor artifact as a NumPy array: ``torch.load`` first,
    the salvage path for a UTF-8-mangled archive
    (:func:`_salvage_mangled_pt`)."""
    try:
        t = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        return _salvage_mangled_pt(path)
    if getattr(t, "is_sparse", False) or getattr(t, "is_sparse_csr", False):
        t = t.to_dense()
    return np.asarray(t.detach().cpu().numpy())


def load_reference_reduced(root: str, method: str, dataset: str,
                           rate: float, seed: int = 1,
                           device=None) -> G.Reduced:
    """A reduced graph in the reference's artifact layout
    (``{root}/{method}/{adj,label}_{dataset}_{rate}_{seed}.pt``,
    ``interface/vis_graphslim.py:26-117``) as a :class:`G.Reduced` on
    ``device``.  The layout stores no features: ``feat`` is the labels'
    one-hot encoding."""
    dev = resolve_device(device)
    adj_p = os.path.join(root, method, f"adj_{dataset}_{rate}_{seed}.pt")
    lab_p = os.path.join(root, method, f"label_{dataset}_{rate}_{seed}.pt")
    adj = load_torch_artifact(adj_p).astype(np.float32)
    n = adj.shape[0]
    labels = load_torch_artifact(lab_p).astype(np.int64)
    if labels.shape[0] != n:
        raise SalvageError(
            f"label length {labels.shape[0]} != adj rows {n}")
    nclass = int(labels.max()) + 1
    feat = np.eye(nclass, dtype=np.float32)[labels]
    return G.Reduced(feat=torch.as_tensor(feat, device=dev),
                     adj=torch.as_tensor(adj, device=dev),
                     labels=torch.as_tensor(labels, device=dev))


def save_reference_layout(reduced: G.Reduced, root: str, method: str,
                          dataset: str, rate: float,
                          seed: int = 1) -> tuple[str, str]:
    """Write a reduced graph in the reference's artifact layout (what
    :func:`load_reference_reduced` and ``vis_graphslim.py`` read): a dense
    float32 adjacency (the identity for a structure-free result, the
    first graph of a batch) and int64 labels.  Returns the two paths."""
    d = os.path.join(root, method)
    os.makedirs(d, exist_ok=True)
    labels = host_array(reduced.labels)
    if labels.ndim == 2:
        labels = labels.argmax(1)
    n = labels.shape[0]
    adj = reduced.adj
    if adj is None:
        adj_np = np.eye(n, dtype=np.float32)
    elif isinstance(adj, G.SparseAdj):
        adj_np = host_array(adj.to_dense()).astype(np.float32)
    else:
        adj_np = host_array(adj).astype(np.float32)
        if adj_np.ndim == 3:
            adj_np = adj_np[0]
    adj_p = os.path.join(d, f"adj_{dataset}_{rate}_{seed}.pt")
    lab_p = os.path.join(d, f"label_{dataset}_{rate}_{seed}.pt")
    torch.save(torch.from_numpy(np.ascontiguousarray(adj_np)), adj_p)
    torch.save(torch.from_numpy(
        np.ascontiguousarray(labels.astype(np.int64))), lab_p)
    return adj_p, lab_p
