"""On-disk dataset ingestion (NumPy and SciPy only, no torch).

Counterpart of ``graphslim_tpu/data/ingest.py``, the same readers line for
line, so both packages read the same arrays from the same files:

* **GraphSAINT layout** (what the reference's ``DataGraphSAINT`` downloads,
  ``graphslim/dataset/loader.py:380-515``): ``adj_full.npz`` (scipy CSR),
  ``feats.npy``, ``class_map.json``, ``role.json``.
* **Planetoid raw files** (what PyG's ``Planetoid`` reads for
  cora/citeseer/pubmed, reference ``loader.py:61``):
  ``ind.{name}.{x,tx,allx,y,ty,ally,graph,test.index}`` pickles.
* **OGB node-prop raw layout** (reference ``PygNodePropPredDataset``,
  ``loader.py:67``): ``raw/{edge,node-feat,node-label}.csv.gz`` +
  ``split/*/{train,valid,test}.csv.gz``.
* **gnn-benchmark npz** (what PyG's ``CitationFull``/``Coauthor``/
  ``Amazon`` download for cora_ml/dblp/cs/physics/photo/computers,
  reference ``loader.py:57-64``): one ``{name}.npz`` with CSR-keyed
  ``adj_{data,indices,indptr,shape}`` + ``attr_*`` + ``labels``.
* **DGL FraudDataset .mat** (``YelpChi.mat``/``Amazon.mat``, reference
  ``loader.py:72-73`` via ``from_dgl(hetero=False)``): multi-relation
  ``net_*`` sparse adjacencies unioned + self-loops, sparse
  ``features``, ``label``.
* **Generic npz**: one ``{name}.npz`` with keys ``edge_index``, ``feat``,
  ``labels`` and optional ``idx_train/idx_val/idx_test``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import pickle

import numpy as np


def try_load(name: str, data_dir: str):
    """Return ``(edge_index, feat, labels, role_or_None)`` or ``None``."""
    root = os.path.join(data_dir, name)
    saint = os.path.join(root, "adj_full.npz")
    if os.path.exists(saint):
        return _load_graphsaint(root)
    for sub in ("raw", "."):
        pl = os.path.join(root, sub, f"ind.{name}.x")
        if os.path.exists(pl):
            return _load_planetoid(os.path.dirname(pl), name)
    # OGB keeps '-' as '_' in its directory name (ogbn-arxiv -> ogbn_arxiv)
    for r in (root, os.path.join(data_dir, name.replace("-", "_"))):
        if os.path.exists(os.path.join(r, "raw", "edge.csv.gz")):
            return _load_ogb(r)
    # DGL FraudDataset raw .mat (yelp -> YelpChi.mat, amazon -> Amazon.mat).
    # Gated on the fraud schema ('features' + 'label' keys) so a stray .mat
    # under a non-fraud dataset's dir can't shadow the generic-npz fallback
    # or die inside the fraud parser.
    mats = sorted(glob.glob(os.path.join(root, "*.mat"))
                  + glob.glob(os.path.join(root, "raw", "*.mat"))
                  + glob.glob(os.path.join(data_dir, f"{name}.mat")))
    for mat in mats:
        if _is_fraud_mat(mat):
            return _load_fraud_mat(mat)
    generic = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(generic):
        return _load_generic(generic)
    return None


def _load_graphsaint(root: str):
    import scipy.sparse as sp

    adj = sp.load_npz(os.path.join(root, "adj_full.npz")).tocoo()
    edge_index = np.stack([adj.row, adj.col]).astype(np.int64)
    feat = np.load(os.path.join(root, "feats.npy")).astype(np.float32)
    with open(os.path.join(root, "class_map.json")) as f:
        class_map = json.load(f)
    labels = np.zeros(feat.shape[0], dtype=np.int32)
    for k, v in class_map.items():
        labels[int(k)] = int(v) if np.isscalar(v) else int(np.argmax(v))
    with open(os.path.join(root, "role.json")) as f:
        role = json.load(f)
    return edge_index, feat, labels, role


def _load_planetoid(raw_dir: str, name: str):
    """Parse the Planetoid ``ind.*`` pickles (the exact files PyG's
    ``Planetoid`` processes; assembly follows Kipf & Welling's reference
    loader, including the citeseer isolated-test-node fill).

    ``x/tx/allx`` are pickled scipy sparse matrices, ``y/ty/ally`` one-hot
    label arrays, ``graph`` a ``{node: [neighbors]}`` dict, ``test.index``
    a text file of (permuted) test node ids.  The historical files are
    python-2 pickles — loaded with ``encoding='latin1'`` like every
    downstream consumer.
    """
    import scipy.sparse as sp

    def _pk(suffix):
        with open(os.path.join(raw_dir, f"ind.{name}.{suffix}"),
                  "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = _pk("x"), _pk("tx"), _pk("allx")
    y, ty, ally = _pk("y"), _pk("ty"), _pk("ally")
    graph = _pk("graph")
    with open(os.path.join(raw_dir, f"ind.{name}.test.index")) as f:
        test_idx = np.array([int(line.strip()) for line in f
                             if line.strip()], dtype=np.int64)
    test_range = np.sort(test_idx)

    n_iso = int(test_range[-1]) - int(test_range[0]) + 1
    if n_iso > tx.shape[0]:
        # citeseer: isolated test nodes missing from tx/ty — zero-fill
        # the full contiguous test range
        tx_ext = sp.lil_matrix((n_iso, x.shape[1]), dtype=np.float32)
        tx_ext[test_range - test_range[0], :] = tx
        tx = tx_ext
        ty_ext = np.zeros((n_iso, y.shape[1]), dtype=ty.dtype)
        ty_ext[test_range - test_range[0], :] = ty
        ty = ty_ext

    feat = sp.vstack([allx, tx]).tolil()
    feat[test_idx, :] = feat[test_range, :]
    feat = np.asarray(feat.todense(), dtype=np.float32)
    labels_oh = np.vstack([ally, ty])
    labels_oh[test_idx, :] = labels_oh[test_range, :]
    # isolated citeseer test nodes have all-zero one-hots; argmax -> 0
    labels = labels_oh.argmax(1).astype(np.int32)

    src, dst = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            src.append(int(u))
            dst.append(int(v))
    edge_index = np.array([src, dst], dtype=np.int64)

    # standard Planetoid split: first len(y) nodes train, next 500 val
    # (capped for graphs smaller than the historical 500), sorted test
    # range.
    n_train = y.shape[0]
    n_val_end = min(n_train + 500, int(test_range[0]))
    role = {"tr": np.arange(n_train),
            "va": np.arange(n_train, n_val_end),
            "te": test_range}
    return edge_index, feat, labels, role


def _load_ogb(root: str):
    """Parse the OGB node-prop csv.gz raw layout: ``raw/edge.csv.gz``
    (src,dst per line), ``raw/node-feat.csv.gz``,
    ``raw/node-label.csv.gz``, and the official split under
    ``split/<scheme>/{train,valid,test}.csv.gz`` (scheme varies:
    time/sales_ranking — first one found wins).

    csv parsing goes through pandas when importable (OGB's own loader
    does the same; np.loadtxt tokenizes in Python at ~1M lines/s —
    hours on products' 123.7M-line edge file) with a loadtxt fallback.
    Layouts this parser does NOT cover are rejected with a clear error
    instead of mis-parsing: ogbn-proteins has edge-level features (no
    ``node-feat.csv.gz``) and a multi-label ``[N, 112]`` label file —
    flattening that would corrupt nclass and every split downstream.
    """

    def _csv(path, dtype):
        try:
            import pandas as pd

            return pd.read_csv(path, header=None).to_numpy(dtype=dtype)
        except ImportError:
            op = gzip.open if path.endswith(".gz") else open
            with op(path, "rt") as f:
                return np.loadtxt(f, delimiter=",", dtype=dtype,
                                  ndmin=2)

    raw = os.path.join(root, "raw")
    feat_path = os.path.join(raw, "node-feat.csv.gz")
    if not os.path.exists(feat_path):
        raise NotImplementedError(
            f"{root}: OGB layout without node-feat.csv.gz (edge-level "
            f"features, e.g. ogbn-proteins) is not supported by the "
            f"csv parser")
    edge = _csv(os.path.join(raw, "edge.csv.gz"), np.int64)
    feat = _csv(feat_path, np.float32)
    label_mat = _csv(os.path.join(raw, "node-label.csv.gz"), np.int64)
    if label_mat.ndim == 2 and label_mat.shape[1] > 1:
        raise NotImplementedError(
            f"{root}: multi-label node-label file "
            f"(shape {label_mat.shape}) is not supported by the csv "
            f"parser")
    labels = label_mat.ravel().astype(np.int32)
    edge_index = edge.T
    role = None
    for tr in sorted(glob.glob(os.path.join(root, "split", "*",
                                            "train.csv.gz"))):
        scheme = os.path.dirname(tr)
        role = {
            "tr": _csv(os.path.join(scheme, "train.csv.gz"),
                       np.int64).ravel(),
            "va": _csv(os.path.join(scheme, "valid.csv.gz"),
                       np.int64).ravel(),
            "te": _csv(os.path.join(scheme, "test.csv.gz"),
                       np.int64).ravel(),
        }
        break
    return edge_index, feat, labels, role


def _load_gnn_benchmark(data):
    """Parse the gnn-benchmark npz schema (Bojchevski & Günnemann's
    format, served by PyG for CitationFull / Coauthor / Amazon): sparse
    CSR adjacency and attributes as ``{adj,attr}_{data,indices,indptr,
    shape}`` plus dense ``labels``.  Attributes may also be dense
    (``attr_matrix``).  No public split ships in these files — the
    reference applies its random ``splits()``, mirrored by returning
    ``role=None``.  ``data`` is the already-opened NpzFile (only array
    keys are read; class_names/idx_to_node are object arrays but
    unused, so allow_pickle stays False upstream)."""
    import scipy.sparse as sp

    adj = sp.csr_matrix((data["adj_data"], data["adj_indices"],
                         data["adj_indptr"]),
                        shape=tuple(data["adj_shape"])).tocoo()
    edge_index = np.stack([adj.row, adj.col]).astype(np.int64)
    if "attr_data" in data:
        attr = sp.csr_matrix((data["attr_data"], data["attr_indices"],
                              data["attr_indptr"]),
                             shape=tuple(data["attr_shape"]))
        feat = np.asarray(attr.todense(), dtype=np.float32)
    else:
        feat = np.asarray(data["attr_matrix"], dtype=np.float32)
    labels = np.asarray(data["labels"]).astype(np.int32)
    return edge_index, feat, labels, None


def _is_fraud_mat(path: str) -> bool:
    """True iff the .mat carries the FraudDataset schema (node 'features'
    + 'label' and at least one adjacency key)."""
    from scipy.io import loadmat

    try:
        m = loadmat(path)
    except Exception:
        return False
    return ("features" in m and "label" in m
            and ("homo" in m or any(k.startswith("net_") for k in m)))


def _load_fraud_mat(path: str):
    """Parse the DGL FraudDataset raw ``.mat`` (``YelpChi.mat`` /
    ``Amazon.mat`` — what ``FraudDataset`` itself reads).

    The reference loads these via ``FraudDataset`` →
    ``from_dgl(hetero=False)`` (``dataset/loader.py:72-73``,
    ``convertor.py:15-58``): the homogeneous view is the **union of
    every relation's edges plus self-loops**; features and labels come
    from the node table; no split ships (``splits()`` applies the
    random class-wise split downstream → ``role=None``).  Relation
    adjacencies are the ``net_*`` keys (yelp: rur/rtr/rsr, amazon:
    upu/usu/uvu); ``homo`` is the precomputed union, used only when no
    ``net_*`` key exists.  An edge present in several relations is
    deduplicated here (the reference's ``ei2csr`` sums duplicates into
    weight-k entries instead — a documented divergence: the condensed
    protocols binarize/renormalize, and multi-relation multiplicity is
    not part of any registered method's semantics)."""
    import scipy.sparse as sp
    from scipy.io import loadmat

    m = loadmat(path)
    rel_keys = sorted(k for k in m if k.startswith("net_"))
    if not rel_keys:
        if "homo" not in m:
            raise ValueError(
                f"{path}: no adjacency key found — expected 'net_*' "
                f"relation matrices or a precomputed 'homo' union "
                f"(got keys {sorted(k for k in m if not k.startswith('__'))})")
        rel_keys = ["homo"]
    parts = [np.stack(sp.coo_matrix(m[k]).nonzero()) for k in rel_keys]
    feat = m["features"]
    feat = np.asarray(feat.todense() if sp.issparse(feat) else feat,
                      dtype=np.float32)
    labels = np.asarray(m["label"]).ravel().astype(np.int32)
    n = feat.shape[0]
    loops = np.tile(np.arange(n, dtype=np.int64), (2, 1))
    # dedup AFTER appending self-loops so a loop already present in some
    # relation doesn't survive as a duplicate (weight-2 diagonal after
    # downstream COO summing)
    edge_index = np.unique(
        np.concatenate([p.astype(np.int64) for p in parts] + [loops],
                       axis=1), axis=1)
    return edge_index, feat, labels, None


def _load_generic(path: str):
    data = np.load(path, allow_pickle=False)
    if "adj_data" in data:
        return _load_gnn_benchmark(data)
    edge_index = data["edge_index"].astype(np.int64)
    feat = data["feat"].astype(np.float32)
    labels = data["labels"].astype(np.int32)
    role = None
    if "idx_train" in data:
        role = {"tr": data["idx_train"], "va": data["idx_val"],
                "te": data["idx_test"]}
    return edge_index, feat, labels, role
