"""Graph containers: sparse adjacency and dataset objects.

Counterpart of ``graphslim_tpu/graph.py``.  :class:`SparseAdj` keeps both
the CSR (``indptr``/``col``) and the row-sorted COO (``row``/``col``/``val``)
views as torch tensors; its product with a dense matrix goes through
:func:`graphslim_tpu_torch.kernels.spmm.spmm` (on the card: the blocked
SpMM kernel over a layout cached on the adjacency).  Load-time work
(building, normalizing, submatrices, layouts) is host NumPy, as in the JAX
package, and the result is moved to the dataset's device once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphslim_tpu_torch.kernels import spmm_blocked as _blocked
from graphslim_tpu_torch.kernels.segment import segment_sum
from graphslim_tpu_torch.kernels.spmm import spmm as _spmm
from graphslim_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class SparseAdj:
    """Row-sorted sparse adjacency in joint COO+CSR form (torch tensors).

    ``row`` is non-decreasing, ``indptr[r]:indptr[r+1]`` spans row ``r``.
    ``val`` may be ``None`` for an unweighted graph (implicit 1.0).
    """

    indptr: torch.Tensor        # [n_rows + 1] int64
    row: torch.Tensor           # [nnz] int64, sorted
    col: torch.Tensor           # [nnz] int64
    val: Optional[torch.Tensor]  # [nnz] float32 or None
    _layouts: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)
    # the host mirror this adjacency was moved from, if any (layouts are
    # built from it without a read-back)
    _host: Optional["HostAdj"] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.row.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def values_or_ones(self) -> torch.Tensor:
        if self.val is None:
            return torch.ones(self.nnz, dtype=torch.float32,
                              device=self.device)
        return self.val

    def with_val(self, val: torch.Tensor) -> "SparseAdj":
        return SparseAdj(self.indptr, self.row, self.col, val)

    def to(self, device) -> "SparseAdj":
        if torch.device(device) == self.device:
            return self
        return SparseAdj(self.indptr.to(device), self.row.to(device),
                         self.col.to(device),
                         None if self.val is None else self.val.to(device))

    def to_csr(self, n_cols: Optional[int] = None) -> torch.Tensor:
        """torch sparse CSR view (no copy of the index arrays), for
        callers that want the library's product; nothing here does."""
        n_cols = self.n_rows if n_cols is None else n_cols
        return torch.sparse_csr_tensor(
            self.indptr, self.col, self.values_or_ones(),
            size=(self.n_rows, n_cols), check_invariants=False)

    def blocked(self, transpose: bool = False, **sizes):
        """Cached blocked layout of this (square) matrix, or of its
        transpose, for the blocked SpMM; built on the host once per
        adjacency and tile sizes (``td``, ``ts``, ``chunk``,
        ``stage_min``).  A symmetric matrix shares one layout."""
        key = (transpose,) + tuple(sorted(sizes.items()))
        if key not in self._layouts:
            h = host_of(self)
            csr = (h.indptr, h.col, h.val)
            if transpose:
                csr_t = _blocked.transpose_csr(*csr)
                same = all(a is b or np.array_equal(a, b)
                           for a, b in zip(csr, csr_t))
                self._layouts[key] = self.blocked(**sizes) if same else \
                    _blocked.build_blocked(*csr_t, device=self.device,
                                           **sizes)
            else:
                self._layouts[key] = _blocked.build_blocked(
                    *csr, device=self.device, **sizes)
        return self._layouts[key]

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x through the SpMM dispatch."""
        return _spmm(self, x)

    def rmatmul(self, x: torch.Tensor, n_cols: int) -> torch.Tensor:
        """A.T @ x (segment sum over col)."""
        gathered = x.index_select(0, self.row)
        if self.val is not None:
            gathered = gathered * self.val.to(gathered.dtype).unsqueeze(-1)
        return segment_sum(gathered, self.col, n_cols)

    def sum_rows(self) -> torch.Tensor:
        return segment_sum(self.values_or_ones(), self.row, self.n_rows)

    def to_dense(self, n_cols: Optional[int] = None) -> torch.Tensor:
        n_cols = self.n_rows if n_cols is None else n_cols
        dense = torch.zeros(self.n_rows, n_cols, dtype=torch.float32,
                            device=self.device)
        return dense.index_put_((self.row, self.col),
                                self.values_or_ones(), accumulate=True)


class HostAdj(NamedTuple):
    """Host (NumPy) mirror of a SparseAdj, for load-time pipelines."""

    indptr: np.ndarray
    row: np.ndarray
    col: np.ndarray
    val: Optional[np.ndarray]

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    def values_or_ones(self) -> np.ndarray:
        if self.val is None:
            return np.ones(self.row.shape[0], dtype=np.float32)
        return self.val

    def to_sparse(self, device) -> SparseAdj:
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)
        return SparseAdj(
            indptr=t(self.indptr), row=t(self.row), col=t(self.col),
            val=None if self.val is None else torch.as_tensor(
                np.asarray(self.val, dtype=np.float32), device=device),
            _host=self)


def host_of(adj: SparseAdj) -> HostAdj:
    """The host mirror a SparseAdj was moved from, or its read-back."""
    if adj._host is not None:
        return adj._host
    return HostAdj(adj.indptr.cpu().numpy(), adj.row.cpu().numpy(),
                   adj.col.cpu().numpy(),
                   None if adj.val is None else adj.val.cpu().numpy())


def _is_sorted(keys: np.ndarray) -> bool:
    return keys.shape[0] < 2 or bool((keys[1:] >= keys[:-1]).all())


def _indptr(row: np.ndarray, n: int) -> np.ndarray:
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=indptr[1:])
    return indptr


def host_gcn_norm(h: HostAdj) -> HostAdj:
    """Self loops + symmetric normalization, entirely on host.  ``h`` is
    (row, col)-sorted, as ``host_from_edge_index`` builds every adjacency;
    the loops go in by insertion, leaving the entries in the order the JAX
    package's stable sort gives them."""
    n = h.n_rows
    row, col, val = h.row, h.col, h.values_or_ones()
    off = row != col
    row, col = row[off], col[off]
    val = val[off].astype(np.float32)
    loop = np.arange(n)
    keys = row * n + col
    if not _is_sorted(keys):
        raise ValueError("host_gcn_norm needs (row, col)-sorted entries")
    at = np.searchsorted(keys, loop * n + loop)
    row, col = np.insert(row, at, loop), np.insert(col, at, loop)
    val = np.insert(val, at, np.float32(1.0))
    # bincount sums in the entries' order in float64, as np.add.at does
    deg = np.bincount(row, weights=val, minlength=n)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    vn = (val * dinv[row] * dinv[col]).astype(np.float32)
    return HostAdj(_indptr(row, n), row, col, vn)


def host_from_edge_index(edge_index: np.ndarray, n_nodes: int,
                         edge_weight: Optional[np.ndarray] = None,
                         symmetrize: bool = False,
                         dedup: bool = True) -> HostAdj:
    """Row-sorted HostAdj from a [2, E] edge index."""
    ei = np.asarray(edge_index)
    row, col = ei[0].astype(np.int64), ei[1].astype(np.int64)
    w = None if edge_weight is None else np.asarray(edge_weight)
    if symmetrize:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
        if w is not None:
            w = np.concatenate([w, w])
    if dedup:
        keys = row * n_nodes + col
        uniq, inv = np.unique(keys, return_inverse=True)
        if w is not None:
            wsum = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(wsum, inv, w)
            w = wsum
        row, col = uniq // n_nodes, uniq % n_nodes
    elif not _is_sorted(row * n_nodes + col):
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        if w is not None:
            w = w[order]
    return HostAdj(_indptr(row, n_nodes), row.astype(np.int64),
                   col.astype(np.int64),
                   None if w is None else w.astype(np.float32))


def from_edge_index(edge_index: np.ndarray, n_nodes: int,
                    edge_weight: Optional[np.ndarray] = None,
                    symmetrize: bool = False, dedup: bool = True,
                    device=None, return_host: bool = False):
    """Row-sorted SparseAdj from a [2, E] edge index (host-side build),
    on the CUDA card unless ``device`` says otherwise."""
    host = host_from_edge_index(edge_index, n_nodes, edge_weight,
                                symmetrize, dedup)
    adj = host.to_sparse(resolve_device(device))
    return (adj, host) if return_host else adj


def host_submatrix(adj: HostAdj, idx: np.ndarray) -> HostAdj:
    """adj[np.ix_(idx, idx)] — induced subgraph, on the host."""
    idx = np.asarray(idx)
    lookup = -np.ones(adj.n_rows, dtype=np.int64)
    lookup[idx] = np.arange(idx.shape[0])
    row = lookup[np.asarray(adj.row)]
    col = lookup[np.asarray(adj.col)]
    keep = (row >= 0) & (col >= 0)
    ei = np.stack([row[keep], col[keep]])
    w = None if adj.val is None else np.asarray(adj.val)[keep]
    return host_from_edge_index(ei, idx.shape[0], edge_weight=w,
                                dedup=False)


def submatrix(adj: HostAdj, idx: np.ndarray, device=None) -> SparseAdj:
    """adj[np.ix_(idx, idx)] — induced subgraph (host-side), on the CUDA
    card unless ``device`` says otherwise."""
    return host_submatrix(adj, idx).to_sparse(resolve_device(device))


def add_self_loops(adj: HostAdj, fill_value: float = 1.0) -> HostAdj:
    """Self loops on every row; existing diagonal entries are replaced by
    ``fill_value`` (PyG ``add_remaining_self_loops`` + ``fill_diag``)."""
    n = adj.n_rows
    row, col = np.asarray(adj.row), np.asarray(adj.col)
    val = np.asarray(adj.values_or_ones())
    off_diag = row != col
    row, col, val = row[off_diag], col[off_diag], val[off_diag]
    loop = np.arange(n)
    row = np.concatenate([row, loop])
    col = np.concatenate([col, loop])
    val = np.concatenate([val, np.full(n, fill_value, dtype=val.dtype)])
    return host_from_edge_index(np.stack([row, col]), n, edge_weight=val,
                                dedup=True)


def gcn_norm(adj: SparseAdj, add_loops: bool = True) -> SparseAdj:
    """Symmetric GCN normalization of a sparse adjacency (host NumPy,
    once per graph at load time; the result lands on ``adj``'s device)."""
    host = host_of(adj)
    if add_loops:
        host = add_self_loops(host)
    row, col = host.row, host.col
    v = host.values_or_ones()
    deg = np.zeros(host.n_rows, dtype=np.float64)
    np.add.at(deg, row, v)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    vn = (v * dinv[row] * dinv[col]).astype(np.float32)
    return HostAdj(host.indptr, row, col, vn).to_sparse(adj.device)


def normalize_adj_dense(adj: torch.Tensor, add_loops: bool = True
                        ) -> torch.Tensor:
    """Dense D^-1/2 (A+I) D^-1/2 — used on synthetic condensed graphs."""
    if add_loops:
        adj = adj + torch.eye(adj.shape[-1], dtype=adj.dtype,
                              device=adj.device)
    deg = adj.sum(-1)
    dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                       torch.zeros_like(deg))
    return adj * dinv[..., :, None] * dinv[..., None, :]


# ---------------------------------------------------------------------------
# Dataset containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Reduced:
    """The condensed/selected graph triple every reducer returns: ``adj``
    is a dense [n_syn, n_syn] tensor, a SparseAdj, or None (identity)."""

    feat: torch.Tensor
    adj: object
    labels: torch.Tensor

    @property
    def n_syn(self) -> int:
        return self.feat.shape[0]

    def dense_adj(self) -> torch.Tensor:
        if self.adj is None:
            return torch.eye(self.n_syn, dtype=self.feat.dtype,
                             device=self.feat.device)
        if isinstance(self.adj, SparseAdj):
            return self.adj.to_dense()
        return self.adj


@dataclasses.dataclass
class Dataset:
    """Full-graph dataset and, in the inductive setting, the induced train,
    val and test subgraphs (``feat_/labels_/adj_`` + split).  Normalized
    adjacencies are built on the host once and cached with their device
    copies, so a blocked layout cached on one is built once per dataset."""

    name: str
    feat: torch.Tensor          # [n, d] float32
    labels: torch.Tensor        # [n] int64
    adj: SparseAdj              # raw (unnormalized, no self loops)
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    nclass: int
    setting: str = "trans"
    # inductive views (set by data.load for setting='ind')
    feat_train: Optional[torch.Tensor] = None
    labels_train: Optional[torch.Tensor] = None
    adj_train: Optional[SparseAdj] = None
    feat_val: Optional[torch.Tensor] = None
    labels_val: Optional[torch.Tensor] = None
    adj_val: Optional[SparseAdj] = None
    feat_test: Optional[torch.Tensor] = None
    labels_test: Optional[torch.Tensor] = None
    adj_test: Optional[SparseAdj] = None
    adj_host: Optional[HostAdj] = dataclasses.field(default=None,
                                                    repr=False)
    # per view: its normalized host mirror and normalized device adjacency
    _view_norm_host: dict = dataclasses.field(default_factory=dict,
                                              repr=False)
    _view_norm: dict = dataclasses.field(default_factory=dict, repr=False)
    _adj_norm: Optional[SparseAdj] = dataclasses.field(default=None,
                                                       repr=False)
    _adj_norm_host: Optional[HostAdj] = dataclasses.field(default=None,
                                                          repr=False)

    @property
    def n_nodes(self) -> int:
        return self.feat.shape[0]

    @property
    def n_feat(self) -> int:
        return self.feat.shape[1]

    @property
    def device(self) -> torch.device:
        return self.feat.device

    def adj_norm_host(self) -> HostAdj:
        """Cached host-side normalized adjacency (NumPy)."""
        if self._adj_norm_host is None:
            self._adj_norm_host = host_gcn_norm(host_of(self.adj))
        return self._adj_norm_host

    def adj_norm(self) -> SparseAdj:
        """Cached GCN-normalized full adjacency (with self loops) on the
        dataset's device; its ``matmul`` is the SpMM dispatch, and its
        blocked layout is cached on it."""
        if self._adj_norm is None:
            self._adj_norm = self.adj_norm_host().to_sparse(self.device)
        return self._adj_norm

    def set_view(self, split: str, feat: torch.Tensor,
                 labels: torch.Tensor, host: HostAdj) -> None:
        """Install the induced subgraph of ``split`` (train | val | test)
        from its host mirror; the adjacency moves to the device once and
        keeps the mirror."""
        setattr(self, f"feat_{split}", feat)
        setattr(self, f"labels_{split}", labels)
        setattr(self, f"adj_{split}", host.to_sparse(self.device))

    def view_host(self, split: str) -> HostAdj:
        """Raw host mirror of the ``split`` subgraph's adjacency."""
        return host_of(getattr(self, f"adj_{split}"))

    def view_norm_host(self, split: str) -> HostAdj:
        """Cached host-side normalized adjacency of the ``split``
        subgraph."""
        if split not in self._view_norm_host:
            self._view_norm_host[split] = host_gcn_norm(
                self.view_host(split))
        return self._view_norm_host[split]

    def view_norm(self, split: str) -> SparseAdj:
        """Cached GCN-normalized adjacency of the ``split`` subgraph on the
        dataset's device (the JAX evaluator normalizes it at every call)."""
        if split not in self._view_norm:
            self._view_norm[split] = self.view_norm_host(split).to_sparse(
                self.device)
        return self._view_norm[split]

    def train_graph(self) -> tuple:
        """(feat, adj, labels) that reducers consume: the full graph, or
        the train subgraph in the inductive setting."""
        if self.setting == "ind":
            return self.feat_train, self.adj_train, self.labels_train
        return self.feat, self.adj, self.labels

    def train_host(self) -> HostAdj:
        """Raw host mirror of the graph reducers consume."""
        return host_of(self.train_graph()[1])

    def train_norm_host(self) -> HostAdj:
        """Normalized host mirror of the graph reducers consume."""
        if self.setting == "ind":
            return self.view_norm_host("train")
        return self.adj_norm_host()

    def train_norm(self) -> SparseAdj:
        """Normalized device adjacency of the graph reducers consume."""
        if self.setting == "ind":
            return self.view_norm("train")
        return self.adj_norm()

    def pool_ids(self) -> np.ndarray:
        """Rows of the train pool in the graph reducers consume: global
        ``idx_train`` ids, or local ids of the train subgraph."""
        if self.setting == "ind":
            return np.arange(len(self.idx_train))
        return np.asarray(self.idx_train)

    def split_batch(self, split: str) -> tuple:
        """``(x, adj_normalized, y, idx)`` of a split (train | val | test)
        for the trainer: the full graph at ``idx_<split>``, or in the
        inductive setting the split's own subgraph, every row
        (``idx=None``)."""
        if self.setting == "ind":
            return (getattr(self, f"feat_{split}"), self.view_norm(split),
                    getattr(self, f"labels_{split}"), None)
        idx = torch.as_tensor(getattr(self, f"idx_{split}"),
                              device=self.device)
        return self.feat, self.adj_norm(), self.labels[idx], idx

    def pool_subgraph(self) -> SparseAdj:
        """Raw adjacency among the train pool's rows: the train subgraph,
        induced from the full graph in the transductive setting."""
        if self.setting == "ind":
            return self.adj_train
        return submatrix(host_of(self.adj), self.idx_train,
                         device=self.device)

    def pool_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The train pool's rows of ``x``, a per-node tensor over the
        graph reducers consume (in the inductive setting, all of them)."""
        if self.setting == "ind":
            return x
        return x[torch.as_tensor(self.idx_train, device=x.device)]

    def labels_for_reduction(self) -> np.ndarray:
        """Host labels of the pool reducers draw from (the train split)."""
        if self.setting == "ind":
            return self.labels_train.cpu().numpy()
        return self.labels.cpu().numpy()[self.idx_train]
