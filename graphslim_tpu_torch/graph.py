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
                np.asarray(self.val, dtype=np.float32), device=device))


def host_of(adj: SparseAdj) -> HostAdj:
    """Read a SparseAdj back to the host (small graphs only)."""
    return HostAdj(adj.indptr.cpu().numpy(), adj.row.cpu().numpy(),
                   adj.col.cpu().numpy(),
                   None if adj.val is None else adj.val.cpu().numpy())


def host_gcn_norm(h: HostAdj) -> HostAdj:
    """Self loops + symmetric normalization, entirely on host."""
    n = h.n_rows
    row, col, val = h.row, h.col, h.values_or_ones()
    off = row != col
    row = np.concatenate([row[off], np.arange(n)])
    col = np.concatenate([col[off], np.arange(n)])
    val = np.concatenate([val[off].astype(np.float32),
                          np.ones(n, dtype=np.float32)])
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, row, val)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    vn = (val * dinv[row] * dinv[col]).astype(np.float32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    return HostAdj(np.cumsum(indptr), row, col, vn)


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
    else:
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        if w is not None:
            w = w[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return HostAdj(indptr, row.astype(np.int64), col.astype(np.int64),
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


def submatrix(adj: HostAdj, idx: np.ndarray, device=None) -> SparseAdj:
    """adj[np.ix_(idx, idx)] — induced subgraph (host-side), on the CUDA
    card unless ``device`` says otherwise."""
    idx = np.asarray(idx)
    lookup = -np.ones(adj.n_rows, dtype=np.int64)
    lookup[idx] = np.arange(idx.shape[0])
    row = lookup[np.asarray(adj.row)]
    col = lookup[np.asarray(adj.col)]
    keep = (row >= 0) & (col >= 0)
    ei = np.stack([row[keep], col[keep]])
    w = None if adj.val is None else np.asarray(adj.val)[keep]
    return from_edge_index(ei, idx.shape[0], edge_weight=w, dedup=False,
                           device=device)


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
    """Full-graph dataset (transductive views only in this slice)."""

    name: str
    feat: torch.Tensor          # [n, d] float32
    labels: torch.Tensor        # [n] int64
    adj: SparseAdj              # raw (unnormalized, no self loops)
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    nclass: int
    setting: str = "trans"
    adj_host: Optional[HostAdj] = dataclasses.field(default=None,
                                                    repr=False)
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
            host = self.adj_host if self.adj_host is not None \
                else host_of(self.adj)
            self._adj_norm_host = host_gcn_norm(host)
        return self._adj_norm_host

    def adj_norm(self) -> SparseAdj:
        """Cached GCN-normalized full adjacency (with self loops) on the
        dataset's device; its ``matmul`` is the SpMM dispatch, and its
        blocked layout is cached on it."""
        if self._adj_norm is None:
            self._adj_norm = self.adj_norm_host().to_sparse(self.device)
        return self._adj_norm

    def labels_for_reduction(self) -> np.ndarray:
        """Host labels of the pool reducers draw from (the train split)."""
        if self.setting == "ind":
            raise NotImplementedError(
                "inductive datasets are not ported yet (ROADMAP.md, "
                "queue 1, item 1)")
        return self.labels.cpu().numpy()[self.idx_train]
