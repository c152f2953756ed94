"""Degree-bucketed ELL adjacency: its product and GAT's edge softmax.

Counterpart of ``graphslim_tpu/kernels/ell.py``, which composes both from
XLA ops (no Pallas kernel), so here they are plain tensor ops:

* rows are grouped by degree into power-of-two buckets (K = 1, 2, 4, …,
  ``cap``); each bucket holds padded neighbour ids and values ``[n_b, K]``
  and is cut row-wise into parts of at most ``max_slots`` slots;
* a bucket's product is a gather and a slot contraction; rows heavier
  than ``cap`` go through a gather and a sorted segment sum, in
  row-disjoint chunks of at most ``max_slots`` entries;
* the parts concatenate in bucket order, and one gather through the
  inverse permutation (zero-degree rows point at a trailing zeros row)
  restores row order.

The layout is built once on the host from a CSR (``build_ell``).  In the
port only GAT reads it (:func:`attention_ell`, on the evaluator's full
graph); every other product of the port goes through the blocked SpMM.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from graphslim_tpu_torch.kernels.segment import segment_softmax, segment_sum
from graphslim_tpu_torch.utils import resolve_device


class EllBucket(NamedTuple):
    idx: torch.Tensor    # [n_b, K] int64 neighbour ids (global)
    val: torch.Tensor    # [n_b, K] float32 (0 on padding)
    rows: torch.Tensor   # [n_b] int64 global row id of each bucket row


class EllAdj:
    """Bucketed ELL adjacency.  ``inv_perm[r]`` locates row r in the
    concatenated part outputs; ``heavy_splits`` are the static
    ``(e_lo, e_hi, r_lo, r_hi)`` chunks of the heavy tail (``()``: one
    chunk), row-disjoint and in heavy-row order."""

    def __init__(self, buckets, inv_perm, heavy_row, heavy_col, heavy_val,
                 heavy_rows, n_heavy: int, n_rows: int,
                 heavy_splits: tuple = ()):
        self.buckets = tuple(buckets)
        self.inv_perm = inv_perm
        self.heavy_row = heavy_row
        self.heavy_col = heavy_col
        self.heavy_val = heavy_val
        self.heavy_rows = heavy_rows
        self.n_heavy = n_heavy
        self.n_rows = n_rows
        self.heavy_splits = tuple(heavy_splits)
        self.build_seconds = 0.0

    @property
    def nnz(self) -> int:
        """Stored slots: the buckets' padded slots and the heavy entries."""
        return (sum(b.val.numel() for b in self.buckets)
                + (0 if self.heavy_col is None else self.heavy_col.shape[0]))

    def chunks(self) -> tuple:
        """The heavy tail's chunks (one when it was not split)."""
        if self.heavy_col is None:
            return ()
        return self.heavy_splits or ((0, self.heavy_col.shape[0], 0,
                                      self.n_heavy),)

    def nbytes(self) -> int:
        arrays = [self.inv_perm] + [a for b in self.buckets for a in b]
        if self.heavy_col is not None:
            arrays += [self.heavy_row, self.heavy_col, self.heavy_val,
                       self.heavy_rows]
        return sum(a.numel() * a.element_size() for a in arrays)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_ell(self, x)


def _widths(cap: int) -> list:
    widths, w = [], 1
    while w < cap:
        widths.append(w)
        w *= 2
    return widths + [cap]


def build_ell(indptr: np.ndarray, indices: np.ndarray,
              values: Optional[np.ndarray], cap: int = 256,
              max_slots: int = 2_000_000, device=None) -> EllAdj:
    """The layout of a CSR matrix, built on the host, on the CUDA card
    unless ``device`` says otherwise.  A bucket part holds at most
    ``max_slots`` slots and a heavy chunk at most ``max_slots`` entries
    (at least one row each), which bounds one gather's working set to
    ``max_slots × d`` items."""
    dev = resolve_device(device)
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    n = indptr.shape[0] - 1
    values = (np.ones(indices.shape[0], dtype=np.float32) if values is None
              else np.asarray(values, dtype=np.float32))
    deg = np.diff(indptr)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    buckets, segments = [], []
    prev = 0
    for K in _widths(cap):
        rows_all = np.flatnonzero((deg > prev) & (deg <= K))
        prev = K
        if rows_all.size == 0:
            continue
        rows_per_part = max(max_slots // K, 1)
        for p0 in range(0, rows_all.size, rows_per_part):
            rows = rows_all[p0:p0 + rows_per_part]
            slot = np.arange(K)[None, :]
            pos = indptr[rows][:, None] + np.minimum(
                slot, np.maximum(deg[rows][:, None] - 1, 0))
            mask = slot < deg[rows][:, None]
            idx = np.where(mask, indices[pos], 0)
            val = np.where(mask, values[pos], 0.0).astype(np.float32)
            buckets.append(EllBucket(t(idx), t(val, torch.float32),
                                     t(rows)))
            segments.append(rows)

    heavy_rows = np.flatnonzero(deg > cap)
    heavy_splits: tuple = ()
    heavy_row = heavy_col = heavy_val = heavy_rows_t = None
    if heavy_rows.size:
        hdeg = deg[heavy_rows]
        hr = np.repeat(np.arange(heavy_rows.size), hdeg)
        starts = np.repeat(indptr[heavy_rows], hdeg)
        offs = np.arange(hdeg.sum()) - np.repeat(np.cumsum(hdeg) - hdeg,
                                                 hdeg)
        pos = starts + offs
        heavy_row, heavy_col = t(hr), t(indices[pos])
        heavy_val = t(values[pos], torch.float32)
        heavy_rows_t = t(heavy_rows)
        segments.append(heavy_rows)
        if int(hdeg.sum()) > max_slots:
            edge_end = np.cumsum(hdeg)
            splits, r_lo, e_lo = [], 0, 0
            while r_lo < heavy_rows.size:
                r_hi = int(np.searchsorted(edge_end, e_lo + max_slots,
                                           side="right"))
                r_hi = max(r_hi, r_lo + 1)
                e_hi = int(edge_end[r_hi - 1])
                splits.append((e_lo, e_hi, r_lo, r_hi))
                r_lo, e_lo = r_hi, e_hi
            heavy_splits = tuple(splits)

    order = (np.concatenate(segments) if segments
             else np.zeros(0, dtype=np.int64))
    inv = np.full(n, order.shape[0], dtype=np.int64)
    inv[order] = np.arange(order.shape[0])
    return EllAdj(buckets, t(inv), heavy_row, heavy_col, heavy_val,
                  heavy_rows_t, n_heavy=int(heavy_rows.size), n_rows=n,
                  heavy_splits=heavy_splits)


def ell_from_sparse(adj, cap: int = 256) -> EllAdj:
    """The layout of a :class:`graphslim_tpu_torch.graph.SparseAdj`, on its
    device (built from its host mirror)."""
    from graphslim_tpu_torch.graph import host_of

    h = host_of(adj)
    return build_ell(h.indptr, h.col, h.val, cap=cap, device=adj.device)


def spmm_ell(ell: EllAdj, x: torch.Tensor) -> torch.Tensor:
    """``A @ x``.  A bf16 ``x`` is gathered in bf16 and its values rounded
    to bf16, but every sum runs in float32 (the products of two bf16
    numbers are exact there) and the result is float32, as in the JAX
    package."""
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    parts = []
    for b in ell.buckets:
        g = x[b.idx]                                       # [n_b, K, d]
        parts.append(torch.einsum("nk,nkd->nd",
                                  b.val.to(x.dtype).to(acc), g.to(acc)))
    for e_lo, e_hi, r_lo, r_hi in ell.chunks():
        g = (x.index_select(0, ell.heavy_col[e_lo:e_hi])
             * ell.heavy_val[e_lo:e_hi, None].to(x.dtype)).to(acc)
        parts.append(segment_sum(g, ell.heavy_row[e_lo:e_hi] - r_lo,
                                 r_hi - r_lo))
    parts.append(x.new_zeros((1, x.shape[-1]), dtype=acc))
    return torch.cat(parts).index_select(0, ell.inv_perm)


def _drop(gen: Optional[torch.Generator], att: torch.Tensor, rate: float,
          training: bool) -> torch.Tensor:
    if gen is None or not training or rate <= 0.0:
        return att
    keep = torch.rand(att.shape, generator=gen, device=att.device) \
        < 1.0 - rate
    return torch.where(keep, att / (1.0 - rate), torch.zeros_like(att))


def attention_ell(ell: EllAdj, alpha_dst: torch.Tensor,
                  alpha_src: torch.Tensor, feat: torch.Tensor, *,
                  negative_slope: float = 0.2,
                  gen: Optional[torch.Generator] = None,
                  dropout: float = 0.0,
                  training: bool = False) -> torch.Tensor:
    """GAT's edge softmax and weighted aggregation with no scatter in the
    buckets: ``alpha_dst``, ``alpha_src`` ``[n, H]``, ``feat`` ``[n, H, h]``
    (float32, or bf16 messages) → ``[n, H, h]`` in ``feat``'s dtype.

    Per bucket, the softmax over a row's slots is row-local: scores of
    padding slots (value 0) are set to -1e9, the row's max is subtracted
    (and not differentiated), and the weights are scaled by the values.
    A stored value of exactly 0 is thus left out of the denominator in
    every part (the segment path of GAT keeps it; normalized adjacencies
    hold none).  The source logits ride in one gather with the messages
    (``[n, H + H·h]``), so on the bf16 path they are rounded to bf16 too;
    the destination logits and the softmax stay float32.  Dropout of the
    attention draws once per part and once per heavy chunk.  The heavy
    tail goes through :func:`segment_softmax` chunk by chunk."""
    n, H, h = feat.shape
    comb = torch.cat([alpha_src.to(feat.dtype), feat.reshape(n, H * h)],
                     dim=1)
    parts = []
    for b in ell.buckets:
        a_d = alpha_dst.index_select(0, b.rows)            # [n_b, H]
        gc = comb[b.idx]                                   # [n_b, K, H+H·h]
        a_s = gc[..., :H]
        g = gc[..., H:].reshape(b.idx.shape[0], b.idx.shape[1], H, h)
        s = F.leaky_relu(a_d[:, None, :] + a_s, negative_slope)
        mask = (b.val != 0.0)[..., None]
        s = torch.where(mask, s, torch.full_like(s, -1e9))
        s = s - s.amax(dim=1, keepdim=True).detach()
        e = torch.where(mask, torch.exp(s), torch.zeros_like(s))
        att = e / torch.clamp(e.sum(dim=1, keepdim=True), min=1e-16)
        att = _drop(gen, att * b.val[..., None], dropout, training)
        parts.append(torch.einsum("nkh,nkhd->nhd", att.to(feat.dtype), g))
    if ell.heavy_col is not None:
        a_d_heavy = alpha_dst.index_select(0, ell.heavy_rows)
        for e_lo, e_hi, r_lo, r_hi in ell.chunks():
            hrow = ell.heavy_row[e_lo:e_hi] - r_lo
            hval = ell.heavy_val[e_lo:e_hi]
            a_d = a_d_heavy[r_lo:r_hi].index_select(0, hrow)
            gc = comb.index_select(0, ell.heavy_col[e_lo:e_hi])
            a_s = gc[..., :H]
            g = gc[..., H:].reshape(-1, H, h)
            s = F.leaky_relu(a_d + a_s, negative_slope)
            s = torch.where((hval != 0.0)[:, None], s,
                            torch.full_like(s, -1e9))
            att = segment_softmax(s, hrow, r_hi - r_lo) * hval[:, None]
            att = _drop(gen, att, dropout, training)
            parts.append(segment_sum(g * att[..., None].to(feat.dtype),
                                     hrow, r_hi - r_lo))
    parts.append(feat.new_zeros((1, H, h)))
    stacked = torch.cat(parts).reshape(-1, H * h)
    return stacked.index_select(0, ell.inv_perm).reshape(n, H, h)
