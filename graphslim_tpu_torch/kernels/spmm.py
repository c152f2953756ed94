"""Sparse × dense products (SpMM) and the sampled dense × dense (SDDMM).

Counterpart of ``graphslim_tpu/kernels/spmm.py``.  One entry point,
:func:`spmm`, behind ``SparseAdj.matmul``:

* a CUDA tensor goes to the hand-written blocked kernel
  (:mod:`graphslim_tpu_torch.kernels.spmm_blocked`) over the adjacency's
  cached blocked layout, and never to anything else;
* a CPU tensor goes to :func:`spmm_plain`, gather + sorted segment sum over
  the row-sorted COO arrays (the JAX package's ``spmm_xla``).
"""

from __future__ import annotations

from typing import Optional

import torch

from graphslim_tpu_torch.kernels.segment import segment_sum


def spmm_plain(row: torch.Tensor, col: torch.Tensor,
               val: Optional[torch.Tensor], x: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """out[r] = sum_{e: row[e] == r} val[e] * x[col[e]]."""
    gathered = x.index_select(0, col)
    if val is not None:
        gathered = gathered * val.to(gathered.dtype).unsqueeze(-1)
    return segment_sum(gathered, row, n_rows)


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` for a :class:`graphslim_tpu_torch.graph.SparseAdj`."""
    if x.device != adj.device:
        raise ValueError(f"x is on {x.device}, the adjacency on "
                         f"{adj.device}")
    if x.device.type == "cuda":
        from graphslim_tpu_torch.kernels.spmm_blocked import SpmmBlocked
        return SpmmBlocked.apply(x, adj)
    if x.device.type == "cpu":
        return spmm_plain(adj.row, adj.col, adj.val, x, adj.n_rows)
    raise ValueError(f"no SpMM path for device {x.device}")


def sddmm(row: torch.Tensor, col: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product: out[e] = <a[row[e]], b[col[e]]>."""
    return (a.index_select(0, row) * b.index_select(0, col)).sum(-1)
