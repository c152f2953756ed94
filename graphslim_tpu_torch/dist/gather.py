"""Cross-shard row gather: distributed feature lookup.

Counterpart of ``graphslim_tpu/dist/gather.py``.  Each rank requests
arbitrary global rows of a node-sharded matrix: the requests go around
the mesh with ``all_gather_into_tensor`` (one index a row), every owner
answers with its rows (zeros elsewhere), and ``reduce_scatter`` sums the
one-hot answers and hands each rank its own block.  Every rank requests
the same number of rows.  The owner's local ``take`` is the row gather
kernel (:mod:`graphslim_tpu_torch.kernels.smem_gather`) on the card.

Cost a call: ``S·m`` indices gathered and ``S·m·d`` floats reduced, where
``m`` is a rank's request count: independent of the node count.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from graphslim_tpu_torch.dist.mesh import all_gather, reduce_scatter
from graphslim_tpu_torch.kernels.smem_gather import gather_rows


def sharded_row_gather_local(xs: torch.Tensor, idx: torch.Tensor,
                             rows_per: int, group) -> torch.Tensor:
    """Per-rank body: global rows ``idx`` [m] of the row-sharded matrix
    whose local block (this rank's) is ``xs`` [rows_per, d] → [m, d].
    Every rank of ``group`` calls it with the same ``m``."""
    n_dev = dist.get_world_size(group)
    my = dist.get_rank(group)
    idx = idx.reshape(-1).long()
    all_idx = idx.new_empty((n_dev * idx.shape[0],))
    all_gather(all_idx, idx.contiguous(), group)
    rel = all_idx - my * rows_per
    ok = (rel >= 0) & (rel < rows_per)
    vals = gather_rows(xs.contiguous(), torch.clamp(rel, 0, rows_per - 1))
    vals = torch.where(ok.unsqueeze(-1), vals, vals.new_zeros(()))
    out = vals.new_empty((idx.shape[0], xs.shape[-1]))
    reduce_scatter(out, vals, group)
    return out


def make_sharded_row_gather(mesh, rows_per: int, axis: str = "data"):
    """``gather(x_local, idx_local) -> rows``: ``x_local`` is this rank's
    block [rows_per, d] of the row-sharded matrix, ``idx_local`` its
    requests [m]; returns this rank's rows [m, d]."""
    group = mesh.get_group(axis)

    def gather(x_local: torch.Tensor, idx_local: torch.Tensor):
        return sharded_row_gather_local(x_local, idx_local, rows_per, group)

    return gather
