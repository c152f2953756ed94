"""On-device fixed-fanout neighbourhood sampling.

Counterpart of ``graphslim_tpu/kernels/sample.py`` (composed of tensor ops
there too, not a Pallas kernel).  The semantics are the JAX package's:

* each hop samples exactly ``fanout`` neighbours per target (uniform with
  replacement when ``deg > fanout``; all neighbours plus zero-weight
  padding when ``deg <= fanout``) plus one self slot, last;
* sampled slots are rescaled by ``deg/fanout``, so the block aggregation is
  an unbiased estimator of the full normalized aggregation, and equals it
  exactly at ``fanout >= max_deg``;
* the sources of a target occupy contiguous slots, so aggregation is a
  reshape + weighted sum.

The random offsets are ``floor(u · deg)`` with ``u`` from a
``torch.Generator`` on the device; they differ from the JAX package's
``rbg`` draws, so parity is structural and statistical.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class BlockSample(NamedTuple):
    """Multi-hop sampled computation tree.

    ``node_ids[0]`` is the deepest (feature-gather) level, ``node_ids[-1]``
    the targets.  ``weights[k]`` maps level ``k`` sources to level ``k+1``
    targets: shape ``[..., m_{k+1}, fanout_k + 1]``, slot ``fanout_k`` is
    the self loop.
    """

    node_ids: tuple
    weights: tuple

    @property
    def num_layers(self) -> int:
        return len(self.weights)


class PackedCsr(NamedTuple):
    """Gather-friendly CSR layout: ``edge`` [nnz, 2] f32 holds
    (col bits, val), so one row gather fetches an edge; ``node`` [n, 4] f32
    holds (start bits, end bits, self value, 0), so one row gather serves
    the degree lookup and the self-loop weight."""

    edge: torch.Tensor
    node: torch.Tensor


def build_packed_csr(indptr, indices, values, self_values,
                     device) -> PackedCsr:
    """Host-side (NumPy) build of :class:`PackedCsr`, moved to ``device``."""
    indptr = np.asarray(indptr).astype(np.int32)
    col = np.asarray(indices).astype(np.int32)
    val = np.asarray(values).astype(np.float32)
    sv = np.asarray(self_values).astype(np.float32)
    edge = np.stack([col.view(np.float32), val], axis=1)
    node = np.zeros((indptr.shape[0] - 1, 4), dtype=np.float32)
    node[:, 0] = indptr[:-1].view(np.float32)
    node[:, 1] = indptr[1:].view(np.float32)
    node[:, 2] = sv
    return PackedCsr(edge=torch.as_tensor(edge, device=device),
                     node=torch.as_tensor(node, device=device))


def packed_csr_of_norm(norm, device) -> PackedCsr:
    """:class:`PackedCsr` of a normalized host adjacency
    (``graph.HostAdj``): its off-diagonal entries in row order, its
    diagonal as the self values."""
    row, col, val = norm.row, norm.col, norm.val
    diag = row == col
    n = norm.n_rows
    self_vals = np.zeros(n, dtype=np.float32)
    self_vals[row[diag]] = val[diag]
    ro, co, vo = row[~diag], col[~diag], val[~diag]
    order = np.argsort(ro, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(ro, minlength=n), out=indptr[1:])
    return build_packed_csr(indptr, co[order], vo[order], self_vals, device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64)


def _sample_one_hop(gen: torch.Generator, tables: PackedCsr,
                    targets: torch.Tensor, fanout: int):
    """``fanout`` neighbours (+self) per target → ``(src [n_t, f+1],
    weights [n_t, f+1])``; padded slots have weight 0 and point at the
    target itself."""
    n_t = targets.shape[0]
    se = tables.node[targets]                                    # [n_t, 4]
    start = _bits(se[:, 0])
    deg = _bits(se[:, 1]) - start
    self_w = se[:, 2]

    slot = torch.arange(fanout, device=targets.device)[None, :]
    u = torch.rand((n_t, fanout), generator=gen, device=targets.device)
    rand = torch.floor(u * torch.clamp(deg, min=1)[:, None]).to(torch.int64)
    offset = torch.where(deg[:, None] <= fanout, slot, rand)
    edge_pos = start[:, None] + torch.minimum(
        offset, torch.clamp(deg - 1, min=0)[:, None])
    valid = slot < deg[:, None]

    rows = tables.edge[edge_pos.reshape(-1)].reshape(n_t, fanout, 2)
    src = _bits(rows[:, :, 0])
    w = rows[:, :, 1] * valid.to(rows.dtype)
    scale = torch.where(deg > fanout, deg.to(w.dtype) / fanout,
                        torch.ones_like(w[:, 0]))
    w = w * scale[:, None]
    src = torch.where(valid, src, targets[:, None])
    src = torch.cat([src, targets[:, None]], dim=1)
    w = torch.cat([w, self_w[:, None]], dim=1)
    return src, w


def neighbor_sample_block(gen: torch.Generator, tables: PackedCsr,
                          targets: torch.Tensor,
                          fanouts: Sequence[int]) -> BlockSample:
    """Sample an L-hop computation tree for ``targets``; ``fanouts`` is
    ordered near-to-deep."""
    frontier = targets.to(torch.int64)
    node_ids = [frontier]
    weights = []
    for fanout in fanouts:
        src, w = _sample_one_hop(gen, tables, frontier, int(fanout))
        weights.append(w)
        frontier = src.reshape(-1)
        node_ids.append(frontier)
    return BlockSample(node_ids=tuple(reversed(node_ids)),
                       weights=tuple(reversed(weights)))
