"""Class-parallel distributed gradient matching.

Counterpart of ``graphslim_tpu/dist/matching.py``.  GCond's match loss is
a sum of per-class terms (``Σ_c coeff_c · match(gw_syn_c, gw_real_c)``),
so the classes shard over the mesh: every rank holds the synthetic graph
and the model replicated and computes its share of the terms.  Classes are
padded to a multiple of the world size; a padded class carries
coefficient 0 and pool count 1 (one target, node 0), so it adds nothing.

The draws do not depend on the world size: every rank samples every class
from the step's generator, exactly as the unsharded engine does
(``CondensationBase._sample_all_class_blocks``), and keeps its share.  The
loss at S = 1, 2, 4 is the unsharded loss on the same draws.

Gradients: ``torch.distributed.all_reduce`` has no autograd, and a
differentiable all-reduce on the loss would all-reduce the incoming
gradient again in its backward (S times the gradient).  Here the loss
value is summed over the ranks by a function whose backward passes the
gradient through unchanged, so each rank backpropagates its local partial
loss; the match's replicated inputs (``feat_syn`` and the normalized
synthetic adjacency, through which the PGE parameters get theirs) enter
through a function whose backward sums their gradients over the ranks
(JAX's ``psum`` under ``grad``).  Everything upstream of them then sees
the full gradient, equal bit for bit on every rank, and an engine's own
replicated terms (SGDD's generator loss) are not counted S times.  The
engine subclasses take the sharded match unchanged.

``feature_mode='sharded'`` row-shards the real feature matrix: a class
block's deep rows come through the cross-shard gather
(:mod:`graphslim_tpu_torch.dist.gather`) instead of a local take; with
``'replicated'`` the local take is the row gather kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from graphslim_tpu_torch.dist.gather import sharded_row_gather_local
from graphslim_tpu_torch.dist.mesh import axis_size
from graphslim_tpu_torch.kernels.smem_gather import gather_rows


def pad_classes(n_class: int, n_shards: int) -> int:
    return -(-n_class // n_shards) * n_shards


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the incoming gradient over the
    group (the transpose of a replicated input's broadcast)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumValue(torch.autograd.Function):
    """The value summed over the group; the backward passes the gradient
    through unchanged (each rank differentiates its own partial)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _pad_rows(t: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``t`` with ``n`` rows of ``fill`` appended along the class axis."""
    if n == 0:
        return t
    return torch.cat([t, torch.full((n,) + tuple(t.shape[1:]), fill,
                                    dtype=t.dtype, device=t.device)])


def build_sharded_match(engine, mesh, axis: str = "data",
                        feature_mode: str = "replicated"):
    """``match(model_params, feat_syn, adj_syn_norm, gen) -> loss`` with
    the classes of ``engine`` (a ``CondensationBase``) sharded over
    ``mesh``; every rank returns the total loss."""
    if feature_mode not in ("replicated", "sharded"):
        raise ValueError(f"unknown feature_mode {feature_mode!r}")
    group = mesh.get_group(axis)
    n_dev, me = axis_size(mesh, axis), mesh.get_local_rank(axis)
    C = len(engine.classes)
    Cp = pad_classes(C, n_dev)
    per = Cp // n_dev
    lo, hi = me * per, (me + 1) * per
    pad = Cp - C
    masks = _pad_rows(engine.class_masks, pad, False)[lo:hi]
    coeffs = _pad_rows(engine.coeffs, pad, 0.0)[lo:hi]

    features = engine.real.features
    n_nodes = features.shape[0]
    rows_per = -(-n_nodes // n_dev)
    if feature_mode == "sharded":
        block = features[me * rows_per:(me + 1) * rows_per]
        feats = torch.cat([block, block.new_zeros(
            (rows_per - block.shape[0], block.shape[1]))]).contiguous()
    else:
        feats = features.contiguous()

    def match(model_params: dict, feat_syn: torch.Tensor, adj_syn_norm,
              gen: torch.Generator) -> torch.Tensor:
        ids, ws, targets, valid = engine._sample_all_class_blocks(gen)
        # padded classes: one valid target (node 0), zero weights
        ids = tuple(_pad_rows(x, pad)[lo:hi] for x in ids)
        ws = tuple(_pad_rows(w, pad)[lo:hi] for w in ws)
        targets = _pad_rows(targets, pad)[lo:hi]
        slot0 = torch.zeros_like(valid[:1])
        slot0[:, 0] = True
        valid = torch.cat([valid, slot0.expand(pad, -1)])[lo:hi]
        flat = ids[0].reshape(-1)
        if feature_mode == "sharded":
            rows = sharded_row_gather_local(feats, flat, rows_per, group)
        else:
            rows = gather_rows(feats, flat)
        feat_deep = rows.reshape(per, -1, feats.shape[-1])
        fs = _SumGrads.apply(feat_syn, group)
        adj = adj_syn_norm
        if torch.is_tensor(adj) and adj.requires_grad:
            adj = _SumGrads.apply(adj, group)
        local = engine.match_classes(model_params, fs, adj, feat_deep, ids,
                                     ws, targets, valid, masks, coeffs)
        return _SumValue.apply(local, group)

    return match
