"""Segment reductions (scatter add/mean/max) and edge softmax.

Counterpart of ``graphslim_tpu/kernels/segment.py``: plain tensor ops
(``index_add_``, ``scatter_reduce_``), as they are XLA ops and no Pallas
kernel there.  ``num_segments`` fixes the result's first dimension.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of ``data`` rows per segment; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(total.new_ones(data.shape[0]), segment_ids,
                        num_segments).clamp_(min=1.0)
    return total / count.reshape((-1,) + (1,) * (total.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of ``data`` rows per segment; empty segments yield -inf."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    index = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(
        data)
    return out.scatter_reduce_(0, index, data, reduce="amax",
                               include_self=True)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax over entries grouped by segment."""
    seg_max = segment_max(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    exp = torch.exp(scores - seg_max[segment_ids])
    denom = segment_sum(exp, segment_ids, num_segments).clamp_(min=1e-16)
    return exp / denom[segment_ids]
