"""GAT: multi-head edge attention over a sparse adjacency.

Counterpart of ``graphslim_tpu/models/gat.py``: two layers, ``nheads``
heads of ``nhid // nheads`` concatenated, then one head at the class
count.  Two paths, as there:

* an :class:`graphslim_tpu_torch.kernels.ell.EllAdj` (the evaluator's full
  graph) goes through :func:`attention_ell`, the row-local softmax on the
  padded buckets; at inference with heads of 16 or more, the messages and
  the source logits are rounded to bf16 (the destination logits and the
  softmax stay float32) and the result goes back to ``x``'s dtype;
* a :class:`graphslim_tpu_torch.graph.SparseAdj` goes through the
  segment softmax over its entries and a segment sum of the messages.

The JAX package composes both from XLA ops (no Pallas kernel); here they
are plain tensor ops.  A dense adjacency is refused: threshold it to a
sparse one first (``data.artifacts.sparsify``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.kernels.ell import EllAdj, attention_ell
from graphslim_tpu_torch.kernels.segment import segment_softmax, segment_sum
from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.models.base import GNNModel


class GAT(GNNModel):

    def init(self, gen):
        c = self.cfg
        h = max(c.nhid // c.nheads, 1)
        return {
            "w1": nn.glorot_uniform(gen, (c.nfeat, c.nheads * h)),
            "a1": nn.glorot_uniform(gen, (2, c.nheads, h)),
            "w2": nn.glorot_uniform(gen, (c.nheads * h, c.nclass)),
            "a2": nn.glorot_uniform(gen, (2, 1, c.nclass)),
        }

    def _attn_layer(self, x, adj, w, a, nheads, training, gen, dropout):
        n = x.shape[0]
        h = w.shape[1] // nheads
        feat = (x @ w).reshape(n, nheads, h)
        alpha_dst = torch.einsum("nhd,hd->nh", feat, a[0])
        alpha_src = torch.einsum("nhd,hd->nh", feat, a[1])
        if isinstance(adj, EllAdj):
            mfeat = feat.to(torch.bfloat16) if (not training and h >= 16) \
                else feat
            out = attention_ell(adj, alpha_dst, alpha_src, mfeat, gen=gen,
                                dropout=dropout, training=training)
            return out.reshape(n, nheads * h).to(x.dtype)
        scores = F.leaky_relu(alpha_dst.index_select(0, adj.row)
                              + alpha_src.index_select(0, adj.col), 0.2)
        att = segment_softmax(scores, adj.row, n)
        if adj.val is not None:
            att = att * adj.val[:, None]
        att = nn.dropout(gen, att, dropout, training)
        msgs = feat.index_select(0, adj.col) * att[..., None]
        return segment_sum(msgs, adj.row, n).reshape(n, nheads * h)

    def _forward(self, params, x, adj, *, training, gen):
        c = self.cfg
        if not isinstance(adj, (G.SparseAdj, EllAdj)):
            raise TypeError(
                "GAT requires a SparseAdj or EllAdj; threshold the dense "
                "synthetic adjacency first (data.artifacts.sparsify)")
        x = nn.dropout(gen, x, c.dropout, training)
        x = self._attn_layer(x, adj, params["w1"], params["a1"], c.nheads,
                             training, gen, c.dropout)
        x = nn.dropout(gen, F.elu(x), c.dropout, training)
        return self._attn_layer(x, adj, params["w2"], params["a2"], 1,
                                training, gen, c.dropout)
