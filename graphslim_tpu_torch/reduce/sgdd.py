"""SGDD — structure-broadcast graph distillation with the IGNR graphon.

Counterpart of ``graphslim_tpu/reduce/sgdd.py`` (reference ``sgdd.py``):
GCond's gradient-matching loop with IGNR as the structure generator and a
spectral-OT regularizer against the top-left ``mx_size`` corner of the
raw adjacency, scaled by ``opt_scale``.  The path differentiates two
eigendecompositions, so it stays in float32 with TF32 off (pinned in
``graphslim_tpu_torch/__init__.py``); the JAX package forces its highest
matmul precision on the TPU for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.models.ignr import IGNR, IGNRConfig, mx_inv
from graphslim_tpu_torch.reduce.gcond import GCond


def adj_corner(host: G.HostAdj, size: int) -> np.ndarray:
    """The dense ``size × size`` top-left corner of a host adjacency
    (duplicate entries add up), without densifying the rest."""
    row, col = np.asarray(host.row), np.asarray(host.col)
    keep = (row < size) & (col < size)
    out = np.zeros((size, size), dtype=np.float32)
    np.add.at(out, (row[keep], col[keep]),
              np.asarray(host.values_or_ones())[keep])
    return out


class SGDD(GCond):
    def __init__(self, data, args):
        super().__init__(data, args)
        mx_size = min(args.mx_size, data.n_nodes)
        self.pge = IGNR(IGNRConfig(
            node_feature=self.d, nnodes=self.n_syn, nfeat=128,
            ep_ratio=args.ep_ratio, mx_size=mx_size))
        # Lx^-1 of the raw adjacency's corner (the train subgraph's in
        # the inductive setting), computed once from the host mirror's
        # entries: the JAX package densifies the whole graph first
        self.lx_inv = mx_inv(torch.as_tensor(
            adj_corner(data.train_host(), mx_size), device=data.device))

    def generator_forward(self, pge_params: dict, feat_syn: torch.Tensor):
        adj = self.pge.apply(pge_params, feat_syn)
        aux = 0.0
        if self.args.opt_scale > 0:
            aux = self.args.opt_scale * self.pge.opt_loss(
                pge_params, adj, self.lx_inv)
        return G.normalize_adj_dense(adj), aux
