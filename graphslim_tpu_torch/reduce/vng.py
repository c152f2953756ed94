"""VNG — Virtual Node Graph coarsening ("Serving Graph Compression for
GNNs").

Counterpart of ``graphslim_tpu/reduce/vng.py``: train a GNN on the full
graph, concatenate its per-layer embeddings of the training nodes, cluster
them by degree-weighted k-means, and build the propagation-preserving
virtual adjacency ``A_vr = (E A X_head) pinv(E X_head)`` through an SVD.

The math is the JAX package's; the association is not.  It builds the
training subgraph's adjacency and the membership matrix ``E`` as dense
matrices ([n_tr, n_tr] and [n_syn, n_tr]); here ``A_tr @ X_head`` is a
product with the training subgraph's SparseAdj (on the card: the blocked
SpMM) and every product with ``E`` is a segment sum over the cluster
assignment, so nothing of size n_tr² or n_syn·n_tr is ever formed.
"""

from __future__ import annotations

import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.kmeans import kmeans, random_rows
from graphslim_tpu_torch.kernels.segment import segment_sum
from graphslim_tpu_torch.reduce.base import Reducer

# The seed of the k-means draw, fixed as in the JAX package
# (``jax.random.key(2024)``).
KMEANS_SEED = 2024


def membership_product(assign: torch.Tensor, col_sum: torch.Tensor,
                       n_syn: int, y: torch.Tensor) -> torch.Tensor:
    """``E @ y`` for the degree-weighted, row-normalized membership ``E``
    (``E[assign[i], i] = col_sum[i]``, rows scaled to sum 1; an empty row
    stays 0), as a segment sum over ``assign``."""
    row_sums = segment_sum(col_sum, assign, n_syn)
    row_sums = torch.where(row_sums == 0, torch.ones_like(row_sums),
                           row_sums)
    return segment_sum(y * col_sum[:, None], assign, n_syn) \
        / row_sums[:, None]


def virtual_graph(x_head: torch.Tensor, assign: torch.Tensor,
                  col_sum: torch.Tensor, feat0: torch.Tensor,
                  adj_tr: G.SparseAdj, y_train: torch.Tensor, n_syn: int,
                  nclass: int) -> tuple:
    """``(x_vr, A_vr, labels_syn)`` from the clustering of the training
    nodes: ``x_vr = E X``, ``A_vr = (E A_tr X_head) pinv(E X_head)`` with
    singular values at or below 1e-8 dropped, and each virtual node's
    label the majority label of its members (the first class among ties;
    class 0 for an empty cluster)."""
    x_vr = membership_product(assign, col_sum, n_syn, feat0)
    P = membership_product(assign, col_sum, n_syn, x_head)
    Q = membership_product(assign, col_sum, n_syn, adj_tr.matmul(x_head))
    U, S, Vh = torch.linalg.svd(P, full_matrices=False)
    s_inv = torch.where(S > 1e-8, 1.0 / torch.clamp(S, min=1e-12),
                        torch.zeros_like(S))
    a_vr = ((Q @ Vh.T) * s_inv[None, :]) @ U.T
    onehot = torch.nn.functional.one_hot(y_train, nclass).to(x_head.dtype)
    counts = segment_sum(onehot, assign, n_syn)
    return x_vr, a_vr, torch.argmax(counts, dim=1)


class VNG(Reducer):
    def __init__(self, data, args, labels_syn_override=None):
        super().__init__(data, args)

    def init_rows(self, n: int, k: int, gen: torch.Generator
                  ) -> torch.Tensor:
        """The ``k`` distinct rows that start the k-means."""
        return random_rows(n, k, gen)

    @torch.no_grad()
    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        dev = data.device
        model = M.get_model(args.condense_model, M.ModelConfig(
            nfeat=data.n_feat, nhid=args.hidden, nclass=data.nclass,
            nlayers=args.nlayers, dropout=0.0))
        norm = data.adj_norm()
        idx = torch.as_tensor(data.idx_train, device=dev)
        vidx = torch.as_tensor(data.idx_val, device=dev)
        y_train = data.labels[idx]
        params, _, _ = M.fit_with_val(
            model, utils.make_generator(args.seed, dev),
            train=(data.feat, norm, y_train, idx),
            val=(data.feat, norm, data.labels[vidx], vidx),
            cfg=M.TrainConfig(epochs=args.eval_epochs, lr=args.lr or 0.01,
                              weight_decay=5e-4, metric=args.metric))
        x_head = torch.cat([e[idx] for e in model.layer_features(
            params, data.feat, norm)], dim=1)

        # degree-weighted k-means over the concatenated embeddings
        host = data.adj_host if data.adj_host is not None \
            else G.host_of(data.adj)
        adj_tr = G.submatrix(host, data.idx_train, device=dev)
        n_tr = x_head.shape[0]
        col_sum = adj_tr.rmatmul(x_head.new_ones((n_tr, 1)), n_tr)[:, 0]
        col_sum = torch.where(col_sum == 0, torch.ones_like(col_sum),
                              col_sum)
        n_syn = max(int(args.reduction_rate * n_tr), data.nclass)
        gen = utils.make_generator(KMEANS_SEED, dev)
        init = x_head[self.init_rows(n_tr, n_syn, gen)]
        _, assign = kmeans(x_head, n_syn, weights=col_sum, init=init)
        x_vr, a_vr, labels_syn = virtual_graph(
            x_head, assign, col_sum, data.feat[idx], adj_tr, y_train,
            n_syn, data.nclass)
        return G.Reduced(feat=x_vr, adj=a_vr, labels=labels_syn)
