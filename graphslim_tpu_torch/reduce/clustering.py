"""Structure-free coarsening: Cluster / ClusterAgg / Average.

Counterpart of ``graphslim_tpu/reduce/clustering.py``: per-class k-means
centroids (:func:`graphslim_tpu_torch.kernels.kmeans.kmeans`) or per-class
means of the training features, with the identity adjacency.  These double
as the initializers of the condensation methods (``--init clustering`` or
``averaging``), so they take an imposed label budget through
``labels_syn_override``.

ClusterAgg clusters the ``Â²X``-aggregated features: two products with the
dataset's cached normalized adjacency (on the card: two blocked-SpMM
launches at the feature width; the train subgraph's in the inductive
setting).  The initial centroid rows of each class
come from :meth:`Cluster.init_rows`, drawn from a ``torch.Generator``
seeded with ``args.seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.kmeans import kmeans, random_rows
from graphslim_tpu_torch.reduce.base import (Reducer, budgets_of,
                                             class_budgets)


def tile_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of ``x`` repeated in order until there are ``n``."""
    reps = -(-n // x.shape[0])
    return x.repeat(reps, 1)[:n]


class Cluster(Reducer):
    use_agg = False

    def __init__(self, data, args, labels_syn_override=None):
        super().__init__(data, args)
        if labels_syn_override is not None:
            self.labels_syn = np.asarray(labels_syn_override)
            self.budgets = budgets_of(self.labels_syn)
        else:
            self.budgets, self.labels_syn, _ = class_budgets(
                data.labels_for_reduction(), args.reduction_rate)

    def init_rows(self, c: int, n: int, k: int,
                  gen: torch.Generator) -> torch.Tensor:
        """The ``k`` distinct rows (of class ``c``'s ``n``) that start its
        k-means."""
        return random_rows(n, k, gen)

    def _train_feats(self, data: G.Dataset) -> torch.Tensor:
        """The training rows of ``X``, or of ``Â²X`` for the agg variant
        (the train subgraph's, every row, in the inductive setting)."""
        feat = data.train_graph()[0]
        if self.use_agg:
            norm = data.train_norm()
            feat = norm.matmul(norm.matmul(feat))
        return data.pool_rows(feat)

    def _class_feat(self, c: int, x_c: torch.Tensor, n_c: int,
                    gen: torch.Generator) -> torch.Tensor:
        if x_c.shape[0] <= n_c:
            return tile_rows(x_c, n_c)
        init = x_c[self.init_rows(c, x_c.shape[0], n_c, gen)]
        centroids, _ = kmeans(x_c, n_c, init=init)
        return centroids

    @torch.no_grad()
    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        feat = self._train_feats(data)
        labels = data.labels_for_reduction()
        labels_syn = np.asarray(self.labels_syn)
        x_syn = feat.new_zeros((labels_syn.shape[0], feat.shape[1]))
        gen = utils.make_generator(self.args.seed, data.device)
        for c, n_c in self.budgets.items():
            rows = torch.as_tensor(np.flatnonzero(labels == c),
                                   device=data.device)
            out = torch.as_tensor(np.flatnonzero(labels_syn == c),
                                  device=data.device)
            x_syn[out] = self._class_feat(c, feat[rows], int(n_c), gen)
        return G.Reduced(feat=x_syn, adj=None, labels=torch.as_tensor(
            labels_syn.astype(np.int64), device=data.device))


class ClusterAgg(Cluster):
    """K-means on ``Â²X``-aggregated features."""

    use_agg = True


class Average(Cluster):
    """Per-class feature mean replicated to the class budget."""

    def _class_feat(self, c, x_c, n_c, gen):
        return x_c.mean(dim=0, keepdim=True).repeat(n_c, 1)
