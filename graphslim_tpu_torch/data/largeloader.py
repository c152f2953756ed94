"""Large-graph batch loader: k-means-partitioned train batches.

Counterpart of ``graphslim_tpu/data/largeloader.py`` (reference
``LargeDataLoader``, ``dataset/loader.py:232-372``): the train rows'
features z-scored, an optional ``gcf_hops``-round GCF pre-filter
``x ← 0.5·x + 0.5·Â x`` (on the card: the blocked SpMM), a k-means
partition of the rows into batches of about ``batch_size``, and
``get_batch(i)`` returning ``(feat, labels, dense sub-adjacency + I)``.
The k-means is the port's (:mod:`graphslim_tpu_torch.kernels.kmeans`);
its initial rows come from :meth:`LargeDataLoader.init_rows`, drawn from a
``torch.Generator`` (the JAX package draws them from its key).
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.kernels.kmeans import kmeans, random_rows
from graphslim_tpu_torch.utils import make_generator


class LargeDataLoader:
    def __init__(self, data: G.Dataset, batch_size: int = 3000,
                 split_method: str = "kmeans", gcf_hops: int = 0,
                 seed: int = 0):
        dev = data.device
        if data.setting == "ind":
            feat = data.feat_train
            labels = data.labels_train.cpu().numpy()
            adj = data.adj_train
        else:
            rows = torch.as_tensor(data.idx_train, device=dev)
            feat = data.feat[rows]
            labels = data.labels.cpu().numpy()[data.idx_train]
            adj = G.submatrix(G.host_of(data.adj), data.idx_train,
                              device=dev)
        feat = G.standardize(feat)
        if gcf_hops > 0:
            # GCF pre-filter: hops of (I + Â)/2 smoothing
            norm = G.gcn_norm(adj)
            for _ in range(gcf_hops):
                feat = 0.5 * feat + 0.5 * norm.matmul(feat)
        self.feat = feat
        self.labels = labels
        self.adj = adj
        n = feat.shape[0]
        self.n_batch = max(-(-n // batch_size), 1)
        if split_method == "kmeans" and self.n_batch > 1:
            gen = make_generator(seed, dev)
            init = feat[self.init_rows(n, self.n_batch, gen)]
            _, assign = kmeans(feat, self.n_batch, init=init)
            assign = assign.cpu().numpy()
        else:
            assign = np.arange(n) % self.n_batch
        self.batches = [np.flatnonzero(assign == b)
                        for b in range(self.n_batch)]
        self.batches = [b for b in self.batches if b.size > 1]
        self.n_batch = len(self.batches)

    def init_rows(self, n: int, k: int, gen: torch.Generator
                  ) -> torch.Tensor:
        """The ``k`` distinct rows that start the k-means."""
        return random_rows(n, k, gen)

    def properties(self):
        n, d = self.feat.shape
        nclass = int(self.labels.max()) + 1
        return self.n_batch, n, nclass, d, n

    def get_batch(self, i: int):
        rows = self.batches[i]
        dev = self.feat.device
        sub = G.submatrix(G.host_of(self.adj), rows, device=dev)
        dense = sub.to_dense() + torch.eye(rows.shape[0], device=dev)
        return (self.feat[torch.as_tensor(rows, device=dev)],
                torch.as_tensor(self.labels[rows].astype(np.int64),
                                device=dev), dense)
