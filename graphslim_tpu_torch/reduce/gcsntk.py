"""GCSNTK — kernel ridge regression condensation with the SNTK.

Counterpart of ``graphslim_tpu/reduce/gcsntk.py`` (reference
``graphslim/condensation/gcsntk.py``): the synthetic features and soft
labels ``(x_s, y_s)`` are learned with Adam against the MSE of KRR
predictions on the real train nodes.  A train split of at most ``_BATCH``
rows is one batch; a larger one is partitioned by a k-means of its
features into ``⌈n_tr / _BATCH⌉`` batches.

Each batch's aggregation matrix is its block of the train subgraph, dense,
plus the identity.  The JAX package densifies the whole train subgraph and
cuts the blocks out of it, which at the arxiv twin's 135,458 train nodes
needs 73 GB; the port builds each block on the device from the sparse
subgraph's entries, with the same result.

The draws that cannot follow ``jax.random`` (the k-means's initial rows
and ``x_s, y_s ~ U(0, 1)``) come from a ``torch.Generator`` through
:meth:`GCSNTK.partition` and :meth:`GCSNTK.init_syn`.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.kmeans import kmeans
from graphslim_tpu_torch.models.sntk import SNTK, krr_forward
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

_BATCH = 3000


class GCSNTK(CondensationBase):
    with_structure = False

    def __init__(self, data, args):
        super().__init__(data, args)
        # sized by round(n_train · r), with learnable soft labels
        self.n_syn = max(round(len(data.idx_train) * args.reduction_rate),
                         data.nclass)
        self.sntk = SNTK(K=args.K, L=args.L, scale=args.scale)

    def partition(self, feat_tr: torch.Tensor, k: int) -> np.ndarray:
        """Batch of every train row: a k-means of the features into ``k``
        clusters, started from rows drawn from a generator."""
        gen = utils.make_generator(self.args.seed, feat_tr.device)
        return kmeans(feat_tr, k, gen=gen)[1].cpu().numpy()

    def init_syn(self) -> tuple:
        """Initial ``(x_s, y_s)``, both U(0, 1)."""
        gen = utils.make_generator(self.args.seed, self.data.device)
        x_s = torch.rand((self.n_syn, self.d), generator=gen,
                         device=gen.device)
        y_s = torch.rand((self.n_syn, self.nclass), generator=gen,
                         device=gen.device)
        return x_s, y_s

    def train_batches(self, data: G.Dataset) -> list:
        """``[(x_t, one-hot y_t, E_t), ...]`` over the train split, where
        ``E_t`` is the batch's dense block of the train subgraph plus the
        identity."""
        dev = data.device
        idx = np.asarray(data.idx_train)
        n_tr = idx.shape[0]
        idx_t = torch.as_tensor(idx, device=dev)
        feat_tr = data.feat[idx_t]
        onehot = torch.nn.functional.one_hot(
            data.labels[idx_t], data.nclass).to(torch.float32)
        host = data.adj_host if data.adj_host is not None \
            else G.host_of(data.adj)
        sub = G.submatrix(host, idx, device=dev)
        vals = sub.values_or_ones()
        k = -(-n_tr // _BATCH)
        assign = np.zeros(n_tr, dtype=np.int64) if k == 1 \
            else self.partition(feat_tr, k)
        assign_t = torch.as_tensor(assign, device=dev)
        same = assign_t[sub.row] == assign_t[sub.col]
        local = torch.empty(n_tr, dtype=torch.int64, device=dev)
        batches = []
        for b in range(k):
            rows = np.flatnonzero(assign == b)
            if rows.size < 2:
                continue
            rows_t = torch.as_tensor(rows, device=dev)
            local[rows_t] = torch.arange(rows.size, device=dev)
            keep = same & (assign_t[sub.row] == b)
            E = torch.eye(rows.size, dtype=torch.float32, device=dev)
            E.index_put_((local[sub.row[keep]], local[sub.col[keep]]),
                         vals[keep], accumulate=True)
            batches.append((feat_tr[rows_t], onehot[rows_t], E))
        return batches

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        batches = self.train_batches(data)
        x_s, y_s = (t.clone().requires_grad_(True) for t in self.init_syn())
        E_s = torch.eye(self.n_syn, dtype=torch.float32, device=x_s.device)
        opt = utils.Adam(args.lr or 0.01)
        state = opt.init([x_s, y_s])
        ridge = float(args.ridge)
        best_val = 0.0
        self._best_reduced = None
        loss = torch.zeros(())
        for it in range(args.epochs):
            for x_t, y_t, E_t in batches:
                with torch.enable_grad():
                    pred = krr_forward(self.sntk.nodes_gram, ridge, x_t, x_s,
                                       y_s, E_t, E_s)
                    loss = ((pred - y_t) ** 2).mean()
                    grads = torch.autograd.grad(loss, [x_s, y_s])
                opt.step([x_s, y_s], grads, state)
            if it in args.checkpoints:
                best_val = self.intermediate_evaluation(
                    x_s, None, best_val, it, loss.item(), verbose, labels=y_s)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=x_s.detach().clone(), adj=None,
                         labels=y_s.detach().clone())
