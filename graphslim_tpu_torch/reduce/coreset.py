"""Coreset selection: Random / KCenter / Herding / CentD / CentP (+agg).

Counterpart of ``graphslim_tpu/reduce/coreset.py``: model-based variants
select on the embeddings of a GCN trained on the whole graph, model-free
ones on raw or ``Â(ÂX)``-aggregated features, the centrality ones on degree
or PageRank.  In the inductive setting all of it runs on the train
subgraph, whose local ids the pools and the selection hold.  Random's
selection is NumPy-seeded exactly as there, so both packages pick the
same nodes.

The greedy loops (k-center farthest point, herding mean matching) are
Python loops over device tensors, the JAX package's ``lax.fori_loop``s step
for step; ``argmax``/``argmin`` take the first index among ties, as there.
Every full-graph product goes through ``SparseAdj.matmul`` (on the card:
the blocked SpMM kernel), and the rows a class selects on are gathered by
:func:`graphslim_tpu_torch.kernels.smem_gather.gather_rows`.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.segment import segment_sum
from graphslim_tpu_torch.kernels.smem_gather import gather_rows
from graphslim_tpu_torch.reduce.base import (Reducer, budgets_of,
                                             class_budgets)


# ---------------------------------------------------------------------------
# Device-side greedy selection
# ---------------------------------------------------------------------------

def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum (``torch.argmax`` leaves the choice
    among ties open), without a read-back to the host."""
    index = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.max(), index, x.shape[0]).min()


@torch.no_grad()
def kcenter_select(feats: torch.Tensor, cnt: int) -> torch.Tensor:
    """Greedy farthest point: start at the point closest to the class mean,
    then repeatedly add the argmax of the min-distance to the centers."""
    n = feats.shape[0]
    mean = feats.mean(dim=0, keepdim=True)
    first = _first_argmax(-utils.cdist(feats, mean)[:, 0])
    selected = torch.zeros(cnt, dtype=torch.int64, device=feats.device)
    selected[0] = first
    taken = torch.zeros(n, dtype=torch.bool, device=feats.device)
    taken[first] = True
    min_dist = utils.cdist(feats, feats[first][None, :])[:, 0]
    neg_inf = torch.full_like(min_dist, float("-inf"))
    for i in range(1, cnt):
        nxt = _first_argmax(torch.where(taken, neg_inf, min_dist))
        selected[i] = nxt
        taken[nxt] = True
        d = utils.cdist(feats, feats[nxt][None, :])[:, 0]
        min_dist = torch.minimum(min_dist, d)
    return selected


@torch.no_grad()
def herding_select(feats: torch.Tensor, cnt: int) -> torch.Tensor:
    """Greedy mean matching: pick argmin ‖(i+1)·μ − Σ selected − x‖."""
    n = feats.shape[0]
    mean = feats.mean(dim=0)
    selected = torch.zeros(cnt, dtype=torch.int64, device=feats.device)
    taken = torch.zeros(n, dtype=torch.bool, device=feats.device)
    acc = torch.zeros_like(mean)
    for i in range(cnt):
        det = mean * (i + 1.0) - acc
        dist = torch.linalg.norm(feats - det[None, :], dim=1)
        dist = torch.where(taken, torch.full_like(dist, float("inf")), dist)
        nxt = _first_argmax(-dist)
        selected[i] = nxt
        taken[nxt] = True
        acc = acc + feats[nxt]
    return selected


@torch.no_grad()
def pagerank(adj: G.SparseAdj, max_iter: int = 100,
             damping: float = 0.85) -> torch.Tensor:
    """Power-iteration PageRank on the adjacency's device."""
    n = adj.n_rows
    out_deg = torch.clamp(adj.sum_rows(), min=1.0)
    pr = torch.full((n,), 1.0 / n, dtype=torch.float32, device=adj.device)
    base = (1.0 - damping) / n
    val = adj.values_or_ones()
    for _ in range(max_iter):
        # transition^T @ pr: edge (r→c) carries pr[r]/deg[r] to c
        contrib = pr / out_deg
        agg = segment_sum(contrib[adj.row] * val, adj.col, n)
        pr = damping * agg + base
    return pr


# ---------------------------------------------------------------------------
# Coreset reducers
# ---------------------------------------------------------------------------

class CoreSetBase(Reducer):
    """Shared: budgets, per-class dispatch, induced-subgraph assembly."""

    needs_model = False   # model-based variants train a GCN first
    use_agg = False       # aggregated-feature (Â²X) variants

    def __init__(self, data, args, labels_syn_override=None):
        super().__init__(data, args)
        labels_pool = data.labels_for_reduction()
        if labels_syn_override is not None:
            # condensation init: sizes come from the caller's label budget
            ls = np.asarray(labels_syn_override)
            self.budgets = budgets_of(ls)
            self.labels_syn = ls
            self.labels_syn_override = ls
        else:
            self.budgets, self.labels_syn, _ = class_budgets(
                labels_pool, args.reduction_rate)
            self.labels_syn_override = None
        self.labels_pool = labels_pool
        # pool = the train split: global ids, or local ids of the train
        # subgraph in the inductive setting
        self.pool_idx = data.pool_ids()
        # the GCN of the model-based variants and its best validation
        # accuracy, kept for inspection
        self.embed_model = None

    def select_class(self, feats: torch.Tensor, cnt: int,
                     pool_global: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _embeddings(self, data: G.Dataset, verbose: bool) -> torch.Tensor:
        """Features to select on: raw, aggregated, or GCN embeddings, over
        the graph reducers consume.  The normalized adjacency is the
        dataset's cached one, so its blocked layout is built once and
        shared with the evaluator.  In the inductive setting the GCN
        trains on the train subgraph and validates on that same graph, as
        the JAX package does."""
        feat, _, labels = data.train_graph()
        norm = data.train_norm()
        if self.needs_model:
            cfg = M.ModelConfig(nfeat=data.n_feat, nhid=self.args.hidden,
                                nclass=data.nclass, nlayers=2, dropout=0.0)
            model = M.get_model("GCN", cfg)
            train = data.split_batch("train")
            val = train if data.setting == "ind" \
                else data.split_batch("val")
            params, best_val, _ = M.fit_with_val(
                model, utils.make_generator(self.args.seed, data.device),
                train=train, val=val,
                cfg=M.TrainConfig(epochs=self.args.eval_epochs,
                                  lr=self.args.lr or 0.01,
                                  weight_decay=5e-4,
                                  metric=self.args.metric))
            self.embed_model = (model, params, norm, best_val)
            with torch.no_grad():
                return model.apply(params, feat, norm)
        if self.use_agg:
            return norm.matmul(norm.matmul(feat))
        return feat

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        embeds = self._embeddings(data, verbose)
        selected_by_class = {}
        for c, cnt in self.budgets.items():
            pool_c = self.pool_idx[self.labels_pool == c]
            cnt = min(int(cnt), len(pool_c))
            feats_c = gather_rows(
                embeds, torch.as_tensor(pool_c, device=data.device))
            local = self.select_class(feats_c, cnt, pool_c)
            selected_by_class[c] = pool_c[np.asarray(local)][:cnt]
        if self.labels_syn_override is not None:
            # position-aligned with the imposed labels; short classes are
            # padded by repetition
            ls = self.labels_syn_override
            idx_selected = np.zeros(ls.shape[0], dtype=np.int64)
            for c, sel in selected_by_class.items():
                pos = np.flatnonzero(ls == c)
                reps = -(-len(pos) // max(len(sel), 1))
                idx_selected[pos] = np.tile(sel, reps)[: len(pos)]
        else:
            idx_selected = np.concatenate(list(selected_by_class.values()))
        idx_t = torch.as_tensor(idx_selected, device=data.device)
        feat, _, labels = data.train_graph()
        if self.use_agg:
            # aggregated variants keep Â²X features, identity structure
            return G.Reduced(feat=gather_rows(embeds, idx_t), adj=None,
                             labels=labels[idx_t])
        return G.Reduced(feat=gather_rows(feat, idx_t),
                         adj=G.submatrix(data.train_host(), idx_selected,
                                         device=data.device),
                         labels=labels[idx_t])


class Random(CoreSetBase):
    """Per-class random permutation (reference ``random.py:6-17``)."""

    def select_class(self, feats, cnt, pool_global):
        rng = np.random.default_rng(self.args.seed + len(pool_global))
        return rng.permutation(len(pool_global))[:cnt]


class RandomAgg(Random):
    use_agg = True


class KCenter(CoreSetBase):
    needs_model = True

    def select_class(self, feats, cnt, pool_global):
        return kcenter_select(feats, int(cnt)).cpu().numpy()


class KCenterAgg(KCenter):
    needs_model = False
    use_agg = True


class Herding(CoreSetBase):
    needs_model = True

    def select_class(self, feats, cnt, pool_global):
        return herding_select(feats, int(cnt)).cpu().numpy()


class HerdingAgg(Herding):
    needs_model = False
    use_agg = True


class CentD(CoreSetBase):
    """Top-k degree per class (reference ``cent_degree.py:6-27``)."""

    def _reduce(self, data, verbose):
        self._deg = data.train_graph()[1].sum_rows().cpu().numpy()
        return super()._reduce(data, verbose)

    def select_class(self, feats, cnt, pool_global):
        return np.argsort(self._deg[pool_global])[-cnt:]


class CentP(CoreSetBase):
    """Top-k PageRank per class (reference ``cent_pagerank.py:8-55``)."""

    def _reduce(self, data, verbose):
        self._pr = pagerank(data.train_graph()[1]).cpu().numpy()
        return super()._reduce(data, verbose)

    def select_class(self, feats, cnt, pool_global):
        return np.argsort(self._pr[pool_global])[-cnt:]
