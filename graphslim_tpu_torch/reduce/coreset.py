"""Coreset selection: Random (the init GCond uses).

Counterpart of ``Random`` in ``graphslim_tpu/reduce/coreset.py``; the
selection is NumPy-seeded exactly as there, so both packages pick the same
nodes.  The other coresets are not ported yet (ROADMAP.md, queue 1,
item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.reduce.base import Reducer, class_budgets


class CoreSetBase(Reducer):
    """Shared: budgets, per-class dispatch, induced-subgraph assembly."""

    def __init__(self, data, args, labels_syn_override=None):
        super().__init__(data, args)
        if args.agg:
            raise NotImplementedError(
                "aggregated-feature coresets are not ported yet "
                "(ROADMAP.md, queue 1, item 10)")
        labels_pool = data.labels_for_reduction()
        if labels_syn_override is not None:
            # condensation init: sizes come from the caller's label budget
            ls = np.asarray(labels_syn_override)
            classes, counts = np.unique(ls, return_counts=True)
            self.budgets = dict(zip(classes.tolist(), counts.tolist()))
            self.labels_syn = ls
            self.labels_syn_override = ls
        else:
            self.budgets, self.labels_syn, _ = class_budgets(
                labels_pool, args.reduction_rate)
            self.labels_syn_override = None
        self.labels_pool = labels_pool
        self.pool_idx = np.asarray(data.idx_train)

    def select_class(self, feats: torch.Tensor, cnt: int,
                     pool_global: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        selected_by_class = {}
        for c, cnt in self.budgets.items():
            pool_c = self.pool_idx[self.labels_pool == c]
            cnt = min(int(cnt), len(pool_c))
            feats_c = data.feat[torch.as_tensor(pool_c, device=data.device)]
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
        host = data.adj_host if data.adj_host is not None \
            else G.host_of(data.adj)
        return G.Reduced(feat=data.feat[idx_t],
                         adj=G.submatrix(host, idx_selected,
                                         device=data.device),
                         labels=data.labels[idx_t])


class Random(CoreSetBase):
    """Per-class random permutation (reference ``random.py:6-17``)."""

    def select_class(self, feats, cnt, pool_global):
        rng = np.random.default_rng(self.args.seed + len(pool_global))
        return rng.permutation(len(pool_global))[:cnt]
