"""Evaluator: train a fresh GNN on the reduced graph, test on the original.

Counterpart of ``graphslim_tpu/eval/evaluator.py`` for SGC and GCN.  The
JAX package vmaps the seeded runs into one program; here they run one
after another.  Transductive datasets validate and test on the full graph
at the split's rows; inductive ones on the val and test subgraphs, every
row, through their normalized adjacencies cached on the dataset
(``Dataset.split_batch``).  Sparse adjacencies are passed as
``SparseAdj``, whose ``matmul`` is the SpMM dispatch.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.data.artifacts import sparsify
from graphslim_tpu_torch.models.hoist import hoist_batch, hoist_plan
from graphslim_tpu_torch.utils import make_generator

log = logging.getLogger("graphslim_tpu_torch")


class Evaluator:
    """Evaluation agent bound to (dataset, args)."""

    def __init__(self, data: G.Dataset, args):
        self.data = data
        self.args = args

    def _eval_model(self, model_type: str, nfeat: int):
        a = self.args
        cfg = M.ModelConfig(nfeat=nfeat, nhid=a.hidden,
                            nclass=self.data.nclass, nlayers=a.nlayers,
                            dropout=0.0,         # eval mode: dropout=0
                            alpha=a.alpha, ntrans=1,  # eval: ntrans=1
                            activation=a.activation)
        return M.get_model(model_type, cfg)

    def _train_tuple(self, reduced: G.Reduced, model_type: str):
        """Normalized synthetic training batch on the dataset's device."""
        if model_type == "GAT":
            raise NotImplementedError(
                "GAT is not ported yet (ROADMAP.md, queue 1, item 12)")
        red = sparsify(reduced, model_type, self.args.method,
                       threshold=self.args.threshold)
        dev = self.data.device
        adj = red.adj
        if adj is None:
            adj_n = None
        elif isinstance(adj, G.SparseAdj):
            adj_n = G.gcn_norm(adj).to(dev)
        else:
            adj_n = G.normalize_adj_dense(adj.to(dev))
        return red.feat.to(dev), adj_n, red.labels.to(dev)

    def evaluate(self, reduced: G.Reduced, model_type: str = "GCN",
                 runs: Optional[int] = None, seed: Optional[int] = None,
                 verbose: bool = False):
        """``runs`` seeded trainings → ((mean, std), (accs, best_vals))."""
        a = self.args
        runs = runs if runs is not None else a.run_eval
        seed = seed if seed is not None else a.seed
        model = self._eval_model(model_type, reduced.feat.shape[-1])
        tx, tadj, ty = self._train_tuple(reduced, model_type)
        val = self.data.split_batch("val")
        test = self.data.split_batch("test")
        # a batch of skeleton graphs (MSGC) is not hoisted, as in the JAX
        # package
        plan = None if M.is_skeleton_batch(tadj) else hoist_plan(model)
        if plan is not None:
            model, hops, keep = plan
            tx, tadj, ty, _ = hoist_batch((tx, tadj, ty, None), hops, keep)
            val = hoist_batch(val, hops, keep)
            test = hoist_batch(test, hops, keep)
        cfg = M.TrainConfig(epochs=a.eval_epochs, lr=a.lr or 0.01,
                            weight_decay=5e-4, metric=a.metric)
        gen = make_generator(seed, self.data.device)
        accs, best_vals = [], []
        for _ in range(runs):
            params, best_val, _ = M.fit_with_val(
                model, gen, train=(tx, tadj, ty, None), val=val, cfg=cfg)
            accs.append(M.evaluate(model, params, *test, metric=a.metric))
            best_vals.append(best_val)
        accs = torch.stack(accs).cpu().numpy()
        best_vals = torch.stack(best_vals).cpu().numpy()
        mean, std = float(accs.mean()), float(accs.std())
        log.info("eval[%s] %d runs: %.4f ± %.4f", model_type, runs, mean,
                 std)
        if verbose:
            print(f"eval[{model_type}] {runs} runs: "
                  f"{mean * 100:.2f} ± {std * 100:.2f}")
        return (mean, std), (accs, best_vals)
