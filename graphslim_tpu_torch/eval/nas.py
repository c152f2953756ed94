"""NAS evaluation: how well a reduced graph ranks architectures.

Counterpart of ``graphslim_tpu/eval/nas.py`` (reference
``graphslim/evaluation/nas_eval.py:42-233``): the 480-architecture APPNP
space (K × hidden × alpha × activation) is scored by validation accuracy
on the original and on the reduced graph; the quality signal is the
Pearson correlation of the accuracies and of their ranks across the space.
On the original graph a transductive dataset trains and validates on the
full graph through its normalized ``SparseAdj`` (the blocked SpMM on the
card; the JAX package takes its ELL layout), an inductive one trains on
the train subgraph's normalization and validates on the val subgraph's.
Every initial-parameter draw, on either graph, goes through
:meth:`NasEvaluator.init_params`.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.eval.evaluator import Evaluator
from graphslim_tpu_torch.utils import make_generator

log = logging.getLogger("graphslim_tpu_torch")

FULL_SPACE = {
    "ks": [2, 4, 6, 8, 10],
    "nhids": [16, 32, 64, 128, 256, 512],
    "alphas": [0.1, 0.2],
    "activations": ["sigmoid", "tanh", "relu", "linear", "softplus",
                    "leakyrelu", "relu6", "elu"],
}

QUICK_SPACE = {
    "ks": [2, 4],
    "nhids": [16, 64],
    "alphas": [0.1, 0.2],
    "activations": ["relu", "tanh"],
}


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / max(denom, 1e-12))


class NasEvaluator:
    def __init__(self, data: G.Dataset, args, space: dict | None = None):
        self.data = data
        self.args = args
        space = space or FULL_SPACE
        self.combos = list(itertools.product(
            space["ks"], space["nhids"], space["alphas"],
            space["activations"]))

    def init_params(self, arch: tuple, side: str, model, gen) -> dict:
        """Initial parameters of ``arch`` on the ``side`` graph ("ori" or
        "syn"), drawn from ``gen`` (the seam through which a test hands in
        the JAX package's draws)."""
        return model.init(gen)

    def _arch_val(self, params, reduced=None) -> float:
        """Validation accuracy of one APPNP architecture."""
        k, nhid, alpha, act = params
        args = self.args.replace(nlayers=k, hidden=nhid, alpha=alpha,
                                 activation=act, ntrans=2)
        cfg = M.ModelConfig(
            nfeat=self.data.n_feat if reduced is None
            else reduced.feat.shape[-1],
            nhid=nhid, nclass=self.data.nclass, nlayers=k, dropout=0.0,
            alpha=alpha, ntrans=2, activation=act)
        model = M.APPNP(cfg)
        if reduced is None:
            d = self.data
            cfg_t = M.TrainConfig(epochs=args.eval_epochs,
                                  lr=args.lr or 0.01, weight_decay=5e-4,
                                  metric=args.metric)
            gen = make_generator(args.seed, d.device)
            _, best_val, _ = M.fit_with_val(
                model, gen, train=d.split_batch("train"),
                val=d.split_batch("val"), cfg=cfg_t,
                params0=self.init_params(params, "ori", model, gen))
            return float(best_val)
        ev = Evaluator(self.data, args)
        ev.init_params = lambda mt, m, run, gen: self.init_params(
            params, "syn", m, gen)
        return ev.nas_evaluate(reduced, model, seed=args.seed)

    def evaluate_ori(self) -> np.ndarray:
        return np.array([self._arch_val(p) for p in self.combos])

    def evaluate_syn(self, reduced: G.Reduced) -> np.ndarray:
        return np.array([self._arch_val(p, reduced) for p in self.combos])

    def correlation(self, reduced: G.Reduced) -> dict:
        """Pearson correlation of the accuracies and of their ranks
        (reference ``nas_eval.py:200-233``)."""
        accs_ori = self.evaluate_ori()
        accs_syn = self.evaluate_syn(reduced)
        rank_ori = np.argsort(np.argsort(accs_ori))
        rank_syn = np.argsort(np.argsort(accs_syn))
        out = {
            "pearson_acc": pearson(accs_ori, accs_syn),
            "pearson_rank": pearson(rank_ori.astype(float),
                                    rank_syn.astype(float)),
            "best_ori": self.combos[int(np.argmax(accs_ori))],
            "best_syn": self.combos[int(np.argmax(accs_syn))],
        }
        log.info("NAS correlation: %s", out)
        return out
