"""Evaluator: train a fresh GNN on the reduced graph, test on the original.

Counterpart of ``graphslim_tpu/eval/evaluator.py`` for the eight models of
the zoo: ``evaluate`` (seeded runs), ``test`` (one run), ``grid_search``
and ``train_cross`` (the cross-architecture table).  The JAX package vmaps
the seeded runs into one program; here they run one after another, each
drawing its initial parameters through :meth:`Evaluator.init_params`.
Transductive datasets validate and test on the full graph at the split's
rows: every model but GAT through the normalized ``SparseAdj`` (on the
card, the blocked SpMM; the JAX package takes its ELL layout there), GAT
through the ELL layout its edge softmax reads.  Inductive ones validate
and test on the val and test subgraphs, every row, through their
normalized adjacencies cached on the dataset (``Dataset.split_batch``;
GAT takes the segment path on them).  ``nas_evaluate`` (the validation
metric NAS ranks by) and ``tsne_vis`` are ported; ``enable_distributed``
is not yet.
"""

from __future__ import annotations

import copy
import itertools
import logging
from typing import Optional

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.data.artifacts import sparsify
from graphslim_tpu_torch.models.hoist import hoist_batch, hoist_plan
from graphslim_tpu_torch.utils import make_generator

log = logging.getLogger("graphslim_tpu_torch")


def _dense_to_sparse(adj: torch.Tensor) -> G.SparseAdj:
    """The nonzeros of a dense ``[n, n]`` adjacency, on its device."""
    a = adj.detach().cpu().numpy()
    row, col = np.nonzero(a)
    return G.from_edge_index(np.stack([row, col]), a.shape[0],
                             edge_weight=a[row, col], dedup=False,
                             device=adj.device)


class Evaluator:
    """Evaluation agent bound to (dataset, args)."""

    # Hyperparameter grids per architecture (reference
    # ``eval_agent.py:119-145``).  As in the JAX package, an axis the
    # evaluation does not read (weight_decay: fixed at 5e-4; ntrans: 1 in
    # eval mode) leaves the result as it is.
    GRID = {
        "GCN": {"hidden": [64, 256], "lr": [0.01, 0.001],
                "weight_decay": [0.0, 5e-4]},
        "SGC": {"hidden": [64, 256], "lr": [0.01, 0.001],
                "weight_decay": [0.0, 5e-4], "ntrans": [1, 2]},
        "APPNP": {"hidden": [64, 256], "lr": [0.01, 0.001],
                  "weight_decay": [0.0, 5e-4], "alpha": [0.1, 0.2]},
        "Cheby": {"hidden": [64, 256], "lr": [0.01, 0.001],
                  "weight_decay": [0.0, 5e-4]},
        "GraphSage": {"hidden": [64, 256], "lr": [0.01, 0.001],
                      "weight_decay": [0.0, 5e-4]},
        "MLP": {"hidden": [64, 256], "lr": [0.01, 0.001],
                "weight_decay": [0.0, 5e-4]},
        "GAT": {"hidden": [64], "lr": [0.01, 0.001],
                "weight_decay": [0.0, 5e-4]},
        "SGFormer": {"trans_layers": [1, 2, 3], "lr": [0.01, 0.001],
                     "weight_decay": [1e-3, 1e-4]},
    }
    MODELS = ("MLP", "GCN", "SGC", "APPNP", "Cheby", "GraphSage", "GAT",
              "SGFormer")

    def __init__(self, data: G.Dataset, args):
        self.data = data
        self.args = args

    def _eval_model(self, model_type: str, nfeat: int):
        a = self.args
        cfg = M.ModelConfig(nfeat=nfeat, nhid=a.hidden,
                            nclass=self.data.nclass, nlayers=a.nlayers,
                            dropout=0.0,         # eval mode: dropout=0
                            alpha=a.alpha, ntrans=1,  # eval: ntrans=1
                            trans_layers=getattr(a, "trans_layers", 2),
                            activation=a.activation)
        return M.get_model(model_type, cfg)

    def _train_tuple(self, reduced: G.Reduced, model_type: str):
        """Normalized synthetic training batch on the dataset's device;
        GAT takes the nonzeros of a dense result as a ``SparseAdj``."""
        red = sparsify(reduced, model_type, self.args.method,
                       threshold=self.args.threshold)
        dev = self.data.device
        adj = red.adj
        if model_type == "GAT":
            if not isinstance(adj, G.SparseAdj):
                adj = _dense_to_sparse(red.dense_adj())
            adj_n = G.gcn_norm(adj).to(dev)
        elif adj is None:
            adj_n = None
        elif isinstance(adj, G.SparseAdj):
            adj_n = G.gcn_norm(adj).to(dev)
        else:
            adj_n = G.normalize_adj_dense(adj.to(dev))
        return red.feat.to(dev), adj_n, red.labels.to(dev)

    def _split_tuple(self, split: str, model_type: str):
        """``(x, adj, y, idx)`` of the val or test split; a transductive
        GAT reads the full graph's ELL layout."""
        batch = self.data.split_batch(split)
        if model_type == "GAT" and self.data.setting != "ind":
            return (batch[0], self.data.adj_norm_ell()) + batch[2:]
        return batch

    def init_params(self, model_type: str, model, run: int,
                    gen: torch.Generator) -> dict:
        """Initial parameters of seeded run ``run``, drawn from ``gen`` (the
        one seam through which a test hands in the JAX package's draw)."""
        return model.init(gen)

    def evaluate(self, reduced: G.Reduced, model_type: str = "GCN",
                 runs: Optional[int] = None, seed: Optional[int] = None,
                 verbose: bool = False):
        """``runs`` seeded trainings → ((mean, std), (accs, best_vals))."""
        a = self.args
        runs = runs if runs is not None else a.run_eval
        seed = seed if seed is not None else a.seed
        if reduced.n_syn == 0:
            raise ValueError(f"the reduced graph of {a.method} has no rows: "
                             "there is nothing to train on")
        model = self._eval_model(model_type, reduced.feat.shape[-1])
        tx, tadj, ty = self._train_tuple(reduced, model_type)
        val = self._split_tuple("val", model_type)
        test = self._split_tuple("test", model_type)
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
        for r in range(runs):
            params0 = self.init_params(model_type, model, r, gen)
            params, best_val, _ = M.fit_with_val(
                model, gen, train=(tx, tadj, ty, None), val=val, cfg=cfg,
                params0=params0)
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

    def test(self, reduced: G.Reduced, model_type: str = "GCN",
             seed: int = 0, verbose: bool = False) -> float:
        """One seeded evaluation run → its test metric."""
        (mean, _), _ = self.evaluate(reduced, model_type, runs=1, seed=seed,
                                     verbose=verbose)
        return mean

    def grid_search(self, reduced: G.Reduced, model_type: str,
                    param_grid: Optional[dict] = None,
                    verbose: bool = False):
        """(test (mean, std), combination) of the combination with the best
        mean validation metric over its seeded runs; the first such in the
        grid's order (keys sorted) on a tie."""
        grid = param_grid or self.GRID.get(model_type, self.GRID["GCN"])
        keys = sorted(grid)
        best_val, best_test, best_params = -1.0, (float("nan"),) * 2, None
        for combo in itertools.product(*(grid[k] for k in keys)):
            params = dict(zip(keys, combo))
            sub = copy.copy(self)
            sub.args = self.args.replace(**{
                k: v for k, v in params.items() if hasattr(self.args, k)})
            (mean, std), (_, vals) = sub.evaluate(reduced, model_type)
            val_score = float(np.mean(vals))
            if val_score > best_val:
                best_val, best_test, best_params = val_score, (mean, std), \
                    params
            if verbose:
                print(f"{model_type} {params}: {mean * 100:.2f}")
        return best_test, best_params

    def train_cross(self, reduced: G.Reduced,
                    model_types: Optional[list] = None,
                    use_grid: bool = False,
                    verbose: bool = False) -> dict:
        """``{model: (mean, std)}`` over the zoo; a model whose evaluation
        raises is logged as a warning and scores (nan, nan), as in the JAX
        package."""
        out = {}
        for mt in model_types or self.MODELS:
            try:
                if use_grid:
                    out[mt], _ = self.grid_search(reduced, mt,
                                                  verbose=verbose)
                else:
                    out[mt], _ = self.evaluate(reduced, mt,
                                               verbose=verbose)
            except Exception as e:   # GAT on an empty sparse graph etc.
                log.warning("train_cross[%s] failed: %s", mt, e)
                out[mt] = (float("nan"), float("nan"))
        return out

    def enable_distributed(self, *args, **kwargs):
        raise NotImplementedError("Evaluator.enable_distributed needs dist/ "
                                  "(ROADMAP.md, queue 1, item 14), which "
                                  "is not ported yet")

    def tsne_vis(self, reduced: G.Reduced, out_path: str,
                 max_real: int = 2000) -> str:
        """t-SNE of real train vs synthetic features, one PNG (reference
        ``eval_agent.py:404-494``): at most ``max_real`` real rows, drawn
        by ``default_rng(0)`` as in the JAX package."""
        import os

        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE

        d = self.data
        if d.setting == "ind":
            feat_tr, y_tr = d.feat_train, d.labels_train
        else:
            idx = torch.as_tensor(d.idx_train, device=d.device)
            feat_tr, y_tr = d.feat[idx], d.labels[idx]
        feat_tr, y_tr = feat_tr.cpu().numpy(), y_tr.cpu().numpy()
        if feat_tr.shape[0] > max_real:
            sel = np.random.default_rng(0).choice(
                feat_tr.shape[0], max_real, replace=False)
            feat_tr, y_tr = feat_tr[sel], y_tr[sel]
        feat_syn = reduced.feat.detach().cpu().numpy()
        y_syn = reduced.labels.detach().cpu().numpy()
        if y_syn.ndim == 2:
            y_syn = y_syn.argmax(1)
        all_data = np.concatenate([feat_tr, feat_syn])
        perplexity = min(30, max(all_data.shape[0] // 4, 2))
        pts = TSNE(n_components=2, random_state=0,
                   perplexity=perplexity).fit_transform(all_data)
        n_r = feat_tr.shape[0]
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.scatter(pts[:n_r, 0], pts[:n_r, 1], c=y_tr, cmap="tab10",
                   s=8, alpha=0.4, label="real")
        ax.scatter(pts[n_r:, 0], pts[n_r:, 1], c=y_syn, cmap="tab10",
                   s=60, marker="*", edgecolors="black", label="syn")
        ax.legend()
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path

    def nas_evaluate(self, reduced: G.Reduced, model, runs: int = 1,
                     seed: int = 0) -> float:
        """Mean best validation metric of ``model`` (an APPNP) trained on
        the reduced graph, ``runs`` seeds one after another (reference
        ``eval_agent.py:352-402``); each run's initial parameters through
        :meth:`init_params`."""
        a = self.args
        tx, tadj, ty = self._train_tuple(reduced, "APPNP")
        val = self._split_tuple("val", "APPNP")
        cfg = M.TrainConfig(epochs=a.eval_epochs, lr=a.lr or 0.01,
                            weight_decay=5e-4, metric=a.metric)
        gen = make_generator(seed, self.data.device)
        vals = []
        for r in range(runs):
            params0 = self.init_params("APPNP", model, r, gen)
            _, best_val, _ = M.fit_with_val(
                model, gen, train=(tx, tadj, ty, None), val=val, cfg=cfg,
                params0=params0)
            vals.append(best_val)
        return float(torch.stack(vals).mean())
