"""SimGC — condensation by teacher inversion and statistics alignment.

Counterpart of ``graphslim_tpu/reduce/simgc.py`` (reference
``graphslim/condensation/simgc.py``):

1. an SGC teacher is trained on the real graph: for cora-sized graphs the
   shallow clean one (``nlayers`` propagations, no dropout), otherwise 3
   propagations with BatchNorm and dropout 0.5, for
   ``min(1000, max(2·eval_epochs, 200))`` full-graph epochs, every
   propagation a product with the dataset's normalized adjacency (on the
   card: the blocked SpMM);
2. the per-class mean and std of ``[X, ÂX, Â²X, ...]`` over the train rows;
3. the synthetic features and the PGE are optimized against the teacher's
   NLL on the synthetic graph, the alignment of those statistics
   (× ``feat_alpha``) and the feature smoothness over the generated edges
   (× ``smoothness_alpha``); the PGE steps when ``it % 50 < 10``, the
   features otherwise.  The gradient is taken with respect to both, and
   the features' gradient passes through the PGE, so every step launches
   the PGE forward keeping the workspace and the PGE backward once each.

The smoothness term runs over 128-row blocks, each under
``torch.utils.checkpoint``, so neither the forward nor the backward holds
the ``[n, n, d]`` difference tensor whole (the JAX package maps
``jax.checkpoint``-ed blocks).
"""

from __future__ import annotations

import logging

import torch
from torch.utils.checkpoint import checkpoint

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

log = logging.getLogger("graphslim_tpu_torch")

_SMOOTH_BLOCK = 128


def _smooth_block(fr: torch.Tensor, ar: torch.Tensor,
                  fs: torch.Tensor) -> torch.Tensor:
    """Σ over a row block of ``A_ij · mean_d exp(-(x_id - x_jd)² / 2)``."""
    diff = fr[:, None, :] - fs[None, :, :]
    return (ar * torch.exp(-0.5 * diff ** 2).mean(-1)).sum()


def smoothness(fs: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Feature smoothness over the generated edges, un-normalized: row
    blocks of 128, each recomputed in the backward."""
    total = fs.new_zeros(())
    for r in range(0, fs.shape[0], _SMOOTH_BLOCK):
        total = total + checkpoint(_smooth_block, fs[r:r + _SMOOTH_BLOCK],
                                   adj[r:r + _SMOOTH_BLOCK], fs,
                                   use_reentrant=False)
    return total


class SimGC(CondensationBase):
    def train_teacher(self, data: G.Dataset, verbose: bool) -> tuple:
        """(teacher model, its params): an SGC of two transformations
        trained on the real graph (in the inductive setting the train
        subgraph, validated on the val subgraph), of the depth the graph's
        size calls for (a twin of at most 5000 nodes counts as
        cora-sized)."""
        args = self.args
        small = data.name in ("cora", "citeseer") or (
            data.name.startswith("synth") and data.n_nodes <= 5000)
        if small:
            cfg = M.ModelConfig(nfeat=self.d, nhid=args.hidden,
                                nclass=data.nclass, nlayers=args.nlayers,
                                dropout=0.0, ntrans=2)
            iters = min(10000, max(args.eval_epochs * 4, 400))
        else:
            cfg = M.ModelConfig(nfeat=self.d, nhid=args.hidden,
                                nclass=data.nclass, nlayers=3, dropout=0.5,
                                ntrans=2, with_bn=True)
            iters = min(1000, max(args.eval_epochs * 2, 200))
        teacher = M.get_model("SGC", cfg)
        params, best_val, _ = M.fit_with_val(
            teacher, utils.make_generator(args.seed, data.device),
            train=data.split_batch("train"), val=data.split_batch("val"),
            cfg=M.TrainConfig(epochs=iters, lr=args.lr_teacher,
                              weight_decay=5e-4, metric=args.metric))
        log.info("SimGC teacher val acc %.4f", float(best_val))
        return teacher, params

    def concat_stats(self, data: G.Dataset) -> tuple:
        """Per-class mean and std (ddof 1) of ``[X, ÂX, Â²X, ...]`` over
        the train rows (every row of the train subgraph in the inductive
        setting), and the class weights ``budget / max budget``."""
        norm = self.adj_norm_full
        feats = [self.real.features]
        tmp = self.real.features
        for _ in range(self.args.nlayers):
            tmp = norm.matmul(tmp)
            feats.append(tmp)
        cat = data.pool_rows(torch.cat(feats, dim=1))
        labels = data.pool_rows(self.real.labels_real)
        means, stds = [], []
        for c in self.classes:
            rows = cat[labels == c]
            means.append(rows.mean(0))
            stds.append(rows.std(0, unbiased=True) if rows.shape[0] > 1
                        else rows.new_zeros(rows.shape[1]))
        max_b = max(self.budgets.values())
        coeffs = torch.tensor([self.budgets[c] / max_b for c in self.classes],
                              dtype=torch.float32, device=data.device)
        return torch.stack(means), torch.stack(stds), coeffs

    def objective(self, teacher, t_params, stats, feat_syn: torch.Tensor,
                  pge_params: dict) -> torch.Tensor:
        """Teacher NLL + feat_alpha · alignment + smoothness_alpha ·
        smoothness, differentiable in the features and the PGE."""
        args = self.args
        means, stds, coeffs = stats
        adj = self.pge.apply(pge_params, feat_syn)
        adj = torch.where(adj < args.threshold, torch.zeros_like(adj), adj)
        smooth = smoothness(feat_syn, adj) / torch.clamp(adj.sum(),
                                                         min=1e-12)
        adj_norm = G.normalize_adj_dense(adj)
        # the synthetic hops are detached, as in the reference
        feats = [feat_syn]
        tmp = feat_syn
        for _ in range(args.nlayers):
            tmp = (adj_norm @ tmp).detach()
            feats.append(tmp)
        cat_syn = torch.cat(feats, dim=1)
        hard = utils.nll_loss(teacher.apply(t_params, feat_syn, adj_norm),
                              self.labels_syn)
        m = self.class_masks.to(cat_syn.dtype)                # [C, n]
        counts = m.sum(1)
        cnt = torch.clamp(counts, min=1.0)[:, None]
        mean_syn = (m @ cat_syn) / cnt
        ex2 = (m @ cat_syn ** 2) / cnt
        var = torch.clamp((ex2 - mean_syn ** 2) * cnt
                          / torch.clamp(cnt - 1, min=1.0), min=0.0)
        std_syn = torch.sqrt(var)
        mean_l = ((means - mean_syn) ** 2).mean(1)
        std_l = torch.where(counts > 1, ((stds - std_syn) ** 2).mean(1),
                            torch.zeros_like(counts))
        align = (coeffs * (mean_l + std_l)).sum() / coeffs.sum()
        return hard + args.feat_alpha * align + args.smoothness_alpha * smooth

    def step(self, teacher, t_params, stats, feat_syn, pge_params, opt_f,
             opt_p, update_pge: bool) -> torch.Tensor:
        """One step: the objective's gradient in both, then an Adam step
        of the PGE or of the features; returns the loss."""
        pge_leaves = utils.tree_leaves(pge_params)
        with torch.enable_grad():
            loss = self.objective(teacher, t_params, stats, feat_syn,
                                  pge_params)
            g_f, *g_p = torch.autograd.grad(loss, [feat_syn] + pge_leaves)
        if update_pge:
            self.opt_pge.step(pge_leaves, g_p, opt_p)
        else:
            self.opt_feat.step([feat_syn], [g_f], opt_f)
        return loss.detach()

    def thresholded_adj(self, pge_params, feat_syn) -> torch.Tensor:
        adj = self.pge.inference(pge_params, feat_syn)
        return torch.where(adj < self.args.threshold, torch.zeros_like(adj),
                           adj)

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        teacher, t_params = self.train_teacher(data, verbose)
        stats = self.concat_stats(data)
        feat_syn = (0.1 * torch.randn((self.n_syn, self.d),
                                      generator=self.gen,
                                      device=self.gen.device)
                    ).requires_grad_(True)
        pge_params = utils.trainable(self.pge.init(self.gen))
        opt_f = self.opt_feat.init([feat_syn])
        opt_p = self.opt_pge.init(utils.tree_leaves(pge_params))
        best_val = 0.0
        self._best_reduced = None
        self.losses = []
        for it in range(args.epochs + 1):
            loss = self.step(teacher, t_params, stats, feat_syn, pge_params,
                             opt_f, opt_p, update_pge=(it % 50) < 10)
            self.losses.append(loss)
            if it in args.checkpoints:
                best_val = self.intermediate_evaluation(
                    feat_syn, self.thresholded_adj(pge_params, feat_syn),
                    best_val, it, float(loss), verbose)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=feat_syn.detach().clone(),
                         adj=self.thresholded_adj(pge_params, feat_syn),
                         labels=self.labels_syn)
