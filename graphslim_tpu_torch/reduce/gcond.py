"""GCond — nested-loop gradient-matching condensation.

Counterpart of ``GCond`` in ``graphslim_tpu/reduce/gcond.py`` (reference
``gcond.py:17-81``).  Each epoch re-initializes the matching model, then
runs ``outer_loop`` steps of: PGE → match loss → one Adam step (the PGE in
epochs with ``it % 50 < 10``, the synthetic features otherwise) → the
inner loop training the model on the detached synthetic graph.  The
objective's gradient is always taken with respect to both the features
and the PGE, so every outer step runs the PGE forward twice (objective,
inner adjacency) and its backward once.

DosCond, GCondX and DosCondX are not ported yet (ROADMAP.md, queue 1,
item 5).
"""

from __future__ import annotations

import logging

import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

log = logging.getLogger("graphslim_tpu_torch")


class GCond(CondensationBase):
    """Nested-loop gradient matching; alternation ``it % 50 < 10`` → PGE
    step, else feature step."""

    def __init__(self, data, args):
        if args.resume:
            raise NotImplementedError(
                "resuming condensation is not ported yet (ROADMAP.md, "
                "queue 1, item 8: checkpoint.py)")
        super().__init__(data, args)
        self.epoch_loss_sums: list[torch.Tensor] = []

    def _epoch(self, feat_syn: torch.Tensor, pge_params: dict,
               opt_f: dict, opt_p: dict, update_pge: bool
               ) -> torch.Tensor:
        """One epoch; updates ``feat_syn`` / ``pge_params`` in place and
        returns the summed match loss (on the device)."""
        args = self.args
        mp = utils.trainable(self.model.init(self.gen))
        mp_leaves = utils.tree_leaves(mp)
        m_opt = self.opt_model.init(mp_leaves)
        pge_leaves = utils.tree_leaves(pge_params)
        losses = []
        for _ in range(args.outer_loop):
            with torch.enable_grad():
                adj_norm = self.syn_adj_norm(pge_params, feat_syn)
                loss = self.match_loss_total(mp, feat_syn, adj_norm,
                                             self.gen)
                g_f, *g_p = torch.autograd.grad(loss,
                                                [feat_syn] + pge_leaves)
            if update_pge:
                self.opt_pge.step(pge_leaves, g_p, opt_p)
            else:
                self.opt_feat.step([feat_syn], [g_f], opt_f)

            if args.inner_loop > 0:
                fs_d = feat_syn.detach()
                adj_inner = self.inner_adj(pge_params, fs_d)
                for _ in range(args.inner_loop):
                    with torch.enable_grad():
                        out = self.model.apply(mp, fs_d, adj_inner)
                        g = torch.autograd.grad(
                            utils.nll_loss(out, self.labels_syn),
                            mp_leaves)
                    self.opt_model.step(mp_leaves, g, m_opt)
            losses.append(loss.detach())
        return torch.stack(losses).sum()

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        feat_syn = self.init_feat_syn(verbose).requires_grad_(True)
        pge_params = utils.trainable(self.pge.init(self.gen))
        opt_f = self.opt_feat.init([feat_syn])
        opt_p = self.opt_pge.init(utils.tree_leaves(pge_params))

        best_val, loss_avg = 0.0, 0.0
        self._best_reduced = None
        denom = max(self.nclass * args.outer_loop, 1)
        for it in range(args.epochs):
            loss_sum = self._epoch(feat_syn, pge_params, opt_f, opt_p,
                                   update_pge=(it % 50) < 10)
            self.epoch_loss_sums.append(loss_sum)
            if it in args.checkpoints:
                loss_avg = float(loss_sum) / denom
                adj_syn = self.inference_adj(pge_params, feat_syn)
                best_val = self.intermediate_evaluation(
                    feat_syn, adj_syn, best_val, it, loss_avg, verbose)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=feat_syn.detach().clone(),
                         adj=self.inference_adj(pge_params, feat_syn),
                         labels=self.labels_syn)
