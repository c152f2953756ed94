"""GCond, DosCond, GCondX, DosCondX — gradient-matching condensation.

Counterpart of ``graphslim_tpu/reduce/gcond.py`` (reference ``gcond.py``,
``doscond.py``, ``gcondx.py``, ``doscondx.py``).  Each epoch
re-initializes the matching model, then runs ``outer_loop`` steps of:
generator → match loss → Adam step(s) → the inner loop training the model
on the detached synthetic graph.  The schedule of the steps is the
``alternation``:

* ``"epoch"`` (GCond): the PGE in epochs with ``it % 50 < 10``, the
  synthetic features otherwise;
* ``"outer"`` (GCondX): the features when ``ol % 5 >= 1``;
* ``"both"`` (DosCond, DosCondX): both optimizers every outer step.

The objective's gradient is always taken with respect to the features and
the generator (the features' gradient runs through the PGE), so an outer
step runs the PGE forward keeping the workspace and its backward once
each; the inner adjacency (a no-grad forward) is built only when
``inner_loop > 0``, which DosCond and DosCondX force to 0.  GCondX and
DosCondX have no structure (identity adjacency, no PGE).

The train state is saved at every checkpoint epoch and ``--resume`` picks
it up (:mod:`graphslim_tpu_torch.checkpoint`; the port also stores its
generator's state, so a resumed run continues the uninterrupted run's
random stream).
"""

from __future__ import annotations

import logging
import os

import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.checkpoint import load_state, save_state
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

log = logging.getLogger("graphslim_tpu_torch")


class GCond(CondensationBase):
    """Nested-loop gradient matching; alternation ``it % 50 < 10`` → PGE
    step, else feature step."""

    alternation = "epoch"

    def __init__(self, data, args):
        super().__init__(data, args)
        self.epoch_loss_sums: list[torch.Tensor] = []

    def _steps(self, update_pge: bool, ol: int) -> tuple:
        """(step the generator, step the features) at outer step ``ol``."""
        if self.alternation == "epoch":
            pge = update_pge and self.with_structure
            return pge, not pge
        if self.alternation == "outer":
            return False, ol % 5 >= 1
        return self.with_structure, True

    def _epoch(self, feat_syn: torch.Tensor, pge_params: dict,
               opt_f: dict, opt_p, update_pge: bool) -> torch.Tensor:
        """One epoch; updates ``feat_syn`` / ``pge_params`` in place and
        returns the summed match loss (on the device)."""
        args = self.args
        mp = utils.trainable(self.model.init(self.gen))
        mp_leaves = utils.tree_leaves(mp)
        m_opt = self.opt_model.init(mp_leaves)
        pge_leaves = utils.tree_leaves(pge_params)
        losses = []
        for ol in range(args.outer_loop):
            with torch.enable_grad():
                adj_norm, aux = self.generator_forward(pge_params, feat_syn)
                loss = self.match_loss_total(mp, feat_syn, adj_norm,
                                             self.gen) + aux
                g_f, *g_p = torch.autograd.grad(loss,
                                                [feat_syn] + pge_leaves)
            step_pge, step_feat = self._steps(update_pge, ol)
            if step_pge:
                self.opt_pge.step(pge_leaves, g_p, opt_p)
            if step_feat:
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

    def state_path(self) -> str:
        """Where the train state goes:
        ``save_path/train_state/<method>/<dataset>_<r>_<seed>.npz``."""
        args = self.args
        return os.path.join(
            args.save_path, "train_state", args.method,
            f"{self.data.name}_{args.reduction_rate}_{args.seed}.npz")

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        feat_syn = self.init_feat_syn(verbose).requires_grad_(True)
        if self.with_structure:
            pge_params = utils.trainable(self.pge.init(self.gen))
            opt_p = self.opt_pge.init(utils.tree_leaves(pge_params))
        else:
            pge_params, opt_p = {}, None
        opt_f = self.opt_feat.init([feat_syn])

        start = 0
        if args.resume:
            state, start = load_state(
                self.state_path(),
                (feat_syn, pge_params, opt_f, opt_p, self.gen.get_state()))
            if state is not None:
                feat_syn, pge_params, opt_f, opt_p, gen_state = state
                self.gen.set_state(gen_state)
                log.info("resumed %s from epoch %d", args.method, start)

        best_val, loss_avg = 0.0, 0.0
        self._best_reduced = None
        denom = max(self.nclass * args.outer_loop, 1)
        for it in range(start, args.epochs):
            loss_sum = self._epoch(feat_syn, pge_params, opt_f, opt_p,
                                   update_pge=(it % 50) < 10)
            self.epoch_loss_sums.append(loss_sum)
            if it in args.checkpoints:
                loss_avg = float(loss_sum) / denom
                adj_syn = self.inference_adj(pge_params, feat_syn)
                best_val = self.intermediate_evaluation(
                    feat_syn, adj_syn, best_val, it, loss_avg, verbose)
                save_state(self.state_path(),
                           (feat_syn, pge_params, opt_f, opt_p,
                            self.gen.get_state()), it + 1)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=feat_syn.detach().clone(),
                         adj=self.inference_adj(pge_params, feat_syn),
                         labels=self.labels_syn)


class DosCond(GCond):
    """One-step variant: both optimizers step every outer iteration, no
    inner model training (reference ``doscond.py``)."""

    alternation = "both"

    def __init__(self, data, args):
        super().__init__(data, args.replace(inner_loop=0))


class GCondX(GCond):
    """Structure-free GCond: identity adjacency, feature steps on 4 of 5
    outer iterations (reference ``gcondx.py``)."""

    with_structure = False
    alternation = "outer"


class DosCondX(GCond):
    """Structure-free one-step variant: the feature optimizer only
    (reference ``doscondx.py``)."""

    with_structure = False
    alternation = "both"

    def __init__(self, data, args):
        super().__init__(data, args.replace(inner_loop=0))
