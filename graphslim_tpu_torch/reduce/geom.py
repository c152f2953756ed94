"""GEOM — curriculum trajectory matching with soft labels.

Counterpart of ``graphslim_tpu/reduce/geom.py`` (reference
``graphslim/condensation/geom.py``), on SFGC's machinery:

* **The curriculum buffer.**  The train rows are ordered easiest to
  hardest by the entropy of their neighbours' labels (on the host, with
  ``np.add.at``), and each expert trains for ``teacher_epochs + 1`` epochs
  on the growing prefix that :func:`training_scheduler` allows at that
  epoch (a mask over the ordered rows inside each epoch); cached as
  ``save_path/geom_buffer/<dataset>_<attack>_0.25_<seed>.npz``.
* **The alignment.**  Starts are drawn from a window that widens with the
  step, ``[min_start_epoch, min(max_start_epoch_s + it,
  max_start_epoch))``; the target is the fixed ``expert_epochs // 10``
  snapshot; the loss is ``‖θ_T − θ*‖ / ‖θ_0 − θ*‖``, plus β times the KL of
  the last snapshot's output from the soft labels when ``beta > 0``.
* **Soft labels** (``soft_label``) start from the first expert's last
  logits with the true class raised to the row's maximum, are learned with
  SGD(``lr_y``, momentum 0.9), and make the student's loss the log-target
  KL.  The artifacts carry ``softmax`` of them.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.reduce.sfgc import SFGC

log = logging.getLogger("graphslim_tpu_torch")


def kl_log_target(log_input: torch.Tensor, log_target: torch.Tensor
                  ) -> torch.Tensor:
    """``torch.nn.KLDivLoss(reduction='batchmean', log_target=True)``."""
    return (torch.exp(log_target) * (log_target - log_input)).sum() \
        / log_input.shape[0]


def training_scheduler(lam: float, t: torch.Tensor, T: float,
                       scheduler: str) -> torch.Tensor:
    """Share of the ordered train rows used at epoch ``t`` (a float32
    tensor): linear, root or geometric growth from ``lam`` to 1 over
    ``T`` epochs."""
    if scheduler == "linear":
        return torch.clamp(lam + (1 - lam) * t / T, max=1.0)
    if scheduler == "root":
        return torch.clamp(torch.sqrt(lam ** 2 + (1 - lam ** 2) * t / T),
                           max=1.0)
    lg = float(np.log2(lam))
    return torch.clamp(torch.pow(2.0, lg - lg * t / T), max=1.0)


class GEOM(SFGC):
    buffer_dir = "geom_buffer"

    # -- curriculum ------------------------------------------------------
    def sorted_train(self, data: G.Dataset) -> np.ndarray:
        """Train rows sorted easiest → hardest by the entropy of their
        neighbours' labels over the normalized adjacency's entries (every
        row of the train subgraph in the inductive setting)."""
        host = data.train_norm_host()
        labels = self.real.labels_real.cpu().numpy()
        hist = np.zeros((host.n_rows, self.nclass))
        np.add.at(hist, (host.row, labels[host.col]), 1.0)
        hist /= np.maximum(hist.sum(1, keepdims=True), 1e-12)
        entropy = -(hist * np.log(hist + np.exp(-20.0))).sum(1)
        tr = data.pool_ids()
        return tr[np.argsort(entropy[tr], kind="stable")]

    def expert_schedule(self, data: G.Dataset) -> tuple:
        """``teacher_epochs + 1`` epochs, each on the prefix of the
        ordered train rows that the scheduler allows (masked mean NLL)."""
        args = self.args
        order = torch.as_tensor(self.sorted_train(data), device=data.device)
        n_tr = order.shape[0]
        y = self.real.labels_real[order]
        rank = torch.arange(n_tr, dtype=torch.float32, device=data.device)

        def loss_of(out, e):
            size = training_scheduler(
                args.lam, torch.tensor(float(e), device=data.device),
                float(args.T), args.scheduler)
            mask = rank < torch.floor(size * n_tr)
            return utils.nll_loss(out[order], y, mask)

        return args.teacher_epochs + 1, loss_of

    # -- stage 2 --------------------------------------------------------
    def soft_label_init(self, traj: torch.Tensor,
                        feat_syn: torch.Tensor) -> torch.Tensor:
        """The first expert's last log-probabilities on the synthetic
        features (identity graph); where a row's argmax is not its label,
        the label's entry is raised to the row's maximum."""
        with torch.no_grad():
            out = self.expert_model.apply(self.unflatten(traj[0, -1]),
                                          feat_syn, None).clone()
        hard = self.labels_syn
        mx, pred = out.max(1)
        wrong = torch.nonzero(pred != hard).squeeze(1)
        out[wrong, hard[wrong]] = mx[wrong]
        return out

    def geom_loss(self, feat_syn, y_soft, syn_lr, start_p, target_p,
                  clom_p):
        """``‖θ_T − θ*‖ / max(‖θ_0 − θ*‖, 1e-12)`` (+ β · the last
        snapshot's KL or NLL); the student's inner loss is the log-target
        KL with soft labels, the NLL without."""
        soft = y_soft is not None

        def inner(out):
            return kl_log_target(out, y_soft) if soft \
                else utils.nll_loss(out, self.labels_syn)

        theta = self.unroll(feat_syn, syn_lr, None, start_p, inner)
        grand = torch.linalg.norm(theta - target_p) / torch.clamp(
            torch.linalg.norm(start_p - target_p), min=1e-12)
        if self.args.beta > 0:
            out = self.expert_model.apply(self.unflatten(clom_p), feat_syn,
                                          None)
            grand = grand + self.args.beta * inner(out)
        return grand

    def draw(self, rng: np.random.Generator, it: int, n_exp: int,
             n_snap: int) -> tuple:
        """(expert, start snapshot, the fixed target snapshot)."""
        args = self.args
        target = min(args.expert_epochs // 10, n_snap - 1)
        e = int(rng.integers(n_exp))
        upper = max(min(args.max_start_epoch_s + it, args.max_start_epoch),
                    args.min_start_epoch + 1)
        s_ep = int(rng.integers(args.min_start_epoch, upper))
        s = min(s_ep // 10 if args.optim == "Adam" else s_ep, n_snap - 1)
        if s == target:
            s = max(target - 1, 0)
        return e, s, target

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        traj = torch.as_tensor(self.build_buffer(data, verbose),
                               device=data.device)
        n_exp, n_snap, _ = traj.shape
        rng = np.random.default_rng(args.seed)
        feat_syn = self.init_reduced(verbose).feat.clone() \
            .requires_grad_(True)
        y_soft = opt_y = None
        if args.soft_label:
            y_soft = self.soft_label_init(traj, feat_syn) \
                .requires_grad_(True)
            opt_y = utils.SGD(args.lr_y, momentum=0.9)
            state_y = opt_y.init([y_soft])
        syn_lr = torch.tensor(float(args.lr_student), device=data.device,
                              requires_grad=True)
        opt_lr = utils.SGD(1e-6, momentum=0.5)
        opt_f, opt_l = self.opt_feat.init([feat_syn]), opt_lr.init([syn_lr])
        best_val = 0.0
        self._best_reduced = None
        self.losses = []

        def labels_out():
            return None if y_soft is None else torch.softmax(
                y_soft.detach(), dim=-1)

        for it in range(args.epochs):
            e, s, t = self.draw(rng, it, n_exp, n_snap)
            wrt = [feat_syn, syn_lr] + ([y_soft] if opt_y else [])
            with torch.enable_grad():
                loss = self.geom_loss(feat_syn, y_soft, syn_lr, traj[e, s],
                                      traj[e, t], traj[e, -1])
                g_f, g_lr, *g_y = torch.autograd.grad(loss, wrt)
            if opt_y:
                opt_y.step([y_soft], g_y, state_y)
            self.opt_feat.step([feat_syn], [g_f], opt_f)
            if args.optim_lr:
                opt_lr.step([syn_lr], [g_lr], opt_l)
            loss = loss.item()
            self.losses.append(loss)
            if not math.isfinite(loss):
                log.warning("geom loss NaN at it=%d; stopping", it)
                break
            if it in args.checkpoints:
                best_val = self.intermediate_evaluation(
                    feat_syn, None, best_val, it, loss, verbose,
                    labels=labels_out())
        if self._best_reduced is not None:
            return self._best_reduced
        labels = labels_out()
        return G.Reduced(feat=feat_syn.detach().clone(), adj=None,
                         labels=self.labels_syn if labels is None
                         else labels)
