"""SFGC — structure-free condensation by training-trajectory matching.

Counterpart of ``graphslim_tpu/reduce/sfgc.py`` (reference
``graphslim/condensation/sfgc.py``):

* **Stage 1, the expert buffer.**  ``num_experts`` GCNs train on the full
  graph for ``teacher_epochs`` epochs each; the flat parameters at the
  start and after every 10th epoch form one ``[E, S, P]`` array, cached as
  ``save_path/sfgc_buffer/<dataset>_<attack>_<ptb_r>_<seed>.npz``.  The
  flat layout is ``ravel_pytree``'s (:mod:`graphslim_tpu_torch.convert`),
  so a buffer written by either package reads in the other.  Where the JAX
  package vmaps the experts, the port trains them one after another: each
  epoch is two products with the normalized adjacency forward and two
  backward (on the card: the blocked SpMM), and above 128 columns the
  kernel walks the entries once for every 128 of them, so one launch at
  the width of all experts would cost as much as one launch each.
* **Stage 2, the alignment.**  The student unrolls ``syn_steps`` SGD steps
  of the expert GCN on the synthetic graph from a sampled snapshot, with a
  learnable step size ``syn_lr``; the loss
  ``‖θ_T − θ*‖² / ‖θ_0 − θ*‖²`` is differentiated through the whole unroll
  (``create_graph=True``).  The first outer step uses the init reducer's
  graph, normalized, and every later one the identity.  The draws of
  expert, start and target come from ``np.random.default_rng(seed)``, as
  in the JAX package.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.convert import flatten_params, unflatten_params
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

log = logging.getLogger("graphslim_tpu_torch")


class SFGC(CondensationBase):
    with_structure = False
    buffer_dir = "sfgc_buffer"

    def __init__(self, data, args):
        if args.init == "random":
            args = args.replace(init="kcenter")
        args = args.replace(condense_model="GCN")
        super().__init__(data, args)
        self.buf_path = os.path.join(
            args.save_path, self.buffer_dir,
            f"{data.name}_{args.attack}_{args.ptb_r}_{args.seed}.npz")
        self.expert_model = M.get_model("GCN", M.ModelConfig(
            nfeat=self.d, nhid=args.hidden, nclass=data.nclass,
            nlayers=args.nlayers, dropout=0.0))
        # the tree whose shapes the flat layout follows
        self.template = self.expert_model.init(
            utils.make_generator(0, data.device))
        self.n_params = int(flatten_params(self.template).numel())

    def unflatten(self, flat: torch.Tensor) -> dict:
        return unflatten_params(flat, self.template)

    # -- stage 1 --------------------------------------------------------
    def expert_inits(self) -> list:
        """The experts' initial parameters, drawn from one generator."""
        gen = utils.make_generator(self.args.seed, self.data.device)
        return [self.expert_model.init(gen)
                for _ in range(self.args.num_experts)]

    def expert_opt(self):
        a = self.args
        if a.optim == "Adam":
            return utils.Adam(a.lr_teacher, weight_decay=a.wd_teacher)
        return utils.SGD(a.lr_teacher, momentum=a.mom_teacher,
                         weight_decay=a.wd_teacher)

    def expert_schedule(self, data: G.Dataset) -> tuple:
        """(epochs, loss of the real graph's output at epoch e): the NLL
        over the train rows (every row of the train subgraph in the
        inductive setting) for every one of ``teacher_epochs`` epochs."""
        y = data.pool_rows(self.real.labels_real)
        return self.args.teacher_epochs, \
            lambda out, e: utils.nll_loss(data.pool_rows(out), y)

    def trajectory(self, params0: dict, epochs: int, loss_of) -> torch.Tensor:
        """[S, P] flat parameters of one expert: at the start and after
        every 10th of ``epochs`` epochs on the real graph."""
        model, feat, norm = self.expert_model, self.real.features, \
            self.adj_norm_full
        params = utils.trainable(params0)
        leaves = utils.tree_leaves(params)
        opt = self.expert_opt()
        state = opt.init(leaves)
        snaps = [flatten_params(params).detach().clone()]
        for e in range(epochs):
            with torch.enable_grad():
                loss = loss_of(model.apply(params, feat, norm), e)
                grads = torch.autograd.grad(loss, leaves)
            opt.step(leaves, grads, state)
            if e % 10 == 9:
                snaps.append(flatten_params(params).detach().clone())
        return torch.stack(snaps)

    def build_buffer(self, data: G.Dataset, verbose: bool) -> np.ndarray:
        """[num_experts, snapshots, P] expert trajectories, read from the
        cache when it is there."""
        args = self.args
        if args.no_buff and not os.path.exists(self.buf_path):
            raise FileNotFoundError(
                f"--no_buff set but no buffer at {self.buf_path}")

        def build() -> np.ndarray:
            epochs, loss_of = self.expert_schedule(data)
            traj = np.stack([self.trajectory(p0, epochs, loss_of)
                             .cpu().numpy() for p0 in self.expert_inits()])
            utils.save_npz(self.buf_path, traj=traj)
            log.info("%s buffer built: %s %s", type(self).__name__.lower(),
                     self.buf_path, traj.shape)
            return traj

        traj = utils.build_once(self.buf_path, build)
        if traj is None:
            with np.load(self.buf_path) as f:
                traj = f["traj"]
        return traj

    # -- stage 2 --------------------------------------------------------
    def unroll(self, feat_syn, syn_lr, adj, start_p, inner_loss):
        """θ after ``syn_steps`` SGD steps from ``start_p`` on the
        synthetic graph, differentiable in ``feat_syn`` and ``syn_lr``."""
        theta = start_p.detach().clone().requires_grad_(True)
        for _ in range(self.args.syn_steps):
            out = self.expert_model.apply(self.unflatten(theta), feat_syn,
                                          adj)
            (g,) = torch.autograd.grad(inner_loss(out), theta,
                                       create_graph=True)
            theta = theta - syn_lr * g
        return theta

    def match_loss(self, feat_syn, syn_lr, adj, start_p, target_p):
        """``(‖θ_T − θ*‖² / P) / max(‖θ_0 − θ*‖² / P, 1e-12)``."""
        theta = self.unroll(feat_syn, syn_lr, adj, start_p,
                            lambda out: utils.nll_loss(out, self.labels_syn))
        n = float(self.n_params)
        num = ((theta - target_p) ** 2).sum()
        den = ((start_p - target_p) ** 2).sum()
        return (num / n) / torch.clamp(den / n, min=1e-12)

    def sample_start(self, rng: np.random.Generator) -> int:
        args = self.args
        grid = np.linspace(0, args.start_epoch,
                           num=args.start_epoch // 10 + 1)
        s = int(rng.choice(grid))
        return s // 10 if args.optim == "Adam" else s

    def draw(self, rng: np.random.Generator, it: int, n_exp: int,
             n_snap: int) -> tuple:
        """(expert, start snapshot, target snapshot) of outer step ``it``."""
        e = int(rng.integers(n_exp))
        s = min(self.sample_start(rng), n_snap - 2)
        return e, s, min(s + self.args.expert_epochs // 10, n_snap - 1)

    def first_adj(self, adj_init):
        """The normalized graph of the init reducer (the first outer
        step's), or ``None`` (the identity)."""
        if adj_init is None:
            return None
        if isinstance(adj_init, G.SparseAdj):
            return G.gcn_norm(adj_init).to_dense()
        return G.normalize_adj_dense(adj_init)

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        traj = torch.as_tensor(self.build_buffer(data, verbose),
                               device=data.device)
        n_exp, n_snap, _ = traj.shape
        rng = np.random.default_rng(args.seed)
        init = self.init_reduced(verbose)
        feat_syn = init.feat.clone().requires_grad_(True)
        first_adj = self.first_adj(init.adj)
        syn_lr = torch.tensor(float(args.lr_student), device=data.device,
                              requires_grad=True)
        opt_lr = utils.SGD(1e-6, momentum=0.5)
        opt_f, opt_l = self.opt_feat.init([feat_syn]), opt_lr.init([syn_lr])
        best_val = 0.0
        self._best_reduced = None
        self.losses = []
        for it in range(args.epochs):
            e, s, t = self.draw(rng, it, n_exp, n_snap)
            with torch.enable_grad():
                loss = self.match_loss(feat_syn, syn_lr,
                                       first_adj if it == 0 else None,
                                       traj[e, s], traj[e, t])
                g_f, g_lr = torch.autograd.grad(loss, [feat_syn, syn_lr])
            self.opt_feat.step([feat_syn], [g_f], opt_f)
            opt_lr.step([syn_lr], [g_lr], opt_l)
            loss = loss.item()
            self.losses.append(loss)
            if not math.isfinite(loss):
                log.warning("sfgc loss NaN at it=%d; stopping", it)
                break
            if it in args.checkpoints:
                best_val = self.intermediate_evaluation(
                    feat_syn, None, best_val, it, loss, verbose)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=feat_syn.detach().clone(), adj=None,
                         labels=self.labels_syn)
