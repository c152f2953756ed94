"""GCDM / GCDMX — distribution (embedding) matching condensation.

Counterpart of ``graphslim_tpu/reduce/gcdm.py`` (reference ``gcdm.py``;
``gcdmx.py`` is identical upstream).  Instead of gradients, per-layer
embeddings of real class samples and synthetic class rows are matched.
Each epoch re-initializes the model; each outer step computes the real
embeddings over the full graph (detached), draws per class a random
permutation of its training pool cut to the class budget, takes one Adam
step of the synthetic features on the matching loss, and trains the model
``inner_loop`` times on the synthetic graph.  The synthetic structure is
the identity (``None``, where the JAX package multiplies by ``I``).

Only the layers ``0 … nlayers-2`` are matched, and only those are computed:
the real embeddings run under ``torch.no_grad`` and stop at the last
matched layer (XLA drops the unmatched top layer as dead code inside the
JAX package's jitted epoch; eager PyTorch would compute it).  With GCN and
``nlayers`` 2 an outer step makes one full-graph product, at the hidden
width (on the card: one blocked-SpMM launch).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.reduce.cond_base import CondensationBase

log = logging.getLogger("graphslim_tpu_torch")


def row_dist(x: torch.Tensor, y: torch.Tensor, method: str
             ) -> torch.Tensor:
    """Per-row embedding distance; :func:`dist` is its sum."""
    x2, y2 = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    if method == "mse":
        return ((x2 - y2) ** 2).sum(-1)
    if method == "l1_mean":
        return (x2 - y2).abs().mean(-1)
    if method == "cos":
        num = (x2 * y2).sum(-1)
        den = (torch.linalg.norm(x2, dim=-1)
               * torch.linalg.norm(y2, dim=-1) + 1e-6)
        return 1.0 - num / den
    # l1, and any unknown name (e.g. 'ours' from GCond's defaults)
    return (x2 - y2).abs().sum(-1)


def dist(x: torch.Tensor, y: torch.Tensor, method: str) -> torch.Tensor:
    """Embedding distance (reference ``gcdm.py:108-124``): ``mse``,
    ``l1``, ``l1_mean``, ``cos``; unknown names fall back to ``l1``."""
    return row_dist(x, y, method).sum()


class GCDM(CondensationBase):
    with_structure = False

    def __init__(self, data, args):
        super().__init__(data, args)
        dev = data.device
        nl = args.nlayers
        n_out = self.model.n_layer_features()
        self.n_match = min(max(1, min(n_out, nl) - 1) if nl > 1 else 1,
                           n_out)
        # synthetic row → (class slot, position in the class's rows) and
        # the class's matching weight budget_c / n_syn
        cls = np.zeros(self.n_syn, dtype=np.int64)
        pos = np.zeros(self.n_syn, dtype=np.int64)
        coeff = np.zeros(self.n_syn, dtype=np.float32)
        for ci, c in enumerate(self.classes):
            st, ed = self.class_ranges[c]
            cls[st:ed], pos[st:ed] = ci, np.arange(ed - st)
            coeff[st:ed] = self.budgets[c] / self.n_syn
        self.row_class = torch.as_tensor(cls, device=dev)
        self.row_pos = torch.as_tensor(pos, device=dev)
        self.row_coeff = torch.as_tensor(coeff, device=dev)
        self.epoch_loss_sums: list[torch.Tensor] = []

    def draw_selection(self, gen: torch.Generator) -> torch.Tensor:
        """Real node matched to each synthetic row: per class a random
        permutation of its pool (the order of uniform keys, one sort for
        all classes) cut to the class budget."""
        real = self.real
        C, max_n = real.pools.shape
        keys = torch.rand((C, max_n), generator=gen, device=gen.device)
        slot = torch.arange(max_n, device=keys.device)
        keys = torch.where(slot[None, :] < real.pool_counts[:, None], keys,
                           torch.full_like(keys, 2.0))
        order = torch.argsort(keys, dim=1)
        return real.pools[self.row_class,
                          order[self.row_class, self.row_pos]]

    def real_embeddings(self, model_params: dict) -> list:
        """The matched layers' activations of the full graph, detached."""
        with torch.no_grad():
            return self.model.layer_features(
                model_params, self.real.features, self.adj_norm_full,
                depth=self.n_match)

    def objective(self, model_params: dict, feat_syn: torch.Tensor,
                  emb_real: list, sel: torch.Tensor) -> torch.Tensor:
        """Σ_layers Σ_c coeff_c · dist(real rows of class c, synthetic
        rows of class c), as one weighted sum over the synthetic rows."""
        emb_syn = self.model.layer_features(model_params, feat_syn, None,
                                            depth=self.n_match)
        loss = 0.0
        for i in range(self.n_match):
            rd = row_dist(emb_real[i][sel], emb_syn[i], self.args.dis_metric)
            loss = loss + (self.row_coeff * rd).sum()
        return loss

    def _epoch(self, feat_syn: torch.Tensor, opt_f: dict) -> torch.Tensor:
        """One epoch; updates ``feat_syn`` in place and returns the summed
        loss (on the device)."""
        args = self.args
        mp = utils.trainable(self.model.init(self.gen))
        mp_leaves = utils.tree_leaves(mp)
        m_opt = self.opt_model.init(mp_leaves)
        losses = []
        for _ in range(args.outer_loop):
            emb_real = self.real_embeddings(mp)
            sel = self.draw_selection(self.gen)
            with torch.enable_grad():
                loss = self.objective(mp, feat_syn, emb_real, sel)
                g, = torch.autograd.grad(loss, [feat_syn])
            self.opt_feat.step([feat_syn], [g], opt_f)
            fs_d = feat_syn.detach()
            for _ in range(args.inner_loop):
                with torch.enable_grad():
                    out = self.model.apply(mp, fs_d, None)
                    g = torch.autograd.grad(
                        utils.nll_loss(out, self.labels_syn), mp_leaves)
                self.opt_model.step(mp_leaves, g, m_opt)
            losses.append(loss.detach())
        return torch.stack(losses).sum()

    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        if args.resume:
            log.warning("%s keeps no train state (as in the JAX package); "
                        "--resume starts afresh", args.method)
        feat_syn = self.init_feat_syn(verbose).requires_grad_(True)
        opt_f = self.opt_feat.init([feat_syn])
        best_val = 0.0
        self._best_reduced = None
        for it in range(args.epochs):
            loss_sum = self._epoch(feat_syn, opt_f)
            self.epoch_loss_sums.append(loss_sum)
            if it in args.checkpoints:
                best_val = self.intermediate_evaluation(
                    feat_syn, None, best_val, it,
                    float(loss_sum) / max(args.outer_loop, 1), verbose)
        if self._best_reduced is not None:
            return self._best_reduced
        return G.Reduced(feat=feat_syn.detach().clone(), adj=None,
                         labels=self.labels_syn)


class GCDMX(GCDM):
    """Upstream ``gcdmx.py`` is identical to GCDM."""
