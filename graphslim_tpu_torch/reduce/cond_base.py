"""Gradient-matching condensation engine (the GCond core).

Counterpart of ``graphslim_tpu/reduce/cond_base.py``.  Where the JAX
package scans over classes (real gradients) and vmaps over class masks
(synthetic gradients), this engine writes the class axis out: the model's
parameters are replicated to ``[C, ...]`` leaves, every class runs in one
batched forward, and one ``torch.autograd.grad`` of the summed class losses
yields all ``C`` per-class gradients.  The synthetic gradients keep their
graph (``create_graph=True``) for the nested gradient of the match loss.

``match_loss`` keeps the reference's ``ours`` metric exactly, including the
exclusion of 1-D (bias) gradients.

A subclass with ``with_structure = False`` (GCondX, DosCondX, GCDM) builds
no PGE: its synthetic adjacency is the identity, passed as ``None`` (the
models' ``aggregate`` then leaves ``x`` as it is).  ``generator_forward`` is
the hook through which SGDD adds its generator's own loss.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.data import save_reduced
from graphslim_tpu_torch.kernels.sample import (BlockSample, PackedCsr,
                                                neighbor_sample_block,
                                                packed_csr_of_norm)
from graphslim_tpu_torch.models.pge import PGE, PGEConfig
from graphslim_tpu_torch.profiling import count, span
from graphslim_tpu_torch.reduce.base import Reducer, class_budgets

log = logging.getLogger("graphslim_tpu_torch")


def match_loss(gw_syn: list, gw_real: list, metric: str) -> torch.Tensor:
    """Per-class gradient distance: leaves carry a leading class axis
    ``[C, ...]``; returns ``[C]``."""
    C = gw_syn[0].shape[0]
    if metric == "ours":
        dis = 0.0
        for gs, gr in zip(gw_syn, gw_real):
            if gs.ndim - 1 < 2:
                continue  # 1-D (bias) grads excluded, utils.py:102-104
            gs2 = gs.reshape(C, gs.shape[1], -1)
            gr2 = gr.reshape(C, gr.shape[1], -1)
            num = (gs2 * gr2).sum(-1)
            den = (torch.linalg.norm(gs2, dim=-1)
                   * torch.linalg.norm(gr2, dim=-1) + 1e-6)
            dis = dis + (1.0 - num / den).sum(-1)
        return dis
    gs = torch.cat([g.reshape(C, -1) for g in gw_syn], dim=1)
    gr = torch.cat([g.reshape(C, -1) for g in gw_real], dim=1)
    if metric == "mse":
        return ((gs - gr) ** 2).sum(-1)
    if metric == "cos":
        return 1.0 - (gs * gr).sum(-1) / (
            torch.linalg.norm(gs, dim=-1) * torch.linalg.norm(gr, dim=-1)
            + 1e-6)
    raise ValueError(f"unknown dis_metric {metric!r}")


def fanouts_for(nlayers: int, dataset: str) -> list[int]:
    """Reference fanout policy (``dataset/loader.py:197-211``)."""
    if nlayers == 1:
        return [15]
    if nlayers == 2:
        return [15, 8] if dataset in ("reddit", "flickr") else [10, 5]
    return [15, 10, 5] + [5] * (nlayers - 3)


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Masked mean NLL over the rows of the last-but-one axis; ``labels``
    broadcast to the rows of ``log_probs``."""
    labels = labels.expand(log_probs.shape[:-1])
    return utils.nll_loss(log_probs, labels, mask)


class RealTensors(NamedTuple):
    """The real-graph device tensors of the matching path."""

    features: torch.Tensor     # [n, d]
    labels_real: torch.Tensor  # [n]
    pools: torch.Tensor        # [C, max_n] padded per-class train pools
    pool_counts: torch.Tensor  # [C]
    self_vals: torch.Tensor    # [n] normalized self-loop values
    tables: PackedCsr          # sampler layout of the off-diagonal CSR


def _batched(params: dict, C: int) -> dict:
    """Leaves replicated along a new leading class axis, as fresh leaves
    that require grad."""
    return utils.tree_map(
        lambda p: p.detach().unsqueeze(0).expand(C, *p.shape).clone()
        .requires_grad_(True), params)


def _over_skeletons(params: dict, adj) -> dict:
    """Class-axis leaves ``[C, ...]`` seen as ``[C, 1, ...]`` when the
    synthetic adjacency is a batch ``[B, n, n]`` (MSGC), so activations
    run as ``[C, B, n, h]``: the class axis leads, the skeleton axis
    broadcasts beside it."""
    if M.is_skeleton_batch(adj):
        return utils.tree_map(lambda p: p.unsqueeze(1), params)
    return params


class CondensationBase(Reducer):
    """Shared state of the GCond family: budgets, sampler tables,
    optimizers, checkpoint evaluation."""

    save_output = False
    with_structure = True        # False → adj_syn = I (the ±X variants)
    sample_batch = 256

    def __init__(self, data: G.Dataset, args):
        super().__init__(data, args)
        with span("engine.init", method=type(self).__name__):
            dev = data.device
            labels_pool = data.labels_for_reduction()
            self.budgets, labels_syn, self.class_ranges = class_budgets(
                labels_pool, args.reduction_rate, absorb_remainder=True)
            self.labels_syn = torch.as_tensor(labels_syn.astype(np.int64),
                                              device=dev)
            self.n_syn = int(labels_syn.shape[0])
            self.d = data.n_feat
            self.nclass = data.nclass
            self.gen = utils.make_generator(args.seed, dev)

            # the real graph: the full graph, or the train subgraph in the
            # inductive setting (pools then hold its local ids); the sampler's
            # layout of its normalized adjacency comes from the host mirror
            # (no device readback)
            features, _, labels_real = data.train_graph()
            with span("engine.tables"):
                tables = packed_csr_of_norm(data.train_norm_host(), dev)

            # per-class pools (padded)
            with span("engine.pools"):
                self.classes = sorted(self.budgets.keys())
                pool_base = data.pool_ids()
                pools = [pool_base[labels_pool == c] for c in self.classes]
                max_n = max(len(p) for p in pools)
                pool_pad = np.zeros((len(self.classes), max_n),
                                    dtype=np.int64)
                for i, p in enumerate(pools):
                    pool_pad[i, :len(p)] = p
                self.batch = int(min(self.sample_batch, max_n))
                self.real = RealTensors(
                    features=features, labels_real=labels_real,
                    pools=torch.as_tensor(pool_pad, device=dev),
                    pool_counts=torch.as_tensor(
                        [len(p) for p in pools], dtype=torch.int64,
                        device=dev),
                    self_vals=tables.node[:, 2], tables=tables)

            self._build_class_tables()

            self.model = M.get_model(args.condense_model, M.ModelConfig(
                nfeat=self.d, nhid=args.hidden, nclass=data.nclass,
                nlayers=args.nlayers, dropout=0.0, alpha=args.alpha,
                ntrans=args.ntrans))
            self.fanouts = tuple(fanouts_for(args.nlayers, data.name))
            self.pge = PGE(PGEConfig.for_dataset(
                self.d, self.n_syn, data.name, args.reduction_rate)) \
                if self.with_structure else None
            self.opt_feat = utils.Adam(args.lr_feat)
            self.opt_pge = utils.Adam(args.lr_adj)
            self.opt_model = utils.Adam(args.lr or 0.01)

    def _build_class_tables(self) -> None:
        """Class masks over the label vector the matching runs against
        (longer than ``n_syn`` where MSGC tiles it over its skeletons) and
        the class weights ``budget / n_syn``."""
        cls_arr = self.labels_syn.cpu().numpy()
        dev = self.labels_syn.device
        self.class_masks = torch.as_tensor(
            np.stack([cls_arr == c for c in self.classes]), device=dev)
        self.coeffs = torch.as_tensor(
            [self.budgets[c] / self.n_syn for c in self.classes],
            dtype=torch.float32, device=dev)

    # ------------------------------------------------------------------
    def init_reduced(self, verbose: bool = False) -> G.Reduced:
        """The ``args.init`` reducer's graph at this engine's labels."""
        from graphslim_tpu_torch.reduce.registry import create_reducer

        init_args = self.args.replace(method=self.args.init)
        agent = create_reducer(self.args.init, self.data, init_args,
                               labels_syn_override=self.labels_syn.cpu()
                               .numpy())
        return agent.reduce(self.data, verbose=verbose)

    def init_feat_syn(self, verbose: bool = False) -> torch.Tensor:
        """Synthetic features from the ``args.init`` reducer."""
        feat = self.init_reduced(verbose).feat.clone()
        if feat.shape[0] != self.n_syn:
            raise RuntimeError(f"init gave {feat.shape[0]} rows, "
                               f"expected {self.n_syn}")
        return feat

    # ------------------------------------------------------------------
    def _sample_all_class_blocks(self, gen: torch.Generator):
        """One flat fanout sample covering every class; each level is
        reshaped to a leading class axis (a class's slots are contiguous)."""
        real = self.real
        C, B = len(self.classes), self.batch
        counts = real.pool_counts
        slot = torch.arange(B, device=counts.device)[None, :]
        u = torch.rand((C, B), generator=gen, device=counts.device)
        rand = torch.floor(u * torch.clamp(counts, min=1)[:, None]).long()
        pos = torch.where(counts[:, None] <= B,
                          torch.minimum(slot, counts[:, None] - 1), rand)
        targets = torch.gather(real.pools, 1, pos)                # [C, B]
        valid = (slot < counts[:, None]) | (counts[:, None] > B)
        block = neighbor_sample_block(gen, real.tables, targets.reshape(-1),
                                      self.fanouts)
        ids = tuple(x.reshape(C, -1) for x in block.node_ids)
        ws = tuple(w.reshape(C, -1, w.shape[-1]) for w in block.weights)
        return ids, ws, targets, valid

    _sharded_match = None

    def enable_distributed(self, n_devices: Optional[int] = None,
                           axis: str = "data", *, mesh=None,
                           feature_mode: str = "replicated") -> None:
        """Shard the per-class gradient matching over a mesh of
        ``n_devices`` ranks, or over ``mesh`` when given
        (``dist/matching.py``): classes partition over the ranks and the
        loss sums; ``feature_mode='sharded'`` row-shards the real features
        too.  Opt-in via ``--dist_devices N`` under a launcher with N
        ranks; the mesh's backend follows the dataset's device (NCCL on
        the card, gloo on the CPU)."""
        from graphslim_tpu_torch.dist.matching import build_sharded_match
        from graphslim_tpu_torch.dist.mesh import axis_size, make_mesh

        if mesh is None:
            mesh = make_mesh(n_devices, axis=axis, device=self.data.device)
        self._sharded_match = build_sharded_match(
            self, mesh, axis=axis, feature_mode=feature_mode)
        log.info("distributed matching over %d devices",
                 axis_size(mesh, axis))

    def match_classes(self, model_params: dict, feat_syn: torch.Tensor,
                      adj_syn_norm, feat_deep: torch.Tensor, ids: tuple,
                      ws: tuple, targets: torch.Tensor, valid: torch.Tensor,
                      masks: torch.Tensor, coeffs: torch.Tensor
                      ) -> torch.Tensor:
        """Σ_c coeffs_c · match(gw_syn_c, gw_real_c) over the classes of
        the leading axis of the sampled blocks (``feat_deep`` their deep
        feature rows), differentiable with respect to ``feat_syn`` and
        ``adj_syn_norm``."""
        C = targets.shape[0]
        with torch.enable_grad():
            # real gradients: detached, one batched pass over the classes
            with span("match.real"):
                pr = _batched(model_params, C)
                out = self.model.apply(pr, feat_deep,
                                       BlockSample(node_ids=ids, weights=ws))
                loss_r = masked_nll(out, self.real.labels_real[targets],
                                    valid)
                gw_real = torch.autograd.grad(loss_r.sum(),
                                              utils.tree_leaves(pr))
            # synthetic gradients: differentiable (nested gradient)
            with span("match.syn"):
                ps = _batched(model_params, C)
                out_s = self.model.apply(_over_skeletons(ps, adj_syn_norm),
                                         feat_syn, adj_syn_norm)
                loss_s = masked_nll(out_s, self.labels_syn, masks)
                gw_syn = torch.autograd.grad(loss_s.sum(),
                                             utils.tree_leaves(ps),
                                             create_graph=True)
            with span("match.loss"):
                mls = match_loss(list(gw_syn), list(gw_real),
                                 self.args.dis_metric)
                return (coeffs * mls).sum()

    def match_loss_total(self, model_params: dict, feat_syn: torch.Tensor,
                         adj_syn_norm: torch.Tensor, gen: torch.Generator
                         ) -> torch.Tensor:
        """Σ_c coeff_c · match(gw_syn_c, gw_real_c), differentiable with
        respect to ``feat_syn`` and ``adj_syn_norm``; with
        :meth:`enable_distributed`, the classes shard over the mesh.  A
        ``step.match`` span; counts the sampled slots and the gathered
        feature rows and bytes from the blocks' shapes."""
        with span("step.match"):
            if self._sharded_match is not None:
                return self._sharded_match(model_params, feat_syn,
                                           adj_syn_norm, gen)
            with span("match.sample"):
                ids, ws, targets, valid = self._sample_all_class_blocks(gen)
                count("match.sampled_slots", ids[0].numel())
            with span("match.gather"):
                feat_deep = self.real.features[ids[0]]
                count("match.gathered_rows", ids[0].numel())
                count("match.gathered_bytes", feat_deep.nbytes)
            return self.match_classes(model_params, feat_syn, adj_syn_norm,
                                      feat_deep, ids, ws, targets, valid,
                                      self.class_masks, self.coeffs)

    @property
    def adj_norm_full(self) -> G.SparseAdj:
        """The real graph's normalized adjacency on the device (the full
        graph's, or the train subgraph's in the inductive setting); cached
        on the dataset with its blocked layout, so on the card every
        product with it launches the blocked SpMM."""
        return self.data.train_norm()

    def syn_adj_norm(self, pge_params: dict, feat_syn: torch.Tensor):
        """Normalized synthetic adjacency; ``None`` (the identity, which
        normalization leaves as it is) without structure."""
        if not self.with_structure:
            return None
        return G.normalize_adj_dense(self.pge.apply(pge_params, feat_syn))

    def generator_forward(self, pge_params: dict, feat_syn: torch.Tensor):
        """(normalized synthetic adjacency, the generator's own loss);
        SGDD overrides it."""
        return self.syn_adj_norm(pge_params, feat_syn), 0.0

    def inference_adj(self, pge_params: dict, feat_syn: torch.Tensor):
        """Detached synthetic adjacency (inner loop and checkpoints);
        ``None`` (the identity) without structure."""
        if not self.with_structure:
            return None
        return self.pge.inference(pge_params, feat_syn)

    def inner_adj(self, pge_params: dict, feat_syn: torch.Tensor):
        """Normalized detached adjacency for inner-loop model training;
        ``None`` (the identity) without structure."""
        if not self.with_structure:
            return None
        return G.normalize_adj_dense(self.inference_adj(pge_params,
                                                        feat_syn))

    # ------------------------------------------------------------------
    def intermediate_evaluation(self, feat_syn, adj_syn, best_val: float,
                                it: int, loss_avg: float,
                                verbose: bool = False,
                                labels=None) -> float:
        """Checkpoint: ``run_inter_eval`` quick trainings on the current
        synthetic graph; save the best by validation.  ``labels`` replace
        ``labels_syn`` (GCSNTK's and GEOM's soft labels, which the trainer
        fits with the soft loss)."""
        from graphslim_tpu_torch.eval import Evaluator

        args = self.args
        reduced = G.Reduced(
            feat=feat_syn.detach().clone(),
            adj=None if adj_syn is None else adj_syn.detach(),
            labels=self.labels_syn if labels is None
            else labels.detach().clone())
        ev = Evaluator(self.data, args)
        accs = []
        for s in range(args.run_inter_eval):
            model = ev._eval_model(args.eval_model, reduced.feat.shape[-1])
            tx, tadj, ty = ev._train_tuple(reduced, args.eval_model)
            cfg = M.TrainConfig(epochs=args.eval_epochs,
                                lr=args.lr or 0.01, weight_decay=5e-4,
                                metric=args.metric)
            _, bv, _ = M.fit_with_val(
                model, utils.make_generator(args.seed + s, self.data.device),
                train=(tx, tadj, ty, None),
                val=self.data.split_batch("val"), cfg=cfg)
            accs.append(float(bv))
        mean_val = float(np.mean(accs))
        log.info("checkpoint it=%d loss=%.4f val=%.4f (best %.4f)", it,
                 loss_avg, mean_val, best_val)
        if verbose:
            print(f"[it {it}] loss {loss_avg:.4f} val {mean_val:.4f}")
        if mean_val > best_val:
            best_val = mean_val
            save_reduced(reduced, args.save_path, args.method,
                         self.data.name, args.reduction_rate, args.seed,
                         attack=getattr(args, "attack", None))
            self._best_reduced = reduced
        return best_val
