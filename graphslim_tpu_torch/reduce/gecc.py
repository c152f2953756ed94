"""GECC — evolving clustering aggregation condensation.

Counterpart of ``graphslim_tpu/reduce/gecc.py`` (reference
``condensation/gecc.py``):

1. weighted multi-hop feature aggregation
   ``X_agg = γ·X + α·ÂX + β·Â²X (+ 0.5·deeper hops)``; every hop is a
   product with the dataset's cached normalized adjacency (on the card:
   one blocked-SpMM launch at the feature width), where the JAX package
   uses its ELL layout.  Above ``sample_threshold`` nodes a
   memory-bounded estimate over the train targets, from fixed-fanout
   sampled blocks, replaces the exact hops;
2. per-class clustering of the aggregated train features: k-means when
   ``fuzziness == 1``, else fuzzy c-means;
3. **evolving centroids** across splits: the previous split's centroids
   warm-start the clustering; when the budget grew, the shortfall is drawn
   by incremental k-means++, when it shrank, the centroids are truncated;
4. the centroids become the synthetic features, with the identity
   adjacency.
"""

from __future__ import annotations

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.kmeans import (fuzzy_cmeans,
                                                incremental_kmeanspp,
                                                kmeans, random_rows)
from graphslim_tpu_torch.kernels.sample import (neighbor_sample_block,
                                                packed_csr_of_norm)
from graphslim_tpu_torch.models.base import aggregate_block
from graphslim_tpu_torch.reduce.base import (Reducer, budgets_of,
                                             class_budgets)
from graphslim_tpu_torch.reduce.clustering import tile_rows


class GECC(Reducer):
    def __init__(self, data, args, labels_syn_override=None,
                 prev_centroids=None):
        super().__init__(data, args)
        if labels_syn_override is not None:
            self.labels_syn = np.asarray(labels_syn_override)
            self.budgets = budgets_of(self.labels_syn)
        else:
            self.budgets, self.labels_syn, _ = class_budgets(
                data.labels_for_reduction(), args.reduction_rate,
                absorb_remainder=True)
        self.prev_centroids = prev_centroids or {}

    # graphs above this node count take the sampled aggregation estimate
    # (the reference routes ogbn-products through a NeighborSampler); the
    # exact hops otherwise
    sample_threshold = 400_000
    sample_fanout = 15
    sample_batch = 4096

    def _hop_weights(self) -> list:
        args = self.args
        return [args.agg_gamma, args.agg_alpha, args.agg_beta] \
            + [0.5] * max(args.depth + 1 - 3, 0)

    def _aggregate(self, data: G.Dataset) -> torch.Tensor:
        """The weighted hop mix over all nodes."""
        weights = self._hop_weights()
        norm = data.adj_norm()
        agg = weights[0] * data.feat
        tmp = data.feat
        for hop in range(1, self.args.depth + 1):
            tmp = norm.matmul(tmp)
            agg = agg + weights[min(hop, len(weights) - 1)] * tmp
        return agg

    def _aggregate_sampled(self, data: G.Dataset, targets: np.ndarray
                           ) -> torch.Tensor:
        """The hop mix over ``targets`` only, estimated from fixed-fanout
        sampled blocks, one ``depth``-hop block per batch of targets: the
        h-hop aggregate of a target is the raw features at block level
        ``depth - h`` propagated through the top ``h`` weight levels.
        Work and memory scale with ``len(targets) · fanout^depth``, never
        with the node count; with a fanout at or above the largest degree
        the estimate is exact."""
        weights = self._hop_weights()
        feat, dev = data.feat, data.device
        tables = packed_csr_of_norm(data.adj_norm_host(), dev)
        fanouts = [self.sample_fanout] * self.args.depth
        gen = utils.make_generator(self.args.seed, dev)
        parts = []
        for s in range(0, len(targets), self.sample_batch):
            tgt = torch.as_tensor(targets[s:s + self.sample_batch],
                                  dtype=torch.int64, device=dev)
            block = neighbor_sample_block(gen, tables, tgt, fanouts)
            L = block.num_layers
            out = weights[0] * feat[tgt]
            for h in range(1, L + 1):
                # raw features at level L-h, propagated h times
                x = feat[block.node_ids[L - h]]
                for k in range(L - h, L):
                    x = aggregate_block(block.weights[k], x)
                out = out + weights[min(h, len(weights) - 1)] * x
            parts.append(out)
        return torch.cat(parts, dim=0)

    def init_rows(self, c: int, n: int, k: int, gen: torch.Generator
                  ) -> torch.Tensor:
        """The ``k`` distinct rows (of class ``c``'s ``n``) that start its
        clustering when no previous centroids do."""
        return random_rows(n, k, gen)

    def _evolve_init(self, c: int, x_c: torch.Tensor, n_c: int,
                     gen: torch.Generator):
        """Warm-start centroids of class ``c`` from ``prev_centroids``:
        reused when the counts match, truncated when the budget shrank,
        extended by incremental k-means++ when it grew; None without
        previous centroids."""
        prev = self.prev_centroids.get(c)
        if prev is None:
            return None
        prev = torch.as_tensor(np.asarray(prev, dtype=np.float32),
                               device=x_c.device)
        if prev.shape[0] >= n_c:
            return prev[:n_c]
        new = incremental_kmeanspp(x_c, prev, n_c - prev.shape[0], gen)
        return torch.cat([prev, new], dim=0)

    @torch.no_grad()
    def _reduce(self, data: G.Dataset, verbose: bool) -> G.Reduced:
        args = self.args
        labels_tr = data.labels_for_reduction()
        train_rows = np.asarray(data.idx_train)
        if data.n_nodes > self.sample_threshold:
            agg = self._aggregate_sampled(data, train_rows)
        else:
            agg = self._aggregate(data)[torch.as_tensor(train_rows,
                                                        device=data.device)]
        labels_syn = np.asarray(self.labels_syn)
        x_syn = agg.new_zeros((labels_syn.shape[0], agg.shape[1]))
        gen = utils.make_generator(args.seed, data.device)
        for c, n_c in self.budgets.items():
            x_c = agg[torch.as_tensor(np.flatnonzero(labels_tr == c),
                                      device=data.device)]
            n_c = int(min(n_c, x_c.shape[0]))
            init = self._evolve_init(c, x_c, n_c, gen)
            if x_c.shape[0] <= n_c:
                centers = tile_rows(x_c, n_c)
            else:
                if init is None:
                    init = x_c[self.init_rows(c, x_c.shape[0], n_c, gen)]
                if args.fuzziness == 1.0:
                    centers, _ = kmeans(x_c, n_c, init=init)
                else:
                    centers = fuzzy_cmeans(x_c, n_c, float(args.fuzziness),
                                           int(args.rep_fuzz), init=init)
            rows = np.flatnonzero(labels_syn == c)[:n_c]
            x_syn[torch.as_tensor(rows, device=data.device)] = \
                centers[:len(rows)]
            self.prev_centroids[c] = centers.cpu().numpy()
        return G.Reduced(feat=x_syn, adj=None, labels=torch.as_tensor(
            labels_syn.astype(np.int64), device=data.device))
