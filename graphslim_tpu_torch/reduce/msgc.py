"""MSGC — multiple sparse graphs condensation.

Counterpart of ``graphslim_tpu/reduce/msgc.py``: a batch of ``batch_adj``
sparse skeleton graphs built by deterministic class-linking, their edges
scored by a shared MLP and normalized as a dense batch ``[B, n, n]``,
gradient matching against the synthetic labels tiled once per skeleton,
and window-averaged snapshots at the checkpoints.

Spans (:mod:`graphslim_tpu_torch.profiling`): ``msgc.skeletons`` around
the skeletons' host build in the constructor (counter
``msgc.skeleton_entries``: the triples built), ``msgc.init`` around the
synthetic features' init (the init reducer's own ``reduce`` nests in
it), and in every call of the generator ``generator.score`` (counter
``generator.scored_entries``: the entries scored), ``generator.scatter``
(the scores into the dense batch, symmetrized) and ``generator.norm``.
``kernels.edge_scorer.LAUNCHES`` shows whether the CUDA kernels scored
them.

It runs on the GCond engine through its generator hooks
(``generator_forward``, ``syn_adj_norm``, ``inference_adj``,
``inner_adj``): the edge scorer takes the PGE's place.  The engine's class
axis leads the activations and the skeleton axis sits beside it
(``[C, B, n, h]``); the models merge the skeleton and node axes of their
output, so the tiled labels and class masks line up with it.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.kernels import edge_scorer
from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.profiling import count, span
from graphslim_tpu_torch.reduce.gcond import GCond

# the edge scorer's hidden width (reference ``msgc.py:29-38``)
SCORER_HIDDEN = 256
# snapshots averaged at a checkpoint (reference ``FixLenList``)
WINDOW = 20


def proportional_labels(labels_train: np.ndarray, n_syn: int,
                        nclass: int) -> np.ndarray:
    """MSGC's label allocation: floor(proportional) + 1 base, leftovers to
    the most under-represented class."""
    n = labels_train.shape[0]
    rate = np.bincount(labels_train, minlength=nclass) / n
    n_each = np.floor((n_syn - nclass) * rate) + 1
    left = int(n_syn - n_each.sum())
    for _ in range(max(left, 0)):
        more = n_each / n_each.sum() / np.maximum(rate, 1e-12)
        n_each[np.argmin(more)] += 1
    n_each = n_each.astype(np.int64)
    y = np.concatenate([np.full(k, c) for c, k in enumerate(n_each)])
    return y.astype(np.int32)


def build_skeletons(y_syn: np.ndarray, nclass: int, batch: int,
                    seed: int) -> tuple:
    """Deterministic class-linking skeletons → ``(rows, cols, batches)``:
    each node links to at most two nodes of every class, preferring the
    least-connected candidate, ties broken by ``default_rng(seed)``.  The
    same draws in the same order as the JAX package, so the triples are
    identical; the candidate lists of each class are computed once."""
    rng = np.random.default_rng(seed)
    n = y_syn.shape[0]
    by_class = [np.flatnonzero(y_syn == c) for c in range(nclass)]
    rows, cols, batches = [], [], []
    for b in range(batch):
        n_neighbor = np.zeros((n, nclass))
        for row_id in range(n):
            y_row = y_syn[row_id]
            for c in range(nclass):
                if n_neighbor[row_id, c] > 1:
                    continue
                index = by_class[c]
                if c == y_row:
                    index = index[index != row_id]
                if index.shape[0] == 0:
                    continue
                link_coef = n_neighbor[index, y_row]
                cands = index[link_coef == link_coef.min()]
                col_id = int(cands[rng.integers(len(cands))]) \
                    if len(cands) > 1 else int(cands[0])
                n_neighbor[row_id, c] += 1
                n_neighbor[col_id, y_row] += 1
                rows.extend([row_id, col_id])
                cols.extend([col_id, row_id])
                batches.extend([b, b])
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(batches, np.int32))


class EdgeScorer:
    """The shared edge-scorer MLP over the skeletons' edges: ``[x_r | x_c]``
    → Linear/BatchNorm/ReLU ×2 → Linear → sigmoid, scattered into a dense
    ``[B, n, n]`` batch, symmetrized and normalized with self loops.

    The skeletons hold some (batch, row, col) entries twice, from two
    different links; as in the JAX package's scatter, the later one
    sets the entry (and takes its gradient), so only the last occurrence
    of each entry is scattered.  Every entry is scored and enters the
    BatchNorm statistics.  The MLP runs in :mod:`kernels.edge_scorer`:
    hand-written kernels on the card, its plain version on the CPU.
    """

    def __init__(self, nfeat: int, n: int, batch: int, rows: np.ndarray,
                 cols: np.ndarray, batches: np.ndarray, device):
        self.dims = (2 * nfeat, SCORER_HIDDEN, SCORER_HIDDEN, 1)
        self.n, self.batch = n, batch
        keys = (batches.astype(np.int64) * n + rows) * n + cols
        _, first_rev = np.unique(keys[::-1], return_index=True)
        last = np.sort(keys.shape[0] - 1 - first_rev)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.entries = edge_scorer.Entries(rows, cols, n, device)
        self.rows, self.cols = self.entries.rows, self.entries.cols
        self.last = t(last)
        self.target = (t(batches[last]), t(rows[last]), t(cols[last]))

    def init(self, gen: torch.Generator) -> dict:
        dims = self.dims
        return {"layers": [nn.linear_init(gen, a, b)
                           for a, b in zip(dims[:-1], dims[1:])],
                "bns": [nn.bn_init(d, gen.device) for d in dims[1:-1]]}

    def scores(self, params: dict, feat_syn: torch.Tensor) -> torch.Tensor:
        """One score in (0, 1) per skeleton entry."""
        (l1, l2, l3), (n1, n2) = params["layers"], params["bns"]
        return edge_scorer.edge_scores(
            self.entries, feat_syn, l1["w"], l1["b"], l2["w"], l2["b"],
            l3["w"], l3["b"], n1["scale"], n1["bias"], n2["scale"],
            n2["bias"])

    def apply(self, params: dict, feat_syn: torch.Tensor) -> torch.Tensor:
        """[B, n, n] normalized adjacencies."""
        with span("generator.score"):
            scores = self.scores(params, feat_syn)
            count("generator.scored_entries", self.rows.shape[0])
        with span("generator.scatter"):
            adj = scores.new_zeros((self.batch, self.n, self.n))
            adj = adj.index_put(self.target, scores[self.last])
            adj = (adj.transpose(1, 2) + adj) / 2
        with span("generator.norm"):
            return G.normalize_adj_dense(adj, add_loops=True)


class MSGC(GCond):
    alternation = "epoch"

    def __init__(self, data, args):
        args = args.replace(batch_adj=max(args.batch_adj, 1))
        super().__init__(data, args)
        dev = data.device
        # MSGC sizes n_syn directly and allocates labels proportionally
        labels_pool = data.labels_for_reduction()
        self.n_syn = max(int(labels_pool.shape[0] * args.reduction_rate),
                         data.nclass)
        y_syn = proportional_labels(labels_pool, self.n_syn, data.nclass)
        self.y_syn = y_syn
        self.batch_size = args.batch_adj
        self.budgets = {c: int((y_syn == c).sum())
                        for c in range(data.nclass)}
        self.classes = sorted(self.budgets)
        # matching runs against the labels tiled once per skeleton
        self.labels_syn = torch.as_tensor(
            np.tile(y_syn, self.batch_size).astype(np.int64), device=dev)
        self._build_class_tables()
        with span("msgc.skeletons", batch=self.batch_size):
            self.rows, self.cols, self.batches = build_skeletons(
                y_syn, data.nclass, self.batch_size, args.seed)
            count("msgc.skeleton_entries", self.rows.shape[0])
        self.pge = EdgeScorer(self.d, self.n_syn, self.batch_size,
                              self.rows, self.cols, self.batches, dev)
        self._window: collections.deque = collections.deque(maxlen=WINDOW)

    # -- generator hooks ------------------------------------------------
    def get_adj_batch(self, params: dict, feat_syn: torch.Tensor
                      ) -> torch.Tensor:
        """[B, n, n] normalized adjacencies (``get_adj_t_syn``)."""
        return self.pge.apply(params, feat_syn)

    def syn_adj_norm(self, pge_params, feat_syn):
        return self.get_adj_batch(pge_params, feat_syn)

    def generator_forward(self, pge_params, feat_syn):
        return self.get_adj_batch(pge_params, feat_syn), 0.0

    def inference_adj(self, pge_params, feat_syn):
        with torch.no_grad():
            return self.get_adj_batch(pge_params, feat_syn.detach())

    def inner_adj(self, pge_params, feat_syn):
        # get_adj_batch is already normalized
        return self.inference_adj(pge_params, feat_syn)

    # -- plumbing -------------------------------------------------------
    def init_feat_syn(self, verbose: bool = False) -> torch.Tensor:
        """Init against the un-tiled label vector (the features are shared
        by the skeletons)."""
        from graphslim_tpu_torch.reduce.registry import create_reducer

        with span("msgc.init", init=self.args.init):
            init_args = self.args.replace(method=self.args.init)
            agent = create_reducer(self.args.init, self.data, init_args,
                                   labels_syn_override=self.y_syn)
            return agent.reduce(self.data, verbose=verbose).feat.clone()

    def intermediate_evaluation(self, feat_syn, adj_syn, best_val, it,
                                loss_avg, verbose=False):
        """Evaluate the mean of the last ``WINDOW`` snapshots."""
        self._window.append((feat_syn.detach().clone(),
                             adj_syn.detach().clone()))
        feat_avg = sum(w[0] for w in self._window) / len(self._window)
        adj_avg = sum(w[1] for w in self._window) / len(self._window)
        return super().intermediate_evaluation(
            feat_avg, adj_avg, best_val, it, loss_avg, verbose)
