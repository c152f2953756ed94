"""The port's experiment tracking against the JAX package's (CPU).

``graph_summary`` gives the JAX function's dict; ``build_tracker`` falls
back to ``NullTracker`` with a warning when WandB cannot be imported (the
import is blocked here, whether or not the package is installed), and
raises under ``wandb_required``.  ``train_all.run(..., wandb=True)`` logs
the original graph's and the reduced graph's summaries and the accuracy;
the reduced graph's edge count is taken from what is stored (a
``SparseAdj``'s nonzero values, a dense tensor's nonzeros) and equals the
nonzeros of ``dense_adj()``, the JAX package's count, for a dense, a
sparse and no adjacency.
"""

import logging
import sys
from unittest import mock

import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import tracking as JT
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import tracking as T
from graphslim_tpu_torch import train_all as TA
from graphslim_tpu_torch.config import Args, finalize


@pytest.mark.parametrize("n,e", [(0, 0), (1, 0), (2, 2), (1354, 912_345),
                                 (169_343, 2_315_598)])
def test_graph_summary_equals_jax(n, e):
    assert T.graph_summary(n, e) == JT.graph_summary(n, e)


@pytest.fixture
def no_wandb():
    with mock.patch.dict(sys.modules, {"wandb": None}):
        yield


def test_build_tracker_falls_back_to_null_with_a_warning(no_wandb, caplog):
    args = finalize(Args(wandb=True, device="cpu"), {"wandb"})
    with caplog.at_level(logging.WARNING, logger="graphslim_tpu_torch"):
        tracker = T.build_tracker(args)
    assert isinstance(tracker, T.NullTracker)
    assert "wandb unavailable" in caplog.text
    assert isinstance(T.build_tracker(args.replace(wandb=False)),
                      T.NullTracker)
    assert type(JT.build_tracker(args)).__name__ == "NullTracker"


def test_build_tracker_raises_under_wandb_required(no_wandb):
    args = finalize(Args(wandb=True, wandb_required=True, device="cpu"),
                    {"wandb", "wandb_required"})
    with pytest.raises(ImportError):
        T.build_tracker(args)


class _Recording(T.NullTracker):
    def __init__(self):
        self.graphs, self.metrics, self.finished = {}, [], False

    def log_graph(self, name, summary):
        self.graphs[name] = summary

    def log_metrics(self, metrics, step=None):
        self.metrics.append(metrics)

    def finish(self):
        self.finished = True


@pytest.mark.parametrize("method,kind", [("gcond", torch.Tensor),
                                         ("kcenter", G.SparseAdj),
                                         ("gcondx", type(None))])
def test_run_with_wandb_logs_the_graphs_and_the_accuracy(tmp_path, no_wandb,
                                                         method, kind):
    args = finalize(Args(dataset="synth-small", method=method, epochs=1,
                         run_eval=1, eval_epochs=5, wandb=True,
                         save_path=str(tmp_path), device="cpu"),
                    {"epochs", "run_eval", "eval_epochs", "wandb"})
    seen, trackers = {}, []
    create = TA.create_reducer

    def create_seen(m, data, a, **kw):
        agent = create(m, data, a, **kw)
        reduce = agent.reduce
        agent.reduce = lambda *x, **k: seen.setdefault(
            "red", reduce(*x, **k))
        return agent

    def build(a):
        assert a.wandb
        trackers.append(_Recording())
        return trackers[0]

    with mock.patch.object(TA, "create_reducer", create_seen), \
            mock.patch.object(TA, "build_tracker", build):
        mean, std = TA.run(args)
    tracker, red = trackers[0], seen["red"]
    assert isinstance(red.adj, kind)
    want = int((red.dense_adj() != 0).sum()) if red.adj is not None \
        else red.n_syn
    assert TA.reduced_edges(red) == want
    assert tracker.graphs["reduced"] == T.graph_summary(red.n_syn, want)
    assert tracker.graphs["original"]["nodes"] == 600
    assert tracker.metrics == [{"acc_mean": mean, "acc_std": std}]
    assert tracker.finished


def test_reduced_edges_never_densifies_a_sparse_adjacency():
    adj = G.from_edge_index(torch.tensor([[0, 1, 2], [1, 2, 0]]).numpy(), 3,
                            edge_weight=torch.tensor([1.0, 0.0, 2.0]).numpy(),
                            dedup=False, device="cpu")
    red = G.Reduced(feat=torch.zeros(3, 2), adj=adj,
                    labels=torch.zeros(3, dtype=torch.long))
    with mock.patch.object(G.SparseAdj, "to_dense",
                           side_effect=AssertionError("densified")):
        assert TA.reduced_edges(red) == 2
