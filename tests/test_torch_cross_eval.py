"""The port's evaluator over the eight models against the JAX package's
(CPU): ``evaluate`` and ``test`` on synth-hard (transductive) and
synth-ind-small (inductive), ``grid_search`` and ``train_cross``.

The JAX evaluator draws each run's initial parameters from its key
stream; the tests hand the same draws to the port through
``Evaluator.init_params`` (carried across by ``convert``).  The reduced
graph is dense (GAT takes its nonzeros as a ``SparseAdj``; MLP drops it).
The JAX package validates and tests a transductive graph through its ELL
layout, the port through the ``SparseAdj`` (GAT through the ELL): the
sums differ in order only, so each run's test accuracy is held to within
two test nodes of the JAX one, at hidden 32 (GAT: 8 heads of 4, the
float32 path).
"""

import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.eval import Evaluator as JEvaluator
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.graph import Reduced
from graphslim_tpu_torch.kernels.ell import EllAdj

MODELS = list(Evaluator.MODELS)
DATASETS = {"trans": "synth-hard", "ind": "synth-ind-small"}


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for setting, name in DATASETS.items():
        jds, tds = jload(name, seed=0), load(name, seed=0, device="cpu")
        if setting == "ind":
            feat, adj, labels = jds.feat_train, jds.adj_train, \
                jds.labels_train
            rows = np.arange(40)
        else:
            feat, adj, labels = jds.feat, jds.adj, jds.labels
            rows = np.asarray(jds.idx_train)[:60]
        dense = np.asarray(JG.submatrix(adj, rows).to_dense())
        feat, labels = np.asarray(feat)[rows], np.asarray(labels)[rows]
        jred = JG.Reduced(feat=jnp.asarray(feat), adj=jnp.asarray(dense),
                          labels=jnp.asarray(labels))
        tred = Reduced(feat=torch.tensor(feat), adj=torch.tensor(dense),
                       labels=torch.tensor(labels))
        out[setting] = (jds, tds, jred, tred)
    return out


def _agents(jds, tds, tmp, **kw):
    base = dict(dataset=tds.name, method="random", save_path=str(tmp),
                run_eval=2, eval_epochs=20, hidden=32, seed=3)
    base.update(kw)
    jargs = jfinalize(JArgs(**base), set(base))
    targs = finalize(Args(**base, device="cpu"), set(base))
    return JEvaluator(jds, jargs), Evaluator(tds, targs)


def _carry(jev, tev, model_type, seeds):
    """The port's seam hands run r the JAX evaluator's draw for a single
    run of seed ``seeds[r]``."""
    jmodel = jev._eval_model(model_type, tev.data.n_feat)
    carried = [model_params_from_jax(
        model_type, jax.tree.map(np.asarray, jmodel.init(jax.random.split(
            jax.random.split(jax.random.key(s), 1)[0])[0])),
        device="cpu") for s in seeds]
    tev.init_params = lambda mt, model, run, gen: carried[run]


@pytest.mark.parametrize("setting", sorted(DATASETS))
@pytest.mark.parametrize("model_type", MODELS)
def test_evaluate_and_test_match_jax(pairs, tmp_path, setting, model_type):
    """The port's two runs from the JAX draws of seeds 3 and 0 score what
    the JAX evaluator's single runs of those seeds score (``evaluate`` and
    ``test``; one compiled JAX program serves both)."""
    jds, tds, jred, tred = pairs[setting]
    jev, tev = _agents(jds, tds, tmp_path)
    n_test = (tds.labels_test.shape[0] if setting == "ind"
              else len(tds.idx_test))
    want = [float(jev.evaluate(jred, model_type, runs=1, seed=3)[1][0][0]),
            jev.test(jred, model_type, seed=0)]
    _carry(jev, tev, model_type, (3, 0))
    (mean, std), (accs, vals) = tev.evaluate(tred, model_type)
    assert accs.shape == vals.shape == (2,)
    assert np.abs(accs - np.asarray(want)).max() <= 2.0 / n_test + 1e-6
    _carry(jev, tev, model_type, (0,))
    assert abs(tev.test(tred, model_type, seed=0) - want[1]) <= \
        2.0 / n_test + 1e-6


def test_gat_reads_the_ell_when_transductive(pairs, tmp_path):
    for setting in DATASETS:
        jds, tds, _, _ = pairs[setting]
        _, tev = _agents(jds, tds, tmp_path)
        adj = tev._split_tuple("test", "GAT")[1]
        if setting == "trans":
            assert isinstance(adj, EllAdj) and adj is tds.adj_norm_ell()
        else:
            assert adj is tds.view_norm("test")
        assert tev._split_tuple("test", "GCN")[1] is \
            tds.split_batch("test")[1]


def test_grid_search_picks_the_best_mean_validation(pairs, tmp_path):
    jds, tds, _, tred = pairs["trans"]
    _, tev = _agents(jds, tds, tmp_path)
    grid = {"lr": [0.01, 0.001], "alpha": [0.1, 0.5],
            "weight_decay": [0.0]}
    (mean, std), combo = tev.grid_search(tred, "APPNP", param_grid=grid)
    scores = {}      # in the grid's order (keys sorted): the first wins
    for alpha in grid["alpha"]:
        for lr in grid["lr"]:
            sub = Evaluator(tds, tev.args.replace(lr=lr, alpha=alpha))
            (m, s), (_, vals) = sub.evaluate(tred, "APPNP")
            scores[(alpha, lr)] = (float(np.mean(vals)), m, s)
    best = max(scores, key=lambda k: scores[k][0])
    assert combo == {"alpha": best[0], "lr": best[1], "weight_decay": 0.0}
    assert (mean, std) == scores[best][1:]
    assert len(set(v[0] for v in scores.values())) > 1


def test_train_cross_gives_every_model_and_nans_a_failure(pairs, tmp_path,
                                                          caplog):
    jds, tds, _, tred = pairs["ind"]
    _, tev = _agents(jds, tds, tmp_path, run_eval=1)
    table = tev.train_cross(tred)
    assert list(table) == MODELS
    for mean, std in table.values():
        assert np.isfinite(mean) and np.isfinite(std) and 0 <= mean <= 1
    real = Evaluator.evaluate

    def flaky(self, reduced, model_type="GCN", **kw):
        if model_type == "GAT":
            raise RuntimeError("no edges")
        return real(self, reduced, model_type, **kw)

    with mock.patch.object(Evaluator, "evaluate", flaky), \
            caplog.at_level(logging.WARNING, logger="graphslim_tpu_torch"):
        table = tev.train_cross(tred, model_types=["GCN", "GAT"])
    assert np.isnan(table["GAT"]).all() and np.isfinite(table["GCN"]).all()
    assert "train_cross[GAT] failed: no edges" in caplog.text
