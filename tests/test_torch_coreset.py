"""The port's coreset reducers against the JAX package (CPU, the
``synth-hard`` and ``cora`` twins).

Greedy selections and the model-free reducers must pick the same nodes on
both sides (equal indices; features at 1e-5, the float32 rounding of Â²X
computed in another order); PageRank agrees at 1e-6 relative to its
largest value.  The model-based reducers train a GCN whose random init
cannot be shared, so they are compared with the same embeddings injected on
both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import coreset as JC
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import coreset as C
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.train_all import run

DATASETS = ["synth-hard", "cora"]


@pytest.fixture(scope="module")
def twins():
    return {name: (jload(name, seed=0), load(name, seed=0, device="cpu"))
            for name in DATASETS}


def _both_args(tmp_path, **kw):
    kw = dict(save_path=str(tmp_path), eval_epochs=20, **kw)
    return jfinalize(JArgs(**kw)), finalize(Args(device="cpu", **kw))


def _features(shape, seed, duplicates=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if duplicates:                 # exact ties: the first index must win
        x[1::2] = x[0::2][: x[1::2].shape[0]]
    return x


@pytest.mark.parametrize("select", ["kcenter_select", "herding_select"])
@pytest.mark.parametrize("n,d,cnt,dup", [(200, 16, 20, False),
                                         (57, 5, 57, False),
                                         (64, 8, 12, True),
                                         (300, 40, 1, False)])
def test_greedy_selection_picks_the_same_nodes(select, n, d, cnt, dup):
    x = _features((n, d), seed=n + cnt, duplicates=dup)
    want = np.asarray(getattr(JC, select)(jnp.asarray(x), cnt))
    got = getattr(C, select)(torch.as_tensor(x), cnt).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == cnt


@pytest.mark.parametrize("name", DATASETS)
def test_pagerank_matches_jax(twins, name):
    jds, tds = twins[name]
    want = np.asarray(JC.pagerank(jds.adj))
    got = C.pagerank(tds.adj).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * want.max(), rtol=0)
    assert abs(got.sum() - want.sum()) < 1e-4


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("method,agg,cls", [
    ("cent_d", False, "CentD"), ("cent_p", False, "CentP"),
    ("random", True, "RandomAgg"), ("kcenter", True, "KCenterAgg"),
    ("herding", True, "HerdingAgg")])
def test_model_free_reducers_match_jax(twins, tmp_path, name, method, agg,
                                       cls):
    jds, tds = twins[name]
    jargs, targs = _both_args(tmp_path, dataset=name, method=method,
                              agg=agg)
    jagent = jcreate(method, jds, jargs)
    tagent = create_reducer(method, tds, targs)
    assert type(tagent).__name__ == type(jagent).__name__ == cls
    jred, tred = jagent.reduce(jds), tagent.reduce(tds)
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    np.testing.assert_allclose(tred.feat.numpy(), np.asarray(jred.feat),
                               atol=1e-5)
    if agg:
        assert tred.adj is None and jred.adj is None
    else:
        np.testing.assert_allclose(tred.dense_adj().numpy(),
                                   np.asarray(jred.adj.to_dense()),
                                   atol=1e-6)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("method", ["kcenter", "herding", "kcenter_sample"])
def test_model_based_reducers_match_jax_on_the_same_embeddings(
        twins, tmp_path, monkeypatch, name, method):
    jds, tds = twins[name]
    jargs, targs = _both_args(tmp_path, dataset=name, method=method)
    emb = _features((tds.n_nodes, 24), seed=11)
    jagent = jcreate(method, jds, jargs)
    tagent = create_reducer(method, tds, targs)
    assert tagent.needs_model and jagent.needs_model
    monkeypatch.setattr(jagent, "_embeddings",
                        lambda data, verbose: jnp.asarray(emb))
    monkeypatch.setattr(tagent, "_embeddings",
                        lambda data, verbose: torch.as_tensor(emb))
    jred, tred = jagent.reduce(jds), tagent.reduce(tds)
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    np.testing.assert_array_equal(tred.feat.numpy(), np.asarray(jred.feat))
    np.testing.assert_allclose(tred.dense_adj().numpy(),
                               np.asarray(jred.adj.to_dense()), atol=1e-6)


def test_kcenter_embeddings_come_from_a_trained_full_graph_gcn(twins,
                                                               tmp_path):
    _, tds = twins["synth-hard"]
    _, targs = _both_args(tmp_path, dataset="synth-hard", method="kcenter")
    agent = create_reducer("kcenter", tds, targs.replace(eval_epochs=40))
    emb = agent._embeddings(tds, False)
    assert emb.shape == (tds.n_nodes, tds.nclass)
    assert torch.isfinite(emb).all() and not emb.requires_grad
    model, params, norm, best_val = agent.embed_model
    assert norm is tds.adj_norm()
    assert float(best_val) > 1.0 / tds.nclass


@pytest.mark.parametrize("method,agg,model", [
    ("kcenter", False, "GCN"), ("herding", True, "SGC"),
    ("cent_p", False, "GCN"), ("cent_d", False, "SGC"),
    ("herding", False, "GCN"), ("kcenter_sample", False, "GCN")])
def test_train_all_runs_the_coresets_on_the_cpu(tmp_path, method, agg,
                                                model):
    args = finalize(Args(dataset="synth-hard", method=method, agg=agg,
                         eval_model=model, run_eval=2, eval_epochs=30,
                         save_path=str(tmp_path), device="cpu"),
                    explicit={"run_eval", "eval_epochs"})
    mean, std = run(args)
    assert np.isfinite(mean) and np.isfinite(std)
    assert mean > 1.5 / 4          # well above chance on 4 classes


def test_label_override_sizes_the_selection(twins, tmp_path):
    """The condensation-init path: sizes and order come from the caller's
    labels, as in the JAX package."""
    jds, tds = twins["synth-hard"]
    jargs, targs = _both_args(tmp_path, dataset="synth-hard",
                              method="herding", agg=True)
    override = np.array([0, 0, 1, 2, 2, 2, 3, 1], dtype=np.int32)
    jred = jcreate("herding", jds, jargs,
                   labels_syn_override=override).reduce(jds)
    tred = create_reducer("herding", tds, targs,
                          labels_syn_override=override).reduce(tds)
    np.testing.assert_array_equal(tred.labels.numpy(), override)
    np.testing.assert_array_equal(np.asarray(jred.labels), override)
    np.testing.assert_allclose(tred.feat.numpy(), np.asarray(jred.feat),
                               atol=1e-5)


def test_gcond_can_start_from_kcenter(twins, tmp_path):
    _, tds = twins["synth-hard"]
    args = finalize(Args(dataset="synth-hard", method="gcond",
                         init="kcenter", eval_epochs=10, device="cpu",
                         save_path=str(tmp_path)),
                    explicit={"eval_epochs"})
    eng = create_reducer("gcond", tds, args)
    feat = eng.init_feat_syn()
    assert feat.shape == (eng.n_syn, tds.n_feat)
    assert torch.isfinite(feat).all()
