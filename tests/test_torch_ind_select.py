"""The selecting and clustering reducers of the port in the inductive
setting, against the JAX package (CPU, synth-ind-small at r = 0.25: a
train subgraph of 100 nodes, 20 per class).

Every reducer here works on the train subgraph with local ids.  A
leftover global id would index the wrong rows without raising, so the
coresets are compared on the ids they select (equal, and all below the
train subgraph's size), and every reducer on its output arrays, at the
tolerances of its transductive test: features to 1e-5 (1e-6 for
means), adjacencies to 1e-6, labels and mined trees exactly, VNG's
virtual graph to 1e-4 of its largest entry.  The JAX draws torch cannot
follow come in through the same seams as there (``init_rows``, the
injected embeddings, Mirage's quantization, VNG's fitted weights).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphslim_tpu.reduce.mirage as jmirage
import graphslim_tpu.reduce.vng as jvng
from graphslim_tpu import graph as JG
from graphslim_tpu import models as JM
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import coreset as JC
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu.reduce.gecc import GECC as JGECC
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import coreset as C
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce import mirage as tmirage
from graphslim_tpu_torch.reduce.clustering import Cluster
from graphslim_tpu_torch.reduce.gecc import GECC
from graphslim_tpu_torch.reduce.vng import VNG

NAME = "synth-ind-small"


@pytest.fixture(scope="module")
def twins():
    return jload(NAME, seed=0), load(NAME, seed=0, device="cpu")


def _args(save, method, **kw):
    base = dict(dataset=NAME, method=method, save_path=save,
                eval_epochs=20, **kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max()


def _recording(cls, seen):
    """``cls.select_class`` wrapped to record the ids it selects."""
    inner = cls.select_class

    def select_class(self, feats, cnt, pool_global):
        local = inner(self, feats, cnt, pool_global)
        seen.append(np.asarray(pool_global)[np.asarray(local)][:cnt])
        return local
    return mock.patch.object(cls, "select_class", select_class)


def _reduce_both(jagent, tagent, jds, tds):
    jseen, tseen = [], []
    with _recording(type(jagent), jseen), _recording(type(tagent), tseen):
        jred, tred = jagent.reduce(jds), tagent.reduce(tds)
    assert len(jseen) == len(tseen) == tds.nclass
    for j, t in zip(jseen, tseen):
        np.testing.assert_array_equal(t, j)
        assert t.max() < len(tds.idx_train)
    return jred, tred


def test_the_twin_is_inductive(twins):
    jds, tds = twins
    assert tds.setting == jds.setting == "ind"
    assert tds.feat_train.shape == (100, tds.n_feat)
    _, targs = _args("unused", "random")
    assert targs.setting == "ind" and targs.reduction_rate == 0.25


@pytest.mark.parametrize("method,agg,cls", [
    ("random", False, "Random"), ("cent_d", False, "CentD"),
    ("cent_p", False, "CentP"), ("random", True, "RandomAgg"),
    ("kcenter", True, "KCenterAgg"), ("herding", True, "HerdingAgg")])
def test_model_free_coresets_match_jax(twins, tmp_path, method, agg, cls):
    jds, tds = twins
    jargs, targs = _args(str(tmp_path), method, agg=agg)
    jagent, tagent = jcreate(method, jds, jargs), \
        create_reducer(method, tds, targs)
    assert type(tagent).__name__ == type(jagent).__name__ == cls
    jred, tred = _reduce_both(jagent, tagent, jds, tds)
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    _close(tred.feat.numpy(), jred.feat)
    if agg:
        assert tred.adj is None and jred.adj is None
    else:
        np.testing.assert_allclose(tred.dense_adj().numpy(),
                                   np.asarray(jred.adj.to_dense()),
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["kcenter", "herding", "kcenter_sample"])
def test_model_based_coresets_match_jax_on_the_same_embeddings(
        twins, tmp_path, monkeypatch, method):
    jds, tds = twins
    jargs, targs = _args(str(tmp_path), method)
    emb = np.random.default_rng(11).normal(
        size=(len(tds.idx_train), 24)).astype(np.float32)
    jagent, tagent = jcreate(method, jds, jargs), \
        create_reducer(method, tds, targs)
    monkeypatch.setattr(jagent, "_embeddings",
                        lambda data, verbose: jnp.asarray(emb))
    monkeypatch.setattr(tagent, "_embeddings",
                        lambda data, verbose: torch.as_tensor(emb))
    jred, tred = _reduce_both(jagent, tagent, jds, tds)
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    np.testing.assert_array_equal(tred.feat.numpy(), np.asarray(jred.feat))
    np.testing.assert_allclose(tred.dense_adj().numpy(),
                               np.asarray(jred.adj.to_dense()), atol=1e-6)


def _spy_fit(module, seen):
    fit = module.fit_with_val

    def spy(*a, **kw):
        seen.append((kw["train"], kw["val"]))
        return fit(*a, **kw)
    return mock.patch.object(module, "fit_with_val", spy)


def _same_batch(t, j):
    """A trainer tuple (x, normalized adjacency, y, idx) of each side."""
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].col.numpy(), np.asarray(j[1].col))
    np.testing.assert_array_equal(t[1].val.numpy(), np.asarray(j[1].val))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[3] is None and j[3] is None


def test_kcenter_gcn_fits_the_train_subgraph_as_jax(twins, tmp_path):
    """The embedding GCN trains on the train subgraph and validates on
    that same graph (the JAX package's quirk, kept for parity)."""
    jds, tds = twins
    jargs, targs = _args(str(tmp_path), "kcenter")
    jseen, tseen = [], []
    with _spy_fit(JM, jseen), _spy_fit(M, tseen):
        jemb = jcreate("kcenter", jds, jargs)._embeddings(jds, False)
        agent = create_reducer("kcenter", tds, targs)
        temb = agent._embeddings(tds, False)
    assert temb.shape == tuple(jemb.shape) == (100, tds.nclass)
    for t, j in zip(tseen[0], jseen[0]):
        _same_batch(t, j)
    _same_batch(tseen[0][1], tseen[0][0])
    assert agent.embed_model[2] is tds.view_norm("train")


def _jax_cluster_rows(agent, split_per_class) -> dict:
    """Class → the rows the JAX package's k-means starts from."""
    labels = agent.data.labels_for_reduction()
    key = jax.random.key(agent.args.seed)
    rows = {}
    for c, n_c in agent.budgets.items():
        key, kc, *_ = jax.random.split(key, split_per_class)
        n = int((labels == c).sum())
        k = int(min(n_c, n))
        if n > k:
            rows[c] = np.asarray(jax.random.choice(kc, n, shape=(k,),
                                                   replace=False))
    return rows


@pytest.mark.parametrize("method,agg", [("clustering", False),
                                        ("clustering", True),
                                        ("averaging", False)])
def test_clustering_family_matches_jax(twins, tmp_path, method, agg):
    jds, tds = twins
    jargs, targs = _args(str(tmp_path), method, agg=agg)
    jred = jcreate(method, jds, jargs).reduce(jds)
    agent = create_reducer(method, tds, targs)
    rows = _jax_cluster_rows(agent, 2)
    with mock.patch.object(Cluster, "init_rows",
                           lambda self, c, n, k, gen: torch.tensor(rows[c])):
        tred = agent.reduce(tds)
    assert tred.adj is None and jred.adj is None
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    _close(tred.feat.numpy(), jred.feat,
           1e-6 if method == "averaging" else 1e-5)
    if agg:
        norm = JG.gcn_norm(jds.adj_train)
        _close(agent._train_feats(tds).numpy(),
               norm.matmul(norm.matmul(jds.feat_train)))


@pytest.mark.parametrize("fuzziness", [1.0, 1.3])
def test_gecc_matches_jax(twins, tmp_path, fuzziness):
    jds, tds = twins
    jargs, targs = _args(str(tmp_path), "gecc", fuzziness=fuzziness)
    jagent = JGECC(jds, jargs)
    _close(GECC(tds, targs)._aggregate(tds).numpy(),
           jagent._aggregate(jds))
    jred = jagent.reduce(jds)
    agent = create_reducer("gecc", tds, targs)
    rows = _jax_cluster_rows(agent, 3)
    with mock.patch.object(GECC, "init_rows",
                           lambda self, c, n, k, gen: torch.tensor(rows[c])):
        tred = agent.reduce(tds)
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    _close(tred.feat.numpy(), jred.feat)


def test_gecc_sampled_aggregation_on_the_train_subgraph(twins, tmp_path):
    _, tds = twins
    agent = GECC(tds, _args(str(tmp_path), "gecc")[1])
    agent.sample_fanout = int(np.diff(tds.view_host("train").indptr).max()
                              ) + 1
    agent.sample_batch = 32
    exact = agent._aggregate(tds)
    assert exact.shape[0] == len(tds.idx_train)
    _close(agent._aggregate_sampled(tds, tds.pool_ids()).numpy(),
           exact.numpy())


def test_mirage_matches_jax_given_the_quantization(twins, tmp_path):
    """Every node of the train subgraph is a root."""
    jds, tds = twins
    jargs, targs = _args(str(tmp_path), "mirage")
    seen = {}
    kmeans = jmirage.kmeans

    def spy(key, x, k, *a, **kw):
        out = kmeans(key, x, k, *a, **kw)
        seen["labels"] = np.asarray(out[1])
        seen["n"] = x.shape[0]
        return out

    with mock.patch.object(jmirage, "kmeans", spy):
        jred = jcreate("mirage", jds, jargs).reduce(jds)
    assert seen["n"] == len(tds.idx_train)
    with mock.patch.object(tmirage.Mirage, "node_labels",
                           lambda self, feat, k: seen["labels"]):
        tred = create_reducer("mirage", tds, targs).reduce(tds)
    np.testing.assert_array_equal(tred.feat.numpy(), np.asarray(jred.feat))
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    np.testing.assert_array_equal(tred.adj.row.numpy(),
                                  np.asarray(jred.adj.row))
    np.testing.assert_array_equal(tred.adj.col.numpy(),
                                  np.asarray(jred.adj.col))


def test_vng_matches_jax(twins, tmp_path):
    """Fit on the train subgraph, validation on the val subgraph; given
    the JAX package's fitted weights and k-means start the virtual graph
    agrees to 1e-4 of its largest entry."""
    jds, tds = twins
    base = dict(condense_model="GCN", hidden=16)
    jargs, targs = _args(str(tmp_path), "vng", **base)
    seen = {}
    kmeans, fit = jvng.kmeans, JM.fit_with_val

    def spy_kmeans(key, x, k, *a, **kw):
        out = kmeans(key, x, k, *a, **kw)
        seen.update(n=x.shape[0], key=key, k=k)
        return out

    def spy_fit(*a, **kw):
        out = fit(*a, **kw)
        seen.update(params=jax.tree.map(np.asarray, out[0]),
                    batches=(kw["train"], kw["val"]))
        return out

    with mock.patch.object(jvng, "kmeans", spy_kmeans), \
            mock.patch.object(JM, "fit_with_val", spy_fit):
        jred = jcreate("vng", jds, jargs).reduce(jds)
    assert seen["n"] == len(tds.idx_train)
    params = model_params_from_jax("GCN", seen["params"], device="cpu")
    rows = np.asarray(jax.random.choice(seen["key"], seen["n"],
                                        shape=(seen["k"],), replace=False))
    tseen = []

    def fake_fit(*a, **kw):
        tseen.append((kw["train"], kw["val"]))
        return params, None, None

    with mock.patch.object(M, "fit_with_val", fake_fit), \
            mock.patch.object(VNG, "init_rows",
                              lambda self, n, k, gen: torch.tensor(rows)):
        tred = create_reducer("vng", tds, targs).reduce(tds)
    for t, j in zip(tseen[0], seen["batches"]):
        _same_batch(t, j)
    _close(tred.feat.numpy(), jred.feat, 1e-4)
    _close(tred.adj.numpy(), jred.adj, 1e-4)
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))


@pytest.mark.parametrize("name", ["kcenter_select", "herding_select"])
def test_pagerank_and_greedy_agree_on_the_train_subgraph(twins, name):
    jds, tds = twins
    want = np.asarray(JC.pagerank(jds.adj_train))
    got = C.pagerank(tds.adj_train).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * want.max(), rtol=0)
    x = tds.feat_train.numpy()
    np.testing.assert_array_equal(
        getattr(C, name)(torch.as_tensor(x), 7).numpy(),
        np.asarray(getattr(JC, name)(jnp.asarray(x), 7)))
