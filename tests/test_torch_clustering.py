"""Cluster, ClusterAgg and Average in the port against the JAX package
(CPU, synth-hard at r = 0.5: 50 synthetic rows over 5 classes).

The JAX package draws each class's initial centroid rows with
``jax.random.choice`` under a key split per class from ``key(seed)``;
torch cannot follow that stream, so the test computes those rows from the
same keys and hands them to the port through ``Cluster.init_rows``.

Tolerances: Average (a mean per class) to 1e-6 relative; Cluster and
ClusterAgg (30 Lloyd iterations in float32, products summed in another
order) to 1e-5 relative, with equal labels; the ``Â²X`` that ClusterAgg
clusters matches two products with the JAX package's ``gcn_norm`` to 1e-5
relative.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.clustering import (Average, Cluster,
                                                   ClusterAgg)


@pytest.fixture(scope="module")
def datasets():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


def _args(method, save, agg=False, **kw):
    base = dict(dataset="synth-hard", method=method, save_path=save,
                agg=agg, **kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def jax_init_rows(agent) -> dict:
    """Class → the rows the JAX package's k-means starts from (the key
    stream of ``graphslim_tpu/reduce/clustering.py::_reduce``)."""
    labels = agent.data.labels_for_reduction()
    key = jax.random.key(agent.args.seed)
    rows = {}
    for c, n_c in agent.budgets.items():
        key, kc = jax.random.split(key)
        n = int((labels == c).sum())
        if n > n_c:
            rows[c] = np.asarray(jax.random.choice(kc, n, shape=(n_c,),
                                                   replace=False))
    return rows


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max()


@pytest.mark.parametrize("method,agg", [("clustering", False),
                                        ("clustering", True),
                                        ("averaging", False)])
def test_reduced_triples_match_jax(datasets, tmp_path, method, agg):
    jds, tds = datasets
    jargs, targs = _args(method, str(tmp_path), agg=agg)
    jred = jcreate(method, jds, jargs).reduce(jds)
    agent = create_reducer(method, tds, targs)
    rows = jax_init_rows(agent)
    with mock.patch.object(type(agent), "init_rows",
                           lambda self, c, n, k, gen: torch.tensor(
                               rows[c])):
        tred = agent.reduce(tds)
    assert tred.adj is None and jred.adj is None
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    _close(tred.feat.numpy(), jred.feat,
           1e-6 if method == "averaging" else 1e-5)


def test_cluster_agg_features_match_jax_gcn_norm(datasets):
    jds, tds = datasets
    norm_j = JG.gcn_norm(jds.adj)
    ref = np.asarray(norm_j.matmul(norm_j.matmul(jds.feat)))
    agent = ClusterAgg(tds, _args("clustering", "unused", agg=True)[1])
    idx = np.asarray(tds.idx_train)
    _close(agent._train_feats(tds).numpy(), ref[idx], 1e-5)
    # the dataset's cached normalization is gcn_norm of its adjacency
    norm_t = G.gcn_norm(tds.adj)
    _close(norm_t.matmul(norm_t.matmul(tds.feat)).numpy(), ref, 1e-5)


@pytest.mark.parametrize("name,agg,cls", [
    ("clustering", False, Cluster), ("clustering", True, ClusterAgg),
    ("cluster", False, Cluster), ("cluster", True, ClusterAgg),
    ("averaging", False, Average), ("average", False, Average),
    ("averaging", True, Average)])
def test_registration(datasets, name, agg, cls):
    args = _args(name, "unused", agg=agg)[1]
    assert type(create_reducer(name, datasets[1], args)) is cls


@pytest.mark.parametrize("method", ["clustering", "averaging"])
def test_labels_syn_override_is_honoured(datasets, tmp_path, method):
    _, tds = datasets
    override = np.array([4, 4, 0, 1, 1, 1, 2, 3, 3, 0], dtype=np.int32)
    agent = create_reducer(method, tds, _args(method, str(tmp_path))[1],
                           labels_syn_override=override)
    red = agent.reduce(tds)
    np.testing.assert_array_equal(red.labels.numpy(), override)
    assert agent.budgets == {0: 2, 1: 3, 2: 1, 3: 2, 4: 2}
    assert red.feat.shape == (10, tds.n_feat)
    assert torch.isfinite(red.feat).all()


@pytest.mark.parametrize("init", ["clustering", "averaging"])
def test_condensers_take_the_init(datasets, tmp_path, init):
    """``--init clustering|averaging`` for a condenser: its synthetic
    features start as that reducer's output on its label budget."""
    _, tds = datasets
    _, targs = _args("gcondx", str(tmp_path), init=init)
    eng = create_reducer("gcondx", tds, targs)
    feat = eng.init_feat_syn()
    ref = create_reducer(init, tds, targs.replace(method=init),
                         labels_syn_override=eng.labels_syn.numpy()
                         ).reduce(tds).feat
    assert torch.equal(feat, ref) and feat.shape[0] == eng.n_syn
