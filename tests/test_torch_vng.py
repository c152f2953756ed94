"""VNG in the port against the JAX package (CPU, synth-hard at r = 0.5,
GCN condense model, hidden 16, 20 training epochs).

The JAX package builds the training subgraph's adjacency and the
membership matrix ``E`` densely (``graphslim_tpu/reduce/vng.py:73-94``);
the port forms neither.  The test runs the JAX VNG, captures what its
k-means saw and gave (the concatenated embeddings ``x_head``, the
degree weights ``col_sum`` and the assignment), and hands the same three
to the port's :func:`virtual_graph`: ``x_vr`` and ``A_vr`` agree to 1e-4
of their largest entry (float32; ``A_vr`` goes through an SVD
pseudo-inverse) and the labels are equal.  ``layer_features`` of a GCN
with the JAX weights carried across agrees to 1e-5 relative, and a whole
VNG run with the JAX package's fitted weights and initial k-means rows
injected gives its triple to the same 1e-4.  No path of the port's VNG
densifies a sparse adjacency.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

import graphslim_tpu.reduce.vng as jvng
from graphslim_tpu import graph as JG
from graphslim_tpu import models as JM
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.vng import VNG, virtual_graph


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX VNG's triple, with what its k-means and its fit saw."""
    save = str(tmp_path_factory.mktemp("vng"))
    base = dict(dataset="synth-hard", method="vng", save_path=save,
                condense_model="GCN", hidden=16, eval_epochs=20)
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    seen = {}
    kmeans, fit = jvng.kmeans, JM.fit_with_val

    def spy_kmeans(key, x, k, *a, **kw):
        out = kmeans(key, x, k, *a, **kw)
        seen.update(x_head=np.asarray(x), col_sum=np.asarray(
            kw["weights"]), assign=np.asarray(out[1]), key=key, k=k)
        return out

    def spy_fit(*a, **kw):
        out = fit(*a, **kw)
        seen["params"] = jax.tree.map(np.asarray, out[0])
        return out

    with mock.patch.object(jvng, "kmeans", spy_kmeans), \
            mock.patch.object(JM, "fit_with_val", spy_fit):
        jred = jcreate("vng", jds, jfinalize(JArgs(**base), set(base)))\
            .reduce(jds)
    targs = finalize(Args(**base, device="cpu"), set(base))
    return dict(jds=jds, tds=tds, jred=jred, targs=targs, **seen)


def _close_to_max(got, ref, rtol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max()


def test_virtual_graph_matches_the_dense_formulas(run):
    tds = run["tds"]
    idx = np.asarray(tds.idx_train)
    adj_tr = G.submatrix(tds.adj_host, idx, device="cpu")
    n_syn = run["k"]
    x_vr, a_vr, labels = virtual_graph(
        torch.tensor(run["x_head"]), torch.tensor(run["assign"]),
        torch.tensor(run["col_sum"]), tds.feat[idx], adj_tr,
        tds.labels[idx], n_syn, tds.nclass)
    jred = run["jred"]
    assert n_syn == 50 and a_vr.shape == (n_syn, n_syn)
    _close_to_max(x_vr.numpy(), jred.feat)
    _close_to_max(a_vr.numpy(), jred.adj)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jred.labels))


def test_layer_features_match_jax(run):
    jds, tds = run["jds"], run["tds"]
    cfg = dict(nfeat=tds.n_feat, nhid=16, nclass=tds.nclass, nlayers=2,
               dropout=0.0)
    jmodel = JM.get_model("GCN", JM.ModelConfig(**cfg))
    params = jmodel.init(jax.random.key(5))
    want = jmodel.layer_features(params, jds.feat, JG.gcn_norm(jds.adj))
    got = M.get_model("GCN", M.ModelConfig(**cfg)).layer_features(
        model_params_from_jax("GCN", jax.tree.map(np.asarray, params),
                              device="cpu"), tds.feat, tds.adj_norm())
    assert [g.shape[1] for g in got] == [16, tds.nclass]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


def test_whole_run_matches_jax(run):
    """The port's VNG end to end, given the JAX package's fitted weights
    and its k-means start (rows of ``key(2024)``'s draw)."""
    tds, targs = run["tds"], run["targs"]
    params = model_params_from_jax("GCN", run["params"], device="cpu")
    rows = np.asarray(jax.random.choice(run["key"], run["x_head"].shape[0],
                                        shape=(run["k"],), replace=False))
    agent = create_reducer("vng", tds, targs)
    assert type(agent) is VNG
    with mock.patch.object(M, "fit_with_val",
                           lambda *a, **kw: (params, None, None)), \
            mock.patch.object(VNG, "init_rows",
                              lambda self, n, k, gen: torch.tensor(rows)), \
            mock.patch.object(G.SparseAdj, "to_dense",
                              side_effect=AssertionError("densified")):
        red = agent.reduce(tds)
    jred = run["jred"]
    _close_to_max(red.feat.numpy(), jred.feat)
    _close_to_max(red.adj.numpy(), jred.adj)
    np.testing.assert_array_equal(red.labels.numpy(),
                                  np.asarray(jred.labels))
