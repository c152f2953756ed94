"""The port's graph-property evaluation against the JAX package's (CPU).

Both run the same host SciPy arithmetic; what the port adds is reading its
inputs: a ``SparseAdj`` from its host mirror, a dense tensor copied back,
one-hot labels through ``argmax``.  Every metric is held to the JAX
package's at 1e-6 relative, on a ``SparseAdj``, a dense adjacency, no
adjacency and one-hot labels, and on the cora twin (2,708 nodes, so the
ARPACK branches of ``laplacian_trace`` and ``spectral_radius`` run: 1e-3
relative there, ``eigsh`` at ``tol=1e-4`` from ARPACK's own random start).
``compare`` is held on a transductive and an inductive twin.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_shared import dataset_pair, reduced_pair
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.eval import property as JP
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.eval import PropertyEvaluator
from graphslim_tpu_torch.eval import property as P

ARPACK = {"laplacian_trace", "spectral_radius"}


@pytest.fixture(scope="module")
def twins():
    return {name: dataset_pair(name) for name in
            ("synth-small", "synth-ind-small", "cora")}


def _close(got: dict, want: dict, rtol: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=rtol.get(k, 1e-6),
                                       abs=1e-12), k


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "dense", "none"])
def test_properties_match_jax(twins, kind, onehot):
    jds, tds = twins["synth-small"]
    jred, tred = reduced_pair(jds, kind, n=120, onehot=onehot)
    want = JP.PropertyEvaluator(jds, None).properties(
        jred.adj, jred.feat, jred.labels)
    got = PropertyEvaluator(tds, None).properties(tred.adj, tred.feat,
                                                  tred.labels)
    _close(got, want, {})
    assert ("davies_bouldin_agg" in got) == (kind != "none")


@pytest.mark.parametrize("metric", ["density", "laplacian_trace",
                                    "spectral_radius",
                                    "clustering_coefficient"])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_each_metric_on_the_ported_csr_matches_jax(twins, metric, kind):
    jds, _ = twins["synth-small"]
    jred, tred = reduced_pair(jds, kind, n=200)
    want = getattr(JP, metric)(JP._to_csr(jred.adj))
    got = getattr(P, metric)(P._to_csr(tred.adj))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_homophily_and_davies_bouldin_match_jax(twins):
    jds, tds = twins["synth-small"]
    labels = tds.labels.numpy()
    W = P._to_csr(tds.adj)
    assert P.homophily(W, labels) == JP.homophily(JP._to_csr(jds.adj),
                                                  np.asarray(jds.labels))
    assert P.davies_bouldin(tds.feat.numpy(), labels) == pytest.approx(
        JP.davies_bouldin(np.asarray(jds.feat), np.asarray(jds.labels)),
        rel=1e-6)
    assert P.homophily(sp.csr_matrix((5, 5)), np.zeros(5, int)) == 0.0
    assert P.davies_bouldin(np.ones((4, 2)), np.zeros(4, int)) == 0.0


def test_the_arpack_branch_on_a_large_graph_matches_jax(twins):
    jds, tds = twins["cora"]
    assert tds.n_nodes >= 2100
    want = JP.PropertyEvaluator(jds, None).properties(jds.adj, jds.feat,
                                                      jds.labels)
    got = PropertyEvaluator(tds, None).properties(tds.adj, tds.feat,
                                                  tds.labels)
    _close(got, want, {k: 1e-3 for k in ARPACK})


@pytest.mark.parametrize("name", ["synth-small", "synth-ind-small"])
@pytest.mark.parametrize("kind", ["sparse", "dense", "none"])
def test_compare_matches_jax(twins, name, kind):
    jds, tds = twins[name]
    jred, tred = reduced_pair(jds, kind)
    want = JP.PropertyEvaluator(jds, None).compare(jred)
    got = PropertyEvaluator(tds, None).compare(tred)
    for side in ("original", "reduced"):
        _close(got[side], want[side], {})


def test_to_csr_reads_the_host_mirror_not_the_tensors(twins):
    _, tds = twins["synth-small"]
    h = G.host_of(tds.adj)
    adj = h.to_sparse("cpu")
    want = P._to_csr(adj).toarray()
    adj.row = adj.col = adj.val = None      # no read-back possible
    assert np.array_equal(P._to_csr(adj).toarray(), want)
    dense = torch.as_tensor(want)
    assert np.array_equal(P._to_csr(dense).toarray(), want)
