"""The seven structural coarseners of the port against the JAX package
(CPU).

* The proximity family (heavy_edge, algebraic_jc, affinity_gs, all ten
  ``coarsen_measure``s, the ``optimal`` blossom strategy) and Kron return
  triples equal bit for bit to the JAX package's on synth-small
  (transductive) and synth-ind-small (inductive), with the JAX native
  library asserted loaded.
* The variation family reads a first-K Laplacian basis from a float32
  ``eigh`` (the JAX package's ``jnp.linalg.eigh``, the port's
  ``torch.linalg.eigh``).  Through the seam :meth:`CoarsenBase.basis`,
  given the JAX package's basis, its triples are equal bit for bit too.
  Given one eigendecomposition, the two ``_first_k_basis`` are equal bit
  for bit on every column, column 0 with its λ₀ mask and ``λ^-1/2``
  included.  Without the seam the port's own basis is held through the
  costs it gives the candidate sets, on the columns float32 determines
  (column 0, the null space, is rounding in both packages, and the
  columns of an eigenvalue cluster cut by the K-th are left out): every
  cost to 1e-4 of the largest, and each of the cheapest ``floor(r·n)``,
  the sets the first level can pop, to a relative error against a
  float64 basis's costs of at most 1e-4 or three times the JAX package's
  own float32 error there, whichever is larger.  A basis rounded to
  float16 or missing its ``λ^-1/2`` fails that bound.
* The departures: a component's submatrix is cut as ``W[nodes][:,
  nodes]``, equal to the ``np.ix_`` cut entry for entry; only the
  variation family computes the basis.
* The evaluator refuses a triple with no rows and trains on a graph with
  no edges (its normalized Â is the identity).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch
from torch_shared import (basis64, cheapest_relative_errors,
                          determined_columns, first_level_costs,
                          jax_native_lib)
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import coarsening as JC
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.reduce import coarsening as TC
from graphslim_tpu_torch.reduce import create_reducer

DATASETS = ["synth-small", "synth-ind-small"]
VARIATION = ["variation_neighborhoods", "variation_edges",
             "variation_cliques"]
MEASURES = ["heavy_edge", "heavy_edge_degree", "algebraic_JC",
            "algebraic_GS", "affinity_GS", "min_expected_loss",
            "min_expected_gradient_loss", "rss", "rss_lanczos", "rss_cheby"]

@pytest.fixture(scope="module")
def datasets():
    assert jax_native_lib() is not None, "the JAX package's native " \
        "library did not load: its fallbacks would be compared"
    return {name: (jload(name, seed=0), load(name, seed=0, device="cpu"))
            for name in DATASETS}


def _args(dataset, method, save, **kw):
    base = dict(dataset=dataset, method=method, save_path=save, **kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def assert_same_triple(tred, jred):
    """Equal bit for bit: features, labels, and the adjacency's entries."""
    np.testing.assert_array_equal(tred.feat.numpy(), np.asarray(jred.feat))
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    assert tred.adj.n_rows == jred.adj.n_rows
    for got, ref in ((tred.adj.indptr, jred.adj.indptr),
                     (tred.adj.row, jred.adj.row),
                     (tred.adj.col, jred.adj.col),
                     (tred.adj.values_or_ones(), jred.adj.values_or_ones())):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _both(datasets, tmp_path, dataset, method, seam=False, **kw):
    """(port triple, JAX triple, the port's basis calls); with ``seam``
    the port reads the JAX package's basis."""
    jds, tds = datasets[dataset]
    jargs, targs = _args(dataset, method, str(tmp_path), **kw)
    jred = jcreate(method, jds, jargs).reduce(jds)
    agent = create_reducer(method, tds, targs)
    calls = []

    def basis(W):
        calls.append(W.shape[0])
        return JC._first_k_basis(W, agent.K) if seam else \
            TC._first_k_basis(W, agent.K, tds.device)

    agent.basis = basis
    return agent.reduce(tds), jred, calls


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("method", ["heavy_edge", "algebraic_jc",
                                    "affinity_gs", "kron"])
def test_triples_equal_jax(datasets, tmp_path, dataset, method):
    tred, jred, calls = _both(datasets, tmp_path, dataset, method)
    assert_same_triple(tred, jred)
    assert 0 < tred.n_syn < datasets[dataset][1].train_graph()[0].shape[0]
    # departure (b): the proximity family and Kron never read the basis
    assert calls == []


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("method", VARIATION)
def test_variation_triples_equal_jax_through_the_basis_seam(
        datasets, tmp_path, dataset, method):
    tred, jred, calls = _both(datasets, tmp_path, dataset, method,
                              seam=True)
    assert_same_triple(tred, jred)
    assert calls and tred.n_syn > 0


@pytest.mark.parametrize("measure", MEASURES)
def test_every_proximity_measure_equals_jax(datasets, tmp_path, measure):
    tred, jred, _ = _both(datasets, tmp_path, "synth-small", "heavy_edge",
                          coarsen_measure=measure)
    assert_same_triple(tred, jred)


@pytest.mark.parametrize("method", ["heavy_edge", "variation_edges"])
def test_optimal_strategy_equals_jax(datasets, tmp_path, method):
    tred, jred, _ = _both(datasets, tmp_path, "synth-small", method,
                          seam=True, coarsen_strategy="optimal")
    assert_same_triple(tred, jred)
    greedy, _, _ = _both(datasets, tmp_path, "synth-small", method,
                         seam=True)
    assert not torch.equal(greedy.feat, tred.feat) or \
        greedy.adj.nnz != tred.adj.nnz


def _components(dataset):
    """(W, [component nodes]) of the graph reducers consume: the
    components of more than 10 nodes."""
    W = TC._to_scipy(dataset.train_host())
    n_comp, comp = csgraph.connected_components(W, directed=False)
    nodes = [np.flatnonzero(comp == c) for c in range(n_comp)]
    return W, [v for v in nodes if len(v) > 10]


def _variation_agents(datasets, dataset, method):
    """(port agent, JAX agent, args) of a variation coarsener, for calling
    ``contract_sets`` on one component."""
    _, tds = datasets[dataset]
    targs = _args(dataset, method, "unused")[1]
    agent = create_reducer(method, tds, targs)
    jcls = getattr(JC, type(agent).__name__)
    jagent = jcls.__new__(jcls)
    jagent.args = targs
    return agent, jagent, targs


def _component_costs(agent, jagent, Wc, bases):
    """(exact costs, the port's costs, the JAX package's costs, and those
    of each extra basis in ``bases``) on the determined columns; the exact
    ones from a float64 basis."""
    L = TC._laplacian(Wc).toarray()
    cols = determined_columns(L, agent.K)
    exact = first_level_costs(TC, agent, Wc, basis64(L, agent.K)[:, cols])
    got = first_level_costs(TC, agent, Wc,
                            TC._first_k_basis(Wc, agent.K, "cpu")[:, cols])
    ref = first_level_costs(JC, jagent, Wc,
                            JC._first_k_basis(Wc, agent.K)[:, cols])
    extra = [first_level_costs(TC, agent, Wc, B(Wc)[:, cols])
             for B in bases]
    return exact, got, ref, extra


def _cheapest_bound(exact, ref, n, r):
    """1e-4 relative, or three times the JAX package's own float32 error
    on the cheapest sets, whichever is larger."""
    return max(1e-4, 3 * cheapest_relative_errors(exact, n, r, ref)[0])


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("method", VARIATION)
def test_variation_costs_without_the_seam(datasets, dataset, method):
    agent, jagent, targs = _variation_agents(datasets, dataset, method)
    W, comps = _components(datasets[dataset][1])
    for nodes in comps:
        Wc = sp.csr_matrix(W[nodes][:, nodes])
        exact, got, ref, _ = _component_costs(agent, jagent, Wc, [])
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(got))
        err = np.abs(got[fin] - ref[fin]).max()
        assert err <= 1e-4 * np.abs(ref[fin]).max(), (len(nodes), err)
        bound = _cheapest_bound(exact, ref, len(nodes), targs.reduction_rate)
        rel, = cheapest_relative_errors(exact, len(nodes),
                                        targs.reduction_rate, got)
        assert rel <= bound, (len(nodes), rel, bound)


def _float16_basis(Wc):
    return TC._first_k_basis(Wc, 10, "cpu").astype(np.float16).astype(
        np.float32)


def _unscaled_basis(Wc):
    """U_K without ``λ^-1/2``: the eigenvectors alone."""
    _, U = torch.linalg.eigh(torch.as_tensor(TC._laplacian(Wc).toarray(),
                                             dtype=torch.float32))
    return U[:, :10].numpy()


@pytest.mark.parametrize("fault", [_float16_basis, _unscaled_basis],
                         ids=["float16", "no_lambda_scaling"])
def test_the_cheapest_cost_bound_fails_a_wrong_basis(datasets, fault):
    """The bound of ``test_variation_costs_without_the_seam`` rejects a
    basis rounded to float16 or missing its ``λ^-1/2``."""
    agent, jagent, targs = _variation_agents(
        datasets, "synth-small", "variation_neighborhoods")
    assert agent.K == 10
    W, comps = _components(datasets["synth-small"][1])
    for nodes in comps:
        Wc = sp.csr_matrix(W[nodes][:, nodes])
        exact, _, ref, (bad,) = _component_costs(agent, jagent, Wc, [fault])
        bound = _cheapest_bound(exact, ref, len(nodes), targs.reduction_rate)
        rel, = cheapest_relative_errors(exact, len(nodes),
                                        targs.reduction_rate, bad)
        assert rel > bound, (len(nodes), rel, bound)


@pytest.mark.parametrize("lam0", [0.0, -3e-7, 2e-7])
def test_first_k_basis_equals_jax_given_one_eigendecomposition(datasets,
                                                                lam0):
    """With both float32 ``eigh`` replaced by one decomposition, the two
    ``_first_k_basis`` agree bit for bit on every column: λ₀ below 1e-10
    (zero or negative rounding) zeroes column 0, a positive rounding
    scales it by ``λ₀^-1/2`` like every other column."""
    W, comps = _components(datasets["synth-small"][1])
    Wc = sp.csr_matrix(W[comps[0]][:, comps[0]])
    lam, U = np.linalg.eigh(TC._laplacian(Wc).toarray().astype(np.float64))
    lam, U = lam.astype(np.float32), U.astype(np.float32)
    lam[0] = lam0

    def torch_eigh(a):
        return torch.as_tensor(lam), torch.as_tensor(U)

    def jax_eigh(a):
        return jnp.asarray(lam), jnp.asarray(U)

    with mock.patch.object(torch.linalg, "eigh", torch_eigh):
        got = TC._first_k_basis(Wc, 10, "cpu")
    with mock.patch.object(JC.jnp.linalg, "eigh", jax_eigh):
        ref = JC._first_k_basis(Wc, 10)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref))
    if lam0 < 1e-10:
        assert not got[:, 0].any()
    else:
        np.testing.assert_allclose(got[:, 0], U[:, 0] / np.sqrt(lam0),
                                   rtol=1e-6)
    assert (np.abs(got[:, 1:]).max(0) > 0).all()


def test_component_submatrix_equals_the_ix_cut():
    """Departure (a): ``W[nodes][:, nodes]`` holds the entries of
    ``W[np.ix_(nodes, nodes)]`` in the same order, as does the host
    submatrix of the graph module."""
    rng = np.random.default_rng(4)
    n = 400
    ei = np.stack([rng.integers(0, n, 1500), rng.integers(0, n, 1500)])
    host = G.host_from_edge_index(
        ei, n, edge_weight=rng.uniform(0.5, 2, 1500).astype(np.float32),
        symmetrize=True)
    W = TC._to_scipy(host)
    _, comp = csgraph.connected_components(W, directed=False)
    for nodes in (np.flatnonzero(comp == comp[0]),
                  np.sort(rng.choice(n, 150, replace=False))):
        ref = sp.csr_matrix(W[np.ix_(nodes, nodes)])
        for got in (sp.csr_matrix(W[nodes][:, nodes]),
                    TC._to_scipy(G.host_submatrix(host, nodes))):
            np.testing.assert_array_equal(got.indptr, ref.indptr)
            np.testing.assert_array_equal(got.indices, ref.indices)
            np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("dataset", DATASETS)
def test_the_evaluator_refuses_an_empty_triple(datasets, dataset):
    _, tds = datasets[dataset]
    args = _args(dataset, "affinity_gs", "unused", eval_epochs=5,
                 run_eval=1)[1]
    empty = G.Reduced(
        feat=torch.zeros(0, tds.n_feat),
        adj=G.from_edge_index(np.zeros((2, 0), dtype=np.int64), 0,
                              device="cpu"),
        labels=torch.zeros(0, dtype=torch.int64))
    with pytest.raises(ValueError, match="no rows"):
        Evaluator(tds, args).evaluate(empty, "GCN")


@pytest.mark.parametrize("dataset", DATASETS)
def test_a_graph_with_no_edges_evaluates(datasets, dataset):
    _, tds = datasets[dataset]
    args = _args(dataset, "heavy_edge", "unused", eval_epochs=20,
                 run_eval=1)[1]
    feat, _, labels = tds.train_graph()
    rows = np.arange(0, feat.shape[0], 3)
    adj = G.from_edge_index(np.zeros((2, 0), dtype=np.int64), len(rows),
                            device="cpu")
    red = G.Reduced(feat=feat[rows], adj=adj, labels=labels[rows])
    assert torch.equal(G.gcn_norm(adj).to_dense(), torch.eye(len(rows)))
    (mean, std), _ = Evaluator(tds, args).evaluate(red, "GCN")
    assert 0.0 <= mean <= 1.0
