"""GECC in the port against the JAX package (CPU, synth-hard).

* ``_aggregate`` (the weighted hop mix, through the SpMM dispatch in the
  port and the ELL layout in the JAX package) agrees to 1e-5 relative, at
  depth 2 and at depth 3 (which adds the 0.5-weighted third hop).
* The reduced triple, given the JAX package's initial centroid rows (the
  key stream of ``graphslim_tpu/reduce/gecc.py::_reduce``), agrees to 1e-5
  relative, with k-means (fuzziness 1) and with fuzzy c-means.
* Evolving centroids: reuse and truncation give the previous centroids
  exactly, as in the JAX package; growth keeps them as the first rows and
  adds finite new ones by incremental k-means++.
* ``_aggregate_sampled`` equals the exact hops to 1e-5 relative when the
  fanout is above the largest degree (every neighbour is sampled), and
  ``reduce`` takes it above a lowered ``sample_threshold``.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce.gecc import GECC as JGECC
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.gecc import GECC


@pytest.fixture(scope="module")
def datasets():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


def _args(save, **kw):
    base = dict(dataset="synth-hard", method="gecc", save_path=save, **kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max()


def jax_init_rows(agent) -> dict:
    """Class → the rows the JAX package's clustering starts from."""
    labels = agent.data.labels_for_reduction()
    key = jax.random.key(agent.args.seed)
    rows = {}
    for c, n_c in agent.budgets.items():
        key, kc, _ = jax.random.split(key, 3)
        n = int((labels == c).sum())
        k = int(min(n_c, n))
        if n > k:
            rows[c] = np.asarray(jax.random.choice(kc, n, shape=(k,),
                                                   replace=False))
    return rows


@pytest.mark.parametrize("depth", [2, 3])
def test_aggregate_matches_jax(datasets, tmp_path, depth):
    jds, tds = datasets
    jargs, targs = _args(str(tmp_path), depth=depth)
    want = JGECC(jds, jargs)._aggregate(jds)
    got = GECC(tds, targs)._aggregate(tds)
    assert targs.agg_gamma == -0.1 and targs.depth == depth
    _close(got.numpy(), want)


@pytest.mark.parametrize("fuzziness", [1.0, 1.3])
def test_reduced_triple_matches_jax(datasets, tmp_path, fuzziness):
    jds, tds = datasets
    jargs, targs = _args(str(tmp_path), fuzziness=fuzziness)
    jred = JGECC(jds, jargs).reduce(jds)
    agent = create_reducer("gecc", tds, targs)
    rows = jax_init_rows(agent)
    with mock.patch.object(GECC, "init_rows",
                           lambda self, c, n, k, gen: torch.tensor(rows[c])):
        tred = agent.reduce(tds)
    assert tred.adj is None and jred.adj is None
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    _close(tred.feat.numpy(), jred.feat)


def test_evolving_centroids(datasets, tmp_path):
    jds, tds = datasets
    _, small = _args(str(tmp_path), reduction_rate=0.3)
    _, large = _args(str(tmp_path), reduction_rate=0.5)
    first = GECC(tds, small)
    red1 = first.reduce(tds)
    prev = {c: v.copy() for c, v in first.prev_centroids.items()}
    # the JAX package's warm start from the same centroids
    jagent = JGECC(jds, _args(str(tmp_path), reduction_rate=0.3)[0],
                   prev_centroids=prev)
    agent = GECC(tds, small, prev_centroids=prev)
    gen = torch.Generator().manual_seed(0)
    labels = tds.labels_for_reduction()
    x = tds.feat[torch.as_tensor(tds.idx_train)]
    for c, v in prev.items():
        x_c = x[torch.as_tensor(np.flatnonzero(labels == c))]
        jagent._current_class = c
        for n_c in (v.shape[0], v.shape[0] - 1):         # reuse, truncate
            got = agent._evolve_init(c, x_c, n_c, gen)
            want = jagent._evolve_init(jax.random.key(0), None, n_c)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got.numpy(), v[:n_c])
    # growth: a larger budget keeps the old centroids as the first rows
    grown = GECC(tds, large, prev_centroids=dict(prev))
    red2 = grown.reduce(tds)
    assert red2.feat.shape[0] > red1.feat.shape[0]
    assert torch.isfinite(red2.feat).all()
    n_grown = 0
    for c, v in prev.items():
        x_c = x[torch.as_tensor(np.flatnonzero(labels == c))]
        n_c = min(grown.budgets[c], x_c.shape[0])
        init = GECC(tds, large, prev_centroids=prev)._evolve_init(
            c, x_c, n_c, gen)
        assert init.shape[0] == n_c >= v.shape[0]
        np.testing.assert_array_equal(init.numpy()[:v.shape[0]], v)
        assert torch.isfinite(init).all()
        n_grown += n_c > v.shape[0]
    assert n_grown == len(prev) == 5
    # shrinking back truncates: as many rows as the first split
    red3 = GECC(tds, small, prev_centroids=grown.prev_centroids).reduce(tds)
    assert red3.feat.shape == red1.feat.shape


def test_sampled_aggregation_equals_exact_hops(datasets, tmp_path):
    _, tds = datasets
    _, targs = _args(str(tmp_path))
    agent = GECC(tds, targs)
    agent.sample_fanout = int(np.diff(tds.adj_host.indptr).max()) + 1
    agent.sample_batch = 64            # several batches of targets
    rows = np.asarray(tds.idx_train)
    exact = agent._aggregate(tds)[torch.as_tensor(rows)]
    _close(agent._aggregate_sampled(tds, rows).numpy(), exact.numpy())
    agent.sample_threshold = 10
    with mock.patch.object(GECC, "_aggregate",
                           side_effect=AssertionError("exact path")):
        red = agent.reduce(tds)
    assert torch.isfinite(red.feat).all()
