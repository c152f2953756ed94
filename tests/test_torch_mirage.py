"""Mirage in the port against the JAX package (CPU, synth-hard at
r = 0.5).

The mining is host code on both sides, so the comparisons are exact:
``fpgrowth`` returns the same itemsets and supports as the JAX package's
and as a brute-force enumeration; ``wl_tree_hashes`` gives identical ids;
and with the JAX package's node quantization (its k-means assignment)
injected, the reduced triple is identical: features, labels and the tree
edges.  The no-label-leak check mirrors the JAX package's own
(``tests/test_condensation_extended.py::test_mirage_no_label_leak``).
"""

import dataclasses
import itertools
from unittest import mock

import numpy as np
import pytest
import torch

import graphslim_tpu.reduce.mirage as jmirage
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import class_budgets, create_reducer
from graphslim_tpu_torch.reduce import mirage as tmirage


@pytest.fixture(scope="module")
def datasets():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


def _args(save, **kw):
    base = dict(dataset="synth-hard", method="mirage", save_path=save,
                **kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def _brute_force(transactions, min_support, max_len=4):
    sets = [set(t) for t in transactions]
    items = sorted(set().union(*sets))
    out = {}
    for size in range(1, max_len + 1):
        for combo in itertools.combinations(items, size):
            sup = sum(1 for t in sets if set(combo) <= t)
            if sup >= min_support:
                out[frozenset(combo)] = sup
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fpgrowth_matches_jax_and_brute_force(seed):
    rng = np.random.default_rng(seed)
    txns = [set(rng.choice(9, size=rng.integers(1, 7), replace=False)
                .tolist()) for _ in range(40)]
    got = tmirage.fpgrowth(txns, 4)
    assert got == jmirage.fpgrowth(txns, 4)
    assert got == _brute_force(txns, 4)
    assert len(got) > 20


def test_wl_tree_hashes_identical(datasets):
    _, tds = datasets
    host = tds.adj_host
    labels = np.random.default_rng(0).integers(0, 6, tds.n_nodes)
    got = tmirage.wl_tree_hashes(host.indptr, host.col, labels, 3)
    want = jmirage.wl_tree_hashes(host.indptr, host.col, labels, 3)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(np.unique(got[2])) > len(np.unique(got[0]))


def test_reduced_triple_identical_given_the_quantization(datasets, tmp_path):
    jds, tds = datasets
    jargs, targs = _args(str(tmp_path))
    seen = {}
    kmeans = jmirage.kmeans

    def spy(key, x, k, *a, **kw):
        out = kmeans(key, x, k, *a, **kw)
        seen["labels"] = np.asarray(out[1])
        return out

    with mock.patch.object(jmirage, "kmeans", spy):
        jred = jcreate("mirage", jds, jargs).reduce(jds)
    agent = create_reducer("mirage", tds, targs)
    with mock.patch.object(tmirage.Mirage, "node_labels",
                           lambda self, feat, k: seen["labels"]):
        tred = agent.reduce(tds)
    assert len(np.unique(seen["labels"])) > 10
    np.testing.assert_array_equal(tred.feat.numpy(), np.asarray(jred.feat))
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    np.testing.assert_array_equal(tred.adj.row.numpy(),
                                  np.asarray(jred.adj.row))
    np.testing.assert_array_equal(tred.adj.col.numpy(),
                                  np.asarray(jred.adj.col))
    assert tred.adj.nnz > 0


def test_node_labels_are_a_kmeans_over_all_nodes(datasets, tmp_path):
    _, tds = datasets
    agent = create_reducer("mirage", tds, _args(str(tmp_path))[1])
    labels = agent.node_labels(tds.feat, 32)
    assert labels.shape == (tds.n_nodes,) and labels.max() < 32
    assert len(np.unique(labels)) > 16


def test_mirage_no_label_leak(datasets, tmp_path):
    """Scrambling every non-train label must not change Mirage's output:
    val/test labels are unobserved in the transductive setting."""
    _, ds = datasets
    args = _args(str(tmp_path))[1]
    labels = ds.labels.numpy().copy()
    non_train = np.setdiff1d(np.arange(labels.shape[0]), ds.idx_train)
    labels[non_train] = np.random.default_rng(7).integers(
        0, ds.nclass, size=non_train.shape[0])
    ds_scrambled = dataclasses.replace(ds, labels=torch.as_tensor(labels))
    red_a = create_reducer("mirage", ds, args).reduce(ds)
    red_b = create_reducer("mirage", ds_scrambled, args).reduce(
        ds_scrambled)
    assert torch.equal(red_a.labels, red_b.labels)
    assert torch.equal(red_a.feat, red_b.feat)
    budgets, _, _ = class_budgets(ds.labels_for_reduction(),
                                  args.reduction_rate)
    out = dict(zip(*[a.tolist() for a in np.unique(red_a.labels.numpy(),
                                                   return_counts=True)]))
    assert out == {c: b for c, b in budgets.items() if b > 0}
