"""Every twin of the JAX package in the port (CPU): the 21 dataset specs,
the config layer's setting, rate, metric and method tables, and the
loaded arrays, bit for bit, with the inductive views.

Karate is checked against the JAX package's networkx load: the port keeps
Zachary's graph as a constant.  Twins whose synthesis takes more than a
few seconds carry the ``slow`` mark.
"""

import dataclasses

import numpy as np
import pytest

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.data.loader import DATASET_SPECS as JSPECS
from graphslim_tpu.data.loader import normalize_name as jnormalize
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import DATASET_SPECS, load
from graphslim_tpu_torch.data.loader import normalize_name
from graphslim_tpu_torch.reduce.registry import REGISTRY

SLOW = {"reddit", "ogbn-products", "physics", "cs", "ogbn-arxiv"}
RAISE = {"ogbn-proteins", "ogbn-papers100m"}


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    """Large twins cache under ``~/.cache`` in the JAX package and under
    ``$GRAPHSLIM_TORCH_CACHE`` in the port: both go to the test's
    directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("GRAPHSLIM_TORCH_CACHE", str(tmp_path / "torch"))


def test_all_specs_equal_field_by_field():
    assert sorted(DATASET_SPECS) == sorted(JSPECS) and len(JSPECS) == 21
    for name, spec in JSPECS.items():
        assert dataclasses.asdict(DATASET_SPECS[name]) == \
            dataclasses.asdict(spec), name


@pytest.mark.parametrize("alias", ["Ogbn_Arxiv", "ogbnarxiv", "CORA-ML",
                                   "synth_ind_small", "Reddit"])
def test_every_name_normalizes_as_in_jax(alias):
    assert normalize_name(alias) == jnormalize(alias)
    for name in JSPECS:
        assert normalize_name(name) == name
    with pytest.raises(ValueError):
        normalize_name("no-such-twin")


@pytest.mark.parametrize("method", sorted(REGISTRY))
def test_finalize_matches_jax_on_every_dataset(method):
    """Setting, rate, metric and every method-table value the port has a
    field for, for every dataset."""
    ported = {f.name for f in dataclasses.fields(Args)}
    for name in JSPECS:
        j = jfinalize(JArgs(dataset=name, method=method))
        t = finalize(Args(dataset=name, method=method))
        for field in ("setting", "reduction_rate", "metric", "checkpoints",
                      "eval_interval", "eval_epochs"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        common = ported & {f.name for f in dataclasses.fields(JArgs)}
        for field in sorted(common - {"device"}):
            assert getattr(t, field) == getattr(j, field), (name, field)


def _assert_same_arrays(t, j):
    np.testing.assert_array_equal(t.feat.numpy(), np.asarray(j.feat))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    for split in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(t, split), getattr(j, split))
    for field in ("indptr", "row", "col"):
        np.testing.assert_array_equal(getattr(t.adj, field).numpy(),
                                      np.asarray(getattr(j.adj, field)))
    assert t.nclass == j.nclass and t.setting == j.setting
    if t.setting != "ind":
        assert t.feat_train is None and t.adj_train is None
        return
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(
            getattr(t, f"feat_{split}").numpy(),
            np.asarray(getattr(j, f"feat_{split}")))
        np.testing.assert_array_equal(
            getattr(t, f"labels_{split}").numpy(),
            np.asarray(getattr(j, f"labels_{split}")))
        ta, ja = getattr(t, f"adj_{split}"), getattr(j, f"adj_{split}")
        for field in ("indptr", "row", "col"):
            np.testing.assert_array_equal(getattr(ta, field).numpy(),
                                          np.asarray(getattr(ja, field)))
        assert ta.val is None and ja.val is None


def _twin_cases():
    for name in sorted(JSPECS):
        if name in RAISE:
            continue
        marks = [pytest.mark.slow] if name in SLOW else []
        yield pytest.param(name, marks=marks, id=name)


@pytest.mark.parametrize("name", _twin_cases())
def test_twin_arrays_equal_jax(name):
    """Features, labels, splits and CSR arrays, and in the inductive
    setting every view, equal the JAX package's bit for bit."""
    _assert_same_arrays(load(name, seed=0, device="cpu"),
                        jload(name, seed=0))


@pytest.mark.parametrize("name", ["synth-small", "cora"])
def test_transductive_twin_in_the_inductive_setting(name):
    _assert_same_arrays(load(name, setting="ind", seed=1, device="cpu"),
                        jload(name, setting="ind", seed=1))


def test_karate_is_zacharys_graph():
    t = load("karate", seed=0, device="cpu")
    assert t.n_nodes == 34 and t.adj.nnz == 2 * 78
    assert t.labels.sum().item() == 17
    np.testing.assert_array_equal(t.feat.numpy(), np.eye(34))


@pytest.mark.parametrize("name", sorted(RAISE))
def test_ingestion_only_twins_raise(name):
    with pytest.raises(FileNotFoundError, match=f"{name} is ingestion-only"):
        load(name, device="cpu")
    with pytest.raises(FileNotFoundError):
        jload(name)


def test_large_twin_cache_reads_back_equal(tmp_path):
    """flickr is above the cache threshold: the second load reads the
    cache the first wrote (atomically: no temporary file stays)."""
    first = load("flickr", seed=0, device="cpu")
    files = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert len(files) == 1 and files[0].startswith("flickr_") \
        and files[0].endswith(".npz")
    second = load("flickr", seed=0, device="cpu")
    np.testing.assert_array_equal(first.feat_train.numpy(),
                                  second.feat_train.numpy())
    np.testing.assert_array_equal(first.adj_test.col.numpy(),
                                  second.adj_test.col.numpy())


def test_inductive_normalizations_equal_jax_gcn_norm():
    """The dataset's cached subgraph normalizations equal ``gcn_norm`` of
    the JAX package's views, bit for bit, and are built once."""
    from graphslim_tpu import graph as JG

    t = load("synth-ind-small", seed=0, device="cpu")
    j = jload("synth-ind-small", seed=0)
    for split in ("train", "val", "test"):
        want = JG.gcn_norm(getattr(j, f"adj_{split}"))
        got = t.view_norm(split)
        assert got is t.view_norm(split)
        np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
        np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val))
    assert t.train_norm() is t.view_norm("train")
    np.testing.assert_array_equal(t.labels_for_reduction(),
                                  np.asarray(j.labels_for_reduction()))
    np.testing.assert_array_equal(t.pool_ids(), np.arange(len(t.idx_train)))


@pytest.mark.parametrize("sort,weighted,loops", [
    (True, False, False), (True, True, True), (False, True, True),
    (False, False, True)])
def test_host_normalization_equals_jax(sort, weighted, loops):
    """The CSR build from a sorted or an unsorted edge index (the sort is
    skipped or made) and ``host_gcn_norm`` of its output (the loops go in
    by insertion) equal the JAX package's bit for bit, with weights,
    existing self loops and repeated entries."""
    from graphslim_tpu import graph as JG
    from graphslim_tpu_torch import graph as G

    rng = np.random.default_rng(int(sort) * 2 + int(weighted))
    n, e = 300, 2500
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    if not loops:
        col = np.where(row == col, (col + 1) % n, col)
    w = rng.random(e).astype(np.float32) if weighted else None
    if sort:
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        w = None if w is None else w[order]
    ei = np.stack([row, col])
    got = G.host_from_edge_index(ei, n, edge_weight=w, dedup=False)
    want = JG.from_edge_index(ei, n, edge_weight=w, dedup=False,
                              return_host=True)[1]
    for field in ("indptr", "row", "col", "val"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    got_n, want_n = G.host_gcn_norm(got), JG.host_gcn_norm(want)
    for field in ("indptr", "row", "col", "val"):
        np.testing.assert_array_equal(getattr(got_n, field),
                                      np.asarray(getattr(want_n, field)))


def test_host_normalization_refuses_unsorted_entries():
    """``host_gcn_norm`` inserts the loops into (row, col)-sorted entries;
    an unsorted mirror raises instead of coming out in another order."""
    from graphslim_tpu_torch import graph as G

    row, col = np.array([1, 0, 2]), np.array([0, 1, 1])
    h = G.HostAdj(np.array([0, 1, 2, 3]), row, col, None)
    with pytest.raises(ValueError, match="sorted"):
        G.host_gcn_norm(h)
