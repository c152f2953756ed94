"""Dataset files in the port against the JAX package (CPU).

Each reader of ``data/ingest.py`` on the four fixtures under
``tests/fixtures/`` (GraphSAINT, Planetoid raw, OGB raw, gnn-benchmark
npz) and on a DGL fraud ``.mat`` (relations, and the ``homo`` fallback)
and a generic npz that the tests write: the arrays ``try_load`` returns
are equal bit for bit, and so are the splits.  ``load(data_dir=...)``
gives the same adjacency, features, labels, splits and ``nclass`` as the
JAX ``load``, bit for bit (the feature transforms are the same NumPy).
A dataset that is only read from files raises ``FileNotFoundError`` with
the JAX message when its files are missing.  The helpers of ``graph.py``
(``from_scipy``, ``to_edge_index``, ``row_normalize``, ``standardize``)
agree with the JAX package's: the entries bit for bit, the transforms to
1e-6 of the largest.
"""

import os

import numpy as np
import pytest

from graphslim_tpu.data import ingest as jingest
from graphslim_tpu.data import load as jload
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import ingest, load
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.reduce import create_reducer

from torch_shared import one_thread as _one_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# name, data_dir, split of each checked-in fixture
FIXTURE_CASES = {
    "saint-small": ("synth-small", os.path.join(FIXTURES, "saint-small"),
                    None),
    "raw-planetoid": ("cora", os.path.join(FIXTURES, "raw-planetoid"),
                      "fixed"),
    "raw-ogb": ("ogbn-products", os.path.join(FIXTURES, "raw-ogb"), None),
    "raw-gnnbench": ("cora_ml", os.path.join(FIXTURES, "raw-gnnbench"),
                     "random"),
}


def _write_fraud(root, homo: bool):
    import scipy.sparse as sp
    from scipy.io import savemat

    n = 40
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(n, 6)).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.int64)
    r1 = sp.coo_matrix((np.ones(3), ([0, 1, 2], [1, 2, 3])), (n, n))
    r2 = sp.coo_matrix((np.ones(3), ([0, 5, 7], [1, 6, 7])), (n, n))
    os.makedirs(root / "yelp", exist_ok=True)
    blob = {"features": sp.csr_matrix(feat), "label": labels}
    if homo:
        blob["homo"] = (r1 + r2).tocsr()
    else:
        blob.update(net_rur=r1.tocsr(), net_rtr=r2.tocsr())
    savemat(str(root / "yelp" / "YelpChi.mat"), blob)
    # a stray .mat without the fraud schema is passed over
    savemat(str(root / "yelp" / "notes.mat"), {"x": np.ones(3)})
    return "yelp", str(root)


def _write_generic(root, split: bool):
    rng = np.random.default_rng(5)
    n = 120
    blob = dict(edge_index=rng.integers(0, n, size=(2, 500)),
                feat=rng.normal(size=(n, 9)).astype(np.float64),
                labels=rng.integers(0, 3, size=n))
    if split:
        perm = rng.permutation(n)
        blob.update(idx_train=perm[:30], idx_val=perm[30:60],
                    idx_test=perm[60:])
    np.savez(root / "synth-hard.npz", **blob)
    return "synth-hard", str(root)


def _case(case, tmp_path):
    if case in FIXTURE_CASES:
        return FIXTURE_CASES[case]
    if case.startswith("fraud"):
        return _write_fraud(tmp_path, case == "fraud-homo") + ("random",)
    return _write_generic(tmp_path, case == "generic-split") + ("random",)


CASES = sorted(FIXTURE_CASES) + ["fraud", "fraud-homo", "generic",
                                 "generic-split"]


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]))
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_try_load_equals_the_jax_readers(case, tmp_path):
    name, data_dir, _ = _case(case, tmp_path)
    got = ingest.try_load(name, data_dir)
    want = jingest.try_load(name, data_dir)
    assert got is not None and len(got) == len(want) == 4
    for a, b in zip(got, want):
        _equal(a, b)


def test_try_load_finds_nothing_without_files(tmp_path):
    assert ingest.try_load("cora", str(tmp_path)) is None
    assert jingest.try_load("cora", str(tmp_path)) is None


@pytest.mark.parametrize("case", CASES)
def test_load_from_files_equals_jax(case, tmp_path):
    name, data_dir, split = _case(case, tmp_path)
    t = load(name, split=split, seed=0, data_dir=data_dir, device="cpu")
    j = jload(name, split=split, seed=0, data_dir=data_dir)
    assert t.nclass == j.nclass and t.setting == j.setting
    np.testing.assert_array_equal(t.feat.numpy(), np.asarray(j.feat))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    for k in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    np.testing.assert_array_equal(t.adj.row.numpy(), np.asarray(j.adj.row))
    np.testing.assert_array_equal(t.adj.col.numpy(), np.asarray(j.adj.col))
    assert t.adj.nnz > 0


def test_the_fraud_mat_is_read_in_the_inductive_views(tmp_path):
    """yelp is inductive: the views come from the file's graph."""
    name, data_dir = _write_fraud(tmp_path, homo=False)
    t = load(name, split="random", seed=0, data_dir=data_dir, device="cpu")
    j = jload(name, split="random", seed=0, data_dir=data_dir)
    assert t.setting == "ind"
    for v in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(t, f"feat_{v}").numpy(),
                                      np.asarray(getattr(j, f"feat_{v}")))
        np.testing.assert_array_equal(
            getattr(t, f"adj_{v}").row.numpy(),
            np.asarray(getattr(j, f"adj_{v}").row))


@pytest.mark.parametrize("name", ["ogbn-proteins", "ogbn-papers100m"])
def test_ingestion_only_datasets_raise_without_files(name, tmp_path):
    msg = f"{name} is ingestion-only"
    with pytest.raises(FileNotFoundError, match=msg):
        load(name, data_dir=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match=msg):
        jload(name, data_dir=str(tmp_path))


def test_ingestion_only_dataset_loads_from_files(tmp_path):
    """ogbn-proteins from a generic npz: ``nclass`` from the labels."""
    rng = np.random.default_rng(2)
    n = 50
    np.savez(tmp_path / "ogbn-proteins.npz",
             edge_index=rng.integers(0, n, size=(2, 200)),
             feat=rng.normal(size=(n, 8)), labels=rng.integers(0, 2, n))
    t = load("ogbn-proteins", data_dir=str(tmp_path), device="cpu")
    j = jload("ogbn-proteins", data_dir=str(tmp_path))
    assert t.nclass == j.nclass == 2 and t.n_nodes == n
    np.testing.assert_array_equal(t.feat.numpy(), np.asarray(j.feat))


def test_kcenter_on_ingested_files(tmp_path):
    """``--load_path`` through a reducer and the evaluator, as the JAX
    package's ``test_reduce_on_ingested_files`` does."""
    base = dict(dataset="synth-small", method="kcenter",
                save_path=str(tmp_path), run_eval=1, eval_epochs=30,
                load_path=FIXTURE_CASES["saint-small"][1])
    args = finalize(Args(device="cpu", **base), explicit=set(base))
    ds = load(args.dataset, data_dir=args.load_path, seed=0, device="cpu")
    red = create_reducer("kcenter", ds, args).reduce(ds)
    assert red.n_syn > 0 and np.isfinite(red.feat.numpy()).all()
    (mean, _), _ = Evaluator(ds, args).evaluate(red, "GCN")
    assert mean > 0.5


@pytest.mark.parametrize("helper", ["from_scipy", "to_edge_index",
                                    "row_normalize", "standardize"])
def test_graph_helpers_equal_jax(helper):
    """The ingestion helpers of ``graph.py``: the same entries bit for bit,
    the feature transforms to 1e-6 of the largest (float32 reductions in
    other orders)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    import torch

    from graphslim_tpu import graph as JG
    from graphslim_tpu_torch import graph as G

    rng = np.random.default_rng(4)
    if helper in ("from_scipy", "to_edge_index"):
        # duplicate entries are summed
        mat = sp.coo_matrix((rng.random(300).astype(np.float32),
                             (rng.integers(0, 50, 300),
                              rng.integers(0, 50, 300))), shape=(50, 50))
        adj, jadj = G.from_scipy(mat, device="cpu"), JG.from_scipy(mat)
        if helper == "to_edge_index":
            np.testing.assert_array_equal(G.to_edge_index(adj),
                                          JG.to_edge_index(jadj))
            return
        np.testing.assert_array_equal(adj.row.numpy(), np.asarray(jadj.row))
        np.testing.assert_array_equal(adj.col.numpy(), np.asarray(jadj.col))
        np.testing.assert_array_equal(adj.val.numpy(), np.asarray(jadj.val))
        return
    x = rng.normal(size=(60, 7)).astype(np.float32) * 3 + 1
    if helper == "row_normalize":
        got, want = G.row_normalize(torch.as_tensor(x)), \
            JG.row_normalize(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        return
    idx = np.arange(0, 60, 3)
    for tidx in (None, idx):
        got = G.standardize(torch.as_tensor(x), None if tidx is None
                            else torch.as_tensor(tidx))
        want = np.asarray(JG.standardize(jnp.asarray(x), None if tidx is None
                                         else jnp.asarray(tidx)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
