"""The loaded graph's build on the dataset's device against the host build
(CPU): ``graph.from_edge_index_on`` and ``graph.submatrix_on`` give the
arrays of ``host_from_edge_index(..., symmetrize=True)`` and
``host_submatrix`` bit for bit, ``data.load`` serves host mirrors equal to
a host build of its own file, and the recorder counts the entries built
and the bytes a lazy ``host_of`` reads back, in a span of its own."""

import numpy as np
import pytest

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch.data import load


def _assert_same(got: G.HostAdj, want: G.HostAdj) -> None:
    for field in ("indptr", "row", "col"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == np.int64 and b.dtype == np.int64, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    if want.val is None:
        assert got.val is None
    else:
        assert got.val.dtype == want.val.dtype
        np.testing.assert_array_equal(got.val, want.val)


def _random_edges(n, e, seed, dtype=np.int64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=(2, e)).astype(dtype)


def _edge_cases():
    rng = np.random.default_rng(1)
    dup = _random_edges(50, 200, 2)
    dup = np.concatenate([dup, dup[:, :80], dup[::-1, :40]], axis=1)
    loops = _random_edges(40, 120, 3)
    loops[1, ::3] = loops[0, ::3]
    trailing = _random_edges(30, 90, 4)       # nodes 30..59 have no edge
    return {
        "random": (_random_edges(500, 3000, 0), 500),
        "duplicates": (dup, 50),
        "self_loops": (loops, 40),
        "isolated_trailing_nodes": (trailing, 60),
        "empty": (np.zeros((2, 0), dtype=np.int64), 25),
        "empty_graph_of_no_nodes": (np.zeros((2, 0), dtype=np.int64), 0),
        "int32": (_random_edges(300, 1500, 5, np.int32), 300),
        "transposed_view": (np.ascontiguousarray(
            rng.integers(0, 80, size=(400, 2))).T, 80),
    }


EDGE_CASES = _edge_cases()


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_device_build_equals_the_host_build(case):
    ei, n = EDGE_CASES[case]
    adj = G.from_edge_index_on("cpu", ei, n)
    assert adj._host is None and adj.val is None
    want = G.host_from_edge_index(ei, n, symmetrize=True)
    _assert_same(G.host_of(adj), want)


def _subsets():
    rng = np.random.default_rng(7)
    n = 400
    return n, {
        "sorted": np.sort(rng.choice(n, 250, replace=False)),
        "small_sorted": np.sort(rng.choice(n, 17, replace=False)),
        "empty": np.zeros(0, dtype=np.int64),
        "full": np.arange(n),
        "unsorted": rng.permutation(n)[:300],
    }


N_SUB, SUBSETS = _subsets()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("which", sorted(SUBSETS))
def test_device_submatrix_equals_the_host_submatrix(which, weighted):
    ei = _random_edges(N_SUB, 2500, 11)
    host = G.host_from_edge_index(ei, N_SUB, symmetrize=True)
    if weighted:
        host = G.host_gcn_norm(host)
        adj = host.to_sparse("cpu")
        adj._host = None            # as if built on the device
    else:
        adj = G.from_edge_index_on("cpu", ei, N_SUB)
    idx = SUBSETS[which]
    _assert_same(G.host_of(G.submatrix_on(adj, idx)),
                 G.host_submatrix(host, idx))


def _write_twin(tmp_path, name, n=700, e=4000, seed=3):
    """A generic-npz file under ``name`` with its own split."""
    rng = np.random.default_rng(seed)
    ei = _random_edges(n, e, seed)
    ei[:, :50] = ei[:, 50:100]                  # duplicate edges
    ei[1, 100:120] = ei[0, 100:120]             # self loops
    perm = rng.permutation(n)
    np.savez(tmp_path / f"{name}.npz", edge_index=ei,
             feat=rng.standard_normal((n, 12)).astype(np.float32),
             labels=rng.integers(0, 4, n).astype(np.int32),
             idx_train=perm[:400], idx_val=perm[400:520],
             idx_test=perm[520:])
    return ei, n


@pytest.mark.parametrize("setting", ["trans", "ind"])
def test_load_serves_host_mirrors_equal_to_the_host_build(setting,
                                                          tmp_path):
    ei, n = _write_twin(tmp_path, "synth-small")
    ds = load("synth-small", setting=setting, data_dir=str(tmp_path),
              device="cpu")
    want = G.host_from_edge_index(ei, n, symmetrize=True)
    _assert_same(ds.adj_host, want)
    _assert_same(G.host_of(ds.adj), want)
    assert ds.adj_host is G.host_of(ds.adj)
    for split in ("train", "val", "test") if setting == "ind" else ():
        _assert_same(ds.view_host(split),
                     G.host_submatrix(want, getattr(ds, f"idx_{split}")))
    # what the engine builds from the mirror is today's too
    _assert_same(ds.train_norm_host(), G.host_gcn_norm(
        want if setting == "trans"
        else G.host_submatrix(want, ds.idx_train)))


@pytest.mark.parametrize("setting", ["trans", "ind"])
def test_the_recorder_counts_the_build_and_the_readback(setting, tmp_path):
    ei, n = _write_twin(tmp_path, "synth-small")
    P.clear()
    ds = load("synth-small", setting=setting, data_dir=str(tmp_path),
              device="cpu")
    graph = [s for s in P.spans() if s["name"] == "data.graph"]
    assert len(graph) == 1
    assert graph[0]["attrs"]["device"] == "cpu"
    assert graph[0]["counts"] == {"data.graph.entries": 2 * ei.shape[1]}
    # nothing was read back while loading
    assert "graph.readback_bytes" not in P.counters()
    adj = ds.adj_train if setting == "ind" else ds.adj
    h = G.host_of(adj)
    read = h.indptr.nbytes + h.row.nbytes + h.col.nbytes
    assert P.counters()["graph.readback_bytes"] == read
    back = [s for s in P.spans() if s["name"] == "graph.readback"]
    assert [s["counts"] for s in back] == [{"graph.readback_bytes": read}]
    # the mirror is kept: a second call reads nothing back
    assert G.host_of(adj) is h
    assert P.counters()["graph.readback_bytes"] == read
    P.clear()
