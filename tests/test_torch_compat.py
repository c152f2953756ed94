"""The port's interop boundary against the JAX package's (CPU).

* ``to_torch`` gives the JAX function's tensors for a ``Dataset`` and for
  a ``Reduced`` with no, a dense and a sparse adjacency (the labels keep
  the port's int64 where the JAX package's are int32: values equal).
* ``from_torch`` round trips; ``from_dgl`` reads a stub graph object,
  homogeneous and heterogeneous, as the JAX function does.
* ``save_reference_layout`` of one package is read back by
  ``load_reference_reduced`` of the other, both ways.
* The salvage path recovers int64 labels from an archive the test mangles
  itself (``decode("utf-8", errors="replace")``) bit for bit, and raises
  ``SalvageError`` where a lost byte falls in the payload, in both
  packages.
* ``to_pyg_data`` and ``to_dgl_graph`` raise ``ImportError`` without
  their packages.
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch_shared import dataset_pair, reduced_pair
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import compat as JC
from graphslim_tpu_torch import compat as C
from graphslim_tpu_torch import graph as G


@pytest.fixture(scope="module")
def twins():
    return dataset_pair("synth-small")


def _same_blob(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in ("x", "edge_index", "edge_weight"):
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["y"].long(), want["y"].long())
    assert all(t.device.type == "cpu" for t in got.values())


def test_to_torch_of_a_dataset_equals_jax(twins):
    jds, tds = twins
    _same_blob(C.to_torch(tds), JC.to_torch(jds))


@pytest.mark.parametrize("kind", ["none", "dense", "sparse"])
def test_to_torch_of_a_reduced_graph_equals_jax(twins, kind):
    jred, tred = reduced_pair(twins[0], kind)
    _same_blob(C.to_torch(tred), JC.to_torch(jred))


def test_from_torch_round_trip(twins):
    _, tds = twins
    blob = C.to_torch(tds)
    feat, adj, labels = C.from_torch(blob["x"], blob["edge_index"],
                                     blob["y"], blob["edge_weight"],
                                     device="cpu")
    assert torch.equal(feat, tds.feat) and torch.equal(labels, tds.labels)
    h, h2 = G.host_of(tds.adj), G.host_of(adj)
    assert np.array_equal(h.indptr, h2.indptr)
    assert np.array_equal(h.col, h2.col)
    assert np.array_equal(h.values_or_ones(), h2.values_or_ones())
    _same_blob(C.to_torch(G.Reduced(feat=feat, adj=adj, labels=labels)),
               blob)


def test_from_torch_sums_duplicate_edges_as_jax():
    ei = torch.tensor([[0, 0, 1, 2], [1, 1, 2, 0]])
    w = torch.tensor([1.0, 2.0, 0.5, 4.0])
    x, y = torch.randn(3, 4), torch.tensor([0, 1, 0])
    _, jadj, _ = JC.from_torch(x, ei, y, w)
    _, adj, _ = C.from_torch(x, ei, y, w, device="cpu")
    assert np.array_equal(G.to_edge_index(adj), np.asarray(
        [np.asarray(jadj.row), np.asarray(jadj.col)]))
    assert np.array_equal(adj.val.numpy(), np.asarray(jadj.val))


class _StubGraph:
    """What ``from_dgl`` reads of a DGL graph."""

    def __init__(self, n, edges: dict, key="feat"):
        rng = np.random.default_rng(0)
        self._edges = edges
        self.etypes = [et[1] for et in edges]
        self.canonical_etypes = list(edges)
        self.ndata = {key: torch.as_tensor(rng.normal(size=(n, 5)),
                                           dtype=torch.float32),
                      "label": torch.as_tensor(rng.integers(0, 3, n))}

    def edges(self, etype=None):
        s, d = self._edges[etype or self.canonical_etypes[0]]
        return torch.as_tensor(s), torch.as_tensor(d)


@pytest.mark.parametrize("hetero", [False, True])
def test_from_dgl_on_a_stub_graph_equals_jax(hetero):
    rng = np.random.default_rng(1)
    n = 30
    kinds = [("n", "a", "n"), ("n", "b", "n")] if hetero else \
        [("n", "e", "n")]
    g = _StubGraph(n, {k: (rng.integers(0, n, 40), rng.integers(0, n, 40))
                       for k in kinds}, key="feature" if hetero else "feat")
    jfeat, jadj, jlabels = JC.from_dgl(g)
    feat, adj, labels = C.from_dgl(g, device="cpu")
    assert np.array_equal(feat.numpy(), np.asarray(jfeat))
    assert np.array_equal(labels.numpy(), np.asarray(jlabels))
    assert np.array_equal(G.to_edge_index(adj), np.asarray(
        [np.asarray(jadj.row), np.asarray(jadj.col)]))


@pytest.mark.parametrize("kind", ["none", "dense", "sparse"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reference_layout_is_read_by_the_other_package(twins, tmp_path,
                                                       writer, kind):
    jred, tred = reduced_pair(twins[0], kind, onehot=kind == "dense")
    if writer == "jax":
        JC.save_reference_layout(jred, str(tmp_path), "gcond", "cora", 0.5)
        got = C.load_reference_reduced(str(tmp_path), "gcond", "cora", 0.5,
                                       device="cpu")
        want = JC.load_reference_reduced(str(tmp_path), "gcond", "cora",
                                         0.5)
    else:
        C.save_reference_layout(tred, str(tmp_path), "gcond", "cora", 0.5)
        want = JC.load_reference_reduced(str(tmp_path), "gcond", "cora",
                                         0.5)
        got = C.load_reference_reduced(str(tmp_path), "gcond", "cora", 0.5,
                                       device="cpu")
    for k in ("feat", "adj", "labels"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    assert got.labels.dtype == torch.int64


def _mangled(tmp_path, labels: np.ndarray):
    path = tmp_path / "label_cora_0.5_1.pt"
    torch.save(torch.as_tensor(labels), path)
    raw = path.read_bytes()
    path.write_bytes(raw.decode("utf-8", errors="replace").encode("utf-8"))
    return str(path), raw


def test_salvage_recovers_mangled_labels_bit_for_bit(tmp_path):
    labels = np.random.default_rng(2).integers(0, 40, 300).astype(np.int64)
    path, raw = _mangled(tmp_path, labels)
    assert open(path, "rb").read() != raw        # the archive was mangled
    with pytest.raises(Exception):
        torch.load(path, weights_only=False)
    got = C.load_torch_artifact(path)
    assert got.dtype == np.int64 and np.array_equal(got, labels)
    assert np.array_equal(got, JC.load_torch_artifact(path))


def test_salvage_raises_where_a_lost_byte_is_in_the_payload(tmp_path):
    labels = np.arange(300, dtype=np.int64) % 200   # bytes 0x80.. lost
    path, _ = _mangled(tmp_path, labels)
    with pytest.raises(C.SalvageError, match="payload"):
        C._salvage_mangled_pt(path)
    with pytest.raises(JC.SalvageError, match="payload"):
        JC._salvage_mangled_pt(path)


def test_salvage_refuses_what_is_not_a_torch_archive(tmp_path):
    path = tmp_path / "x.pt"
    path.write_bytes(b"LongStorage data/0 but no header")
    with pytest.raises(C.SalvageError, match="local header"):
        C._salvage_mangled_pt(str(path))


@pytest.mark.parametrize("fn,pkg", [("to_pyg_data", "torch_geometric"),
                                    ("to_dgl_graph", "dgl")])
def test_optional_converters_raise_import_error_without_packages(twins, fn,
                                                                 pkg):
    with mock.patch.dict(sys.modules, {pkg: None,
                                       f"{pkg}.data": None}):
        with pytest.raises(ImportError, match=pkg):
            getattr(C, fn)(twins[1])
