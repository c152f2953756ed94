"""The frozen twin generator against the port's, on a small twin."""

import dataclasses

import numpy as np
import pytest
import torch

from gsbench_tiny import tiny
from gsbench import twins


@pytest.fixture
def small_twin(tmp_path, monkeypatch):
    """A small ogbn-arxiv-shaped twin: the port's spec cut to 2,000 nodes
    (the port synthesizes it into a cache under the test's directory), and
    the benchmark's file of the same parameters."""
    from graphslim_tpu_torch.data import loader

    torch.set_num_threads(2)
    monkeypatch.setenv("GRAPHSLIM_TORCH_CACHE", str(tmp_path / "port"))
    spec = dataclasses.replace(loader.DATASET_SPECS["ogbn-arxiv"],
                               n_nodes=2000, n_feat=24, nclass=5,
                               avg_degree=6.0)
    monkeypatch.setitem(loader.DATASET_SPECS, "ogbn-arxiv", spec)
    cfg, _ = tiny("gcond_arxiv")
    cfg["twin"].update(n_nodes=2000, n_feat=24, nclass=5, avg_degree=6.0)
    return cfg["twin"], tmp_path


def test_frozen_generator_equals_the_ports(small_twin):
    from graphslim_tpu_torch.data import synthetic

    twin, _ = small_twin
    mine = twins.synthesize(twin)
    seed = __import__("zlib").crc32(b"ogbn-arxiv") % (2 ** 31)
    ei, feat, labels = synthetic.generate(
        2000, 24, 5, 6.0, twin["homophily"], seed=seed,
        feature_noise=twin["feature_noise"],
        center_scale=twin["center_scale"], label_noise=twin["label_noise"],
        feature_mix=twin["feature_mix"])
    assert np.array_equal(mine["edge_index"], ei)
    assert np.array_equal(mine["feat"], feat)
    assert np.array_equal(mine["labels"], labels)


def test_the_file_loads_as_the_ports_own_twin(small_twin):
    """The port reads the file's graph as its own twin's, with the file's
    split at the published sizes, and standardizes the features over the
    file's train rows."""
    from graphslim_tpu_torch.data import load

    twin, root = small_twin
    d, secs = twins.twin_file(twin, str(root / "bench"))
    assert secs > 0 and twins.twin_file(twin, str(root / "bench"))[1] == 0
    raw = twins.read_twin(twin, str(root / "bench"))
    ours = load("ogbn-arxiv", data_dir=d, device="cpu")
    port = load("ogbn-arxiv", seed=twin["split_seed"], device="cpu")
    for k in ("idx_train", "idx_val", "idx_test"):
        assert np.array_equal(getattr(ours, k), raw[k])
        assert len(raw[k]) == twin["split"][k[4:]]
    assert torch.equal(ours.labels, port.labels)
    a, b = ours.adj_norm_host(), port.adj_norm_host()
    assert np.array_equal(a.row, b.row) and np.array_equal(a.col, b.col)
    assert np.array_equal(a.val, b.val)
    x = raw["feat"].astype(np.float64)
    tr = raw["idx_train"]
    want = (x - x[tr].mean(0)) / x[tr].std(0)
    assert np.allclose(ours.feat.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("config,n_syn", [("gcond_arxiv", 909),
                                          ("gcond_reddit", 153)])
def test_split_is_the_published_one(config, n_syn):
    """The split's sizes are the dataset's published ones, drawn as one
    seeded permutation, and give GCond's published number of synthetic
    nodes at the cell's rate."""
    from gsbench import manifest
    from gsbench_tiny import ROOT

    bench = manifest.benchmark(ROOT)
    twin = manifest.config(bench, config)["twin"]
    rate = {"gcond_arxiv": 0.01, "gcond_reddit": 0.001}[config]
    sizes = twin["split"]
    tr, va, te = twins.make_splits(twin["n_nodes"], sizes, 0)
    assert (len(tr), len(va), len(te)) == (sizes["train"], sizes["val"],
                                          sizes["test"])
    allv = np.concatenate([tr, va, te])
    assert np.array_equal(np.sort(allv), np.arange(twin["n_nodes"]))
    again = twins.make_splits(twin["n_nodes"], sizes, 0)
    assert all(np.array_equal(x, y) for x, y in zip((tr, va, te), again))
    assert int(sizes["train"] * rate) == n_syn
    with pytest.raises(ValueError):
        twins.make_splits(twin["n_nodes"] + 1, sizes, 0)


def test_twin_dir_is_fixed_and_named_by_parameters(small_twin):
    twin, root = small_twin
    a = twins.twin_dir(twin, str(root))
    assert a == twins.twin_dir(dict(twin), str(root))
    assert a != twins.twin_dir(dict(twin, split_seed=1), str(root))
