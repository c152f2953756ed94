"""The seven edge sparsifiers of the port against the JAX package (CPU).

On synth-small (transductive) and synth-ind-small (inductive: the train
subgraph) each method returns a triple equal bit for bit to the JAX
package's: the same features and labels (every node of the graph
reducers consume) and the same kept edges and weights.  Both packages
score on the host with NumPy and SciPy from ``default_rng(seed)``; the
t-spanner is each package's native library (the JAX one asserted loaded,
so its inexact Python fallback is never the reference).  Then the
registry, the artifact and a run through ``train_all`` on the CPU.
"""

import numpy as np
import pytest
import torch
from torch_shared import jax_native_lib
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.config import Args, finalize, get_args
from graphslim_tpu_torch.data import load, load_reduced
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce import edge_sparsify as ES
from graphslim_tpu_torch.train_all import run

METHODS = ["random_edge", "g_spar", "scan", "local_degree",
           "spanning_forest", "rank_degree", "t_spanner"]


@pytest.fixture(scope="module")
def datasets():
    assert jax_native_lib() is not None, "the JAX package's native " \
        "library did not load: its fallbacks would be compared"
    return {name: (jload(name, seed=0), load(name, seed=0, device="cpu"))
            for name in ("synth-small", "synth-ind-small")}


def _args(dataset, method, save, **kw):
    base = dict(dataset=dataset, method=method, save_path=save, **kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def assert_same_triple(tred, jred):
    """Equal bit for bit: features, labels, and the adjacency's entries."""
    np.testing.assert_array_equal(tred.feat.numpy(), np.asarray(jred.feat))
    np.testing.assert_array_equal(tred.labels.numpy(),
                                  np.asarray(jred.labels))
    assert isinstance(tred.adj, G.SparseAdj)
    assert tred.adj.n_rows == jred.adj.n_rows
    for got, ref in ((tred.adj.indptr, jred.adj.indptr),
                     (tred.adj.row, jred.adj.row),
                     (tred.adj.col, jred.adj.col),
                     (tred.adj.values_or_ones(), jred.adj.values_or_ones())):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dataset", ["synth-small", "synth-ind-small"])
@pytest.mark.parametrize("method", METHODS)
def test_triples_equal_jax(datasets, tmp_path, dataset, method):
    jds, tds = datasets[dataset]
    jargs, targs = _args(dataset, method, str(tmp_path))
    jred = jcreate(method, jds, jargs).reduce(jds)
    tred = create_reducer(method, tds, targs).reduce(tds)
    assert_same_triple(tred, jred)
    feat, adj, _ = tds.train_graph()
    assert tred.n_syn == feat.shape[0]
    assert 0 < tred.adj.nnz <= adj.nnz
    # the graph is read from the host mirror, not from the device copy
    assert tred.adj.device == tds.device


@pytest.mark.parametrize("dataset", ["synth-small", "synth-ind-small"])
def test_t_spanner_stretch_flag(datasets, tmp_path, dataset):
    """``--ts`` reaches the native spanner: a looser stretch keeps fewer
    edges, and each equals the JAX package's."""
    jds, tds = datasets[dataset]
    kept = []
    for ts in (2, 8):
        jargs, targs = _args(dataset, "t_spanner", str(tmp_path), ts=ts)
        jred = jcreate("t_spanner", jds, jargs).reduce(jds)
        tred = create_reducer("tspanner", tds, targs).reduce(tds)
        assert_same_triple(tred, jred)
        kept.append(tred.adj.nnz)
    assert kept[1] <= kept[0]


def test_common_neighbors_against_dense(datasets):
    _, tds = datasets["synth-small"]
    W = ES._to_scipy(tds.train_host())
    edges, _ = ES._upper_edges(W)
    common = ES._common_neighbors(W, edges)
    Wb = (W > 0).toarray()
    want = (Wb[edges[0]] & Wb[edges[1]]).sum(1)
    np.testing.assert_array_equal(common, want)


def test_artifact_reads_back_equal(datasets, tmp_path):
    _, tds = datasets["synth-small"]
    _, targs = _args("synth-small", "g_spar", str(tmp_path))
    red = create_reducer("g_spar", tds, targs).reduce(tds)
    back = load_reduced(str(tmp_path), "g_spar", "synth-small",
                        targs.reduction_rate, targs.seed, device="cpu")
    assert torch.equal(back.feat, red.feat)
    assert torch.equal(back.labels, red.labels)
    assert torch.equal(back.adj.to_dense(), red.adj.to_dense())


def test_train_all_runs_on_the_cpu(tmp_path, capsys):
    args = get_args(["-D", "synth-small", "-M", "random_edge", "--device",
                     "cpu", "--save_path", str(tmp_path), "--eval_epochs",
                     "30", "--run_eval", "1"])
    mean, std = run(args)
    assert 0.0 <= mean <= 1.0 and std == 0.0
    assert "random_edge on synth-small" in capsys.readouterr().out
