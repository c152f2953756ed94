"""Edge sparsification and structural coarsening on the card, on
synth-small, against the port's own CPU path.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_coarsen_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 13)
runs the 14 methods on the cora, pubmed, arxiv and flickr twins.

* The variation family's float32 ``eigh`` basis on the card, held
  through the costs it gives the first-level candidate sets, on the
  columns float32 determines (``tests/test_torch_coarsen.py`` says
  which): every cost to 1e-4 of the largest against the CPU basis's, and
  each of the cheapest ``floor(r·n)`` to a relative error against a
  float64 basis's costs of at most 1e-4 or three times the CPU basis's
  own error there, whichever is larger.
* The eleven methods with no device arithmetic (the edge sparsifiers,
  the proximity family, Kron) return on the card the triple of the CPU
  run, bit for bit, with every tensor on the card.
* The variation family ends finite on the card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch
from torch_shared import (basis64, cheapest_relative_errors,
                          determined_columns, first_level_costs)

from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import coarsening as TC
from graphslim_tpu_torch.reduce import create_reducer

pytestmark = pytest.mark.cuda

VARIATION = ["variation_neighborhoods", "variation_edges",
             "variation_cliques"]
HOST_ONLY = ["random_edge", "g_spar", "scan", "local_degree",
             "spanning_forest", "rank_degree", "t_spanner", "heavy_edge",
             "algebraic_jc", "affinity_gs", "kron"]


@pytest.fixture(scope="module")
def ds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return (load("synth-small", seed=0, device="cuda"),
            load("synth-small", seed=0, device="cpu"))


def _args(method, tmp, device, **kw):
    base = dict(dataset="synth-small", method=method, save_path=str(tmp),
                **kw)
    return finalize(Args(**base, device=device), set(base))


@pytest.mark.parametrize("method", VARIATION)
def test_device_basis_costs_match_the_cpu_basis(ds, tmp_path, method):
    gpu, _ = ds
    agent = create_reducer(method, gpu, _args(method, tmp_path, "cuda"))
    W = TC._to_scipy(gpu.train_host())
    n_comp, comp = csgraph.connected_components(W, directed=False)
    for c in range(n_comp):
        nodes = np.flatnonzero(comp == c)
        if len(nodes) <= 10:
            continue
        Wc = sp.csr_matrix(W[nodes][:, nodes])
        L = TC._laplacian(Wc).toarray()
        cols = determined_columns(L, agent.K)
        Bd = agent.basis(Wc)
        assert Bd.dtype == np.float32
        Bc = TC._first_k_basis(Wc, agent.K, "cpu")
        got = first_level_costs(TC, agent, Wc, Bd[:, cols])
        ref = first_level_costs(TC, agent, Wc, Bc[:, cols])
        exact = first_level_costs(TC, agent, Wc,
                                  basis64(L, agent.K)[:, cols])
        fin = np.isfinite(ref)
        err = np.abs(got[fin] - ref[fin]).max()
        assert err <= 1e-4 * np.abs(ref[fin]).max(), (len(nodes), err)
        rel, rel_cpu = cheapest_relative_errors(
            exact, len(nodes), agent.args.reduction_rate, got, ref)
        assert rel <= max(1e-4, 3 * rel_cpu), (len(nodes), rel, rel_cpu)


@pytest.mark.parametrize("method", HOST_ONLY)
def test_host_only_methods_equal_the_cpu_run(ds, tmp_path, method):
    gpu, cpu = ds
    red = create_reducer(method, gpu, _args(method, tmp_path, "cuda")
                         ).reduce(gpu)
    ref = create_reducer(method, cpu, _args(method, tmp_path, "cpu")
                         ).reduce(cpu)
    for t in (red.feat, red.labels, red.adj.row, red.adj.col):
        assert t.is_cuda
    assert torch.equal(red.feat.cpu(), ref.feat)
    assert torch.equal(red.labels.cpu(), ref.labels)
    assert torch.equal(red.adj.col.cpu(), ref.adj.col)
    assert torch.equal(red.adj.values_or_ones().cpu(),
                       ref.adj.values_or_ones())


@pytest.mark.parametrize("method", VARIATION)
def test_variation_family_runs_on_the_card(ds, tmp_path, method):
    gpu, _ = ds
    red = create_reducer(method, gpu, _args(method, tmp_path, "cuda")
                         ).reduce(gpu)
    assert red.feat.is_cuda and red.n_syn > 0
    assert torch.isfinite(red.feat).all()
    assert torch.isfinite(red.adj.values_or_ones()).all()
