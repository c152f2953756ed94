"""The k-means family and the clustering coarseners on the card, on the
synth-hard twin, against the port's own CPU path.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_cluster_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 10)
runs the same methods at the arxiv twin's full width.

* k-means and fuzzy c-means from the same start: centroids to 1e-5
  relative, equal assignments; incremental k-means++ picks the one
  admissible row.
* ClusterAgg's ``Â²X`` launches the blocked SpMM twice at the feature
  width and matches the CPU product to 1e-5 relative; GECC launches it
  once a hop.
* VNG, MSGC, Mirage and GECC run on the card and end finite, with their
  outputs on the card.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import kmeans as KM
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.clustering import ClusterAgg

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def ds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return load("synth-hard", seed=0, device="cuda")


def _args(method, tmp, **kw):
    base = dict(dataset="synth-hard", method=method, save_path=str(tmp),
                eval_epochs=20, run_eval=1, device="cuda", **kw)
    args = finalize(Args(**base), set(base))
    return args.replace(checkpoints=(1,))


def _close(got, ref, rtol=1e-5):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_kmeans_on_the_card_matches_the_cpu(ds):
    x = ds.feat[:300]
    init = x[torch.arange(0, 300, 50, device="cuda")]
    w = torch.linspace(0.5, 2.0, 300, device="cuda")
    c_gpu, a_gpu = KM.kmeans(x, 6, weights=w, init=init)
    c_cpu, a_cpu = KM.kmeans(x.cpu(), 6, weights=w.cpu(), init=init.cpu())
    assert c_gpu.is_cuda and a_gpu.is_cuda
    _close(c_gpu, c_cpu)
    assert torch.equal(a_gpu.cpu(), a_cpu)
    _close(KM.fuzzy_cmeans(x, 6, 1.3, 50, init=init),
           KM.fuzzy_cmeans(x.cpu(), 6, 1.3, 50, init=init.cpu()))
    xs = torch.repeat_interleave(x[:3], 20, dim=0)
    xs[17] = x[50]
    for seed in range(4):
        got = KM.incremental_kmeanspp(
            xs, x[:3], 1, torch.Generator("cuda").manual_seed(seed))
        assert torch.equal(got[0], x[50])


def test_cluster_agg_and_gecc_launch_the_blocked_spmm(ds, tmp_path):
    agent = ClusterAgg(ds, _args("clustering", tmp_path, agg=True))
    ds.adj_norm().blocked()
    SB.reset_launches()
    feats = agent._train_feats(ds)
    assert SB.LAUNCHES_BY_WIDTH == {ds.n_feat: 2}
    cpu = load("synth-hard", seed=0, device="cpu")
    _close(feats, ClusterAgg(cpu, _args("clustering", tmp_path, agg=True)
                             .replace(device="cpu"))._train_feats(cpu))
    SB.reset_launches()
    red = create_reducer("gecc", ds, _args("gecc", tmp_path)).reduce(ds)
    assert SB.LAUNCHES_BY_WIDTH == {ds.n_feat: 2}
    assert red.feat.is_cuda and torch.isfinite(red.feat).all()


@pytest.mark.parametrize("method,kw", [
    ("vng", dict(condense_model="GCN", hidden=32)),
    ("msgc", dict(epochs=2, batch_adj=3, outer_loop=2, hidden=32)),
    ("mirage", {}), ("clustering", {}), ("averaging", {})])
def test_runs_on_the_card(ds, tmp_path, method, kw):
    red = create_reducer(method, ds, _args(method, tmp_path, **kw)) \
        .reduce(ds)
    assert red.feat.is_cuda and red.labels.is_cuda
    assert torch.isfinite(red.feat).all()
    if isinstance(red.adj, torch.Tensor):
        assert red.adj.is_cuda and torch.isfinite(red.adj).all()
