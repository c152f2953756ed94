"""The rest of the model zoo on the card against the port's own CPU path.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_zoo_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 14)
runs the eight models at full width on the arxiv and flickr twins.

* MLP, APPNP, Cheby, GraphSage, GAT (segment and ELL paths) and SGFormer:
  the forward and the parameter gradients on the card (the blocked SpMM
  wherever the model propagates through a ``SparseAdj``) against the same
  model on the CPU, to 1e-4 of the largest value (float32; the two sum
  in different orders).
* ``attention_ell`` on the card against the segment path on the card
  (2e-3 of the largest, atol 2e-4, the JAX package's bound), and its
  bf16 messages against float32 (0.05).
* ``Evaluator.train_cross`` on the card returns eight finite entries.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.graph import Reduced
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.kernels.ell import attention_ell, ell_from_sparse
from graphslim_tpu_torch.utils import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

MODELS = ["MLP", "APPNP", "Cheby", "GraphSage", "GAT", "SGFormer"]


@pytest.fixture(scope="module")
def graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    n, d = 300, 24
    ei = rng.integers(0, n, size=(2, 1500))
    x = rng.normal(size=(n, d)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        adj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                           device=dev))
        out[dev] = (torch.tensor(x, device=dev), adj)
    return out


def _cfg(d):
    return M.ModelConfig(nfeat=d, nhid=32, nclass=5, nlayers=2,
                         dropout=0.0, nheads=4)


def _forward_and_grads(name, params, x, adj):
    model = M.get_model(name, _cfg(x.shape[1]))
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out = model.apply(params, x, adj, training=True)
        grads = torch.autograd.grad((out * out).sum(), leaves,
                                    allow_unused=True)
    return out.detach(), [torch.zeros_like(p) if g is None else g
                          for g, p in zip(grads, leaves)]


@pytest.mark.parametrize("name,layout", [(m, "sparse") for m in MODELS]
                         + [("GAT", "ell")])
def test_forward_and_gradients_on_the_card_match_the_cpu(graphs, name,
                                                         layout):
    x_c, adj_c = graphs["cpu"]
    x_g, adj_g = graphs["cuda"]
    if layout == "ell":
        adj_c, adj_g = ell_from_sparse(adj_c), ell_from_sparse(adj_g)
    model = M.get_model(name, _cfg(x_c.shape[1]))
    p_c = model.init(torch.Generator().manual_seed(1))
    p_g = tree_map(lambda t: t.cuda(), p_c)
    before = SB.LAUNCHES["spmm_blocked"]
    out_g, gr_g = _forward_and_grads(name, p_g, x_g, adj_g)
    torch.cuda.synchronize()
    if name in ("APPNP", "Cheby", "GraphSage", "SGFormer"):
        assert SB.LAUNCHES["spmm_blocked"] > before
    out_c, gr_c = _forward_and_grads(name, p_c, x_c, adj_c)
    scale = float(out_c.abs().max())
    assert (out_g.cpu() - out_c).abs().max() <= 1e-4 * scale + 1e-6
    for g_g, g_c in zip(gr_g, gr_c):
        assert (g_g.cpu() - g_c).abs().max() <= \
            1e-4 * float(g_c.abs().max()) + 1e-6


def test_attention_ell_on_the_card_matches_the_segment_path(graphs):
    x, adj = graphs["cuda"]
    n, H, h = x.shape[0], 4, 16
    gen = torch.Generator(device="cuda").manual_seed(2)
    feat = torch.randn(n, H, h, generator=gen, device="cuda")
    a_d = torch.randn(n, H, generator=gen, device="cuda")
    a_s = torch.randn(n, H, generator=gen, device="cuda")
    from graphslim_tpu_torch.kernels.segment import (segment_softmax,
                                                     segment_sum)
    s = torch.nn.functional.leaky_relu(a_d[adj.row] + a_s[adj.col], 0.2)
    att = segment_softmax(s, adj.row, n) * adj.val[:, None]
    want = segment_sum(feat[adj.col] * att[..., None], adj.row, n)
    for cap in (256, 4):
        ell = ell_from_sparse(adj, cap=cap)
        got = attention_ell(ell, a_d, a_s, feat)
        assert (got - want).abs().max() <= \
            2e-3 * float(want.abs().max()) + 2e-4
        bf = attention_ell(ell, a_d, a_s, feat.to(torch.bfloat16))
        assert bf.dtype == torch.bfloat16
        assert (bf.float() - want).abs().max() <= \
            0.05 * float(want.abs().max()) + 0.05


def test_train_cross_on_the_card_is_finite(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = load("synth-hard", seed=0, device="cuda")
    args = finalize(Args(dataset="synth-hard", method="random", run_eval=1,
                         eval_epochs=30, save_path=str(tmp_path)),
                    explicit={"run_eval", "eval_epochs"})
    idx = torch.as_tensor(ds.idx_train, device="cuda")
    sub = G.submatrix(G.host_of(ds.adj), ds.idx_train, device="cuda")
    red = Reduced(feat=ds.feat[idx], adj=sub, labels=ds.labels[idx])
    table = Evaluator(ds, args).train_cross(red)
    assert sorted(table) == sorted(Evaluator.MODELS)
    assert all(np.isfinite(m) and np.isfinite(s) for m, s in table.values())
