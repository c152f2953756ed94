"""The attacks on the card against the port's plain versions.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_attack_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 15)
runs PRBCD at full size on the cora and arxiv twins.

* The split PRBCD forward (the blocked SpMM over ``A``, the gather and
  segment sum over the block) against the plain version on the card at a
  fixed block: log-probabilities to 1e-5 of the largest, ``∂loss/∂p`` to
  1e-4 of max|g|, and both against the plain version in float64 no
  farther than twice the plain float32 version's distance plus 1e-6 of
  the largest.
* One epoch on the card against the CPU: ``p`` to 1e-6 where |g| is
  above 1e-6·max|g|.
* ``random_adj`` on the card gives the CPU's graph (host draws), and
  PRBCD on synth-small keeps its budget.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import attack as A
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.utils import tree_map

pytestmark = pytest.mark.cuda


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds_c = load("synth-small", split="random", seed=0, device="cuda")
    params, labels = A.train_surrogate(
        ds_c, torch.Generator(device="cuda").manual_seed(0))
    # the card's surrogate on both devices, so that only the forward differs
    out = {"cuda": (ds_c, params, labels),
           "cpu": (load("synth-small", split="random", seed=0, device="cpu"),
                   tree_map(lambda t: t.cpu(), params), labels.cpu())}
    rng = np.random.default_rng(0)
    n = ds_c.n_nodes
    rows, cols = A._triu_pairs(rng, n, 2000)
    keys = A._edge_key_set(G.to_edge_index(ds_c.adj), n)
    is_edge = A._is_existing_edge(keys, rows, cols, n)
    p = rng.random(2000).astype(np.float32) * 0.3
    return out, (rows, cols, is_edge), p


def test_split_forward_and_gradient_equal_the_plain_version(case):
    out, blk_np, p_np = case
    ds, params, labels = out["cuda"]
    blk = A.Block.of(*blk_np, "cuda")
    p = torch.as_tensor(p_np, device="cuda")
    with torch.no_grad():
        SB.reset_launches()
        split = A.forward_split(params, ds.adj, ds.feat, p, blk)
        assert SB.LAUNCHES["spmm_blocked"] == 2
        plain = A.forward_plain(params, ds.adj, ds.feat, p, blk)
        p64 = tree_map(lambda t: t.double(), params)
        f64 = A.forward_plain(p64, ds.adj, ds.feat.double(), p.double(),
                              A.Block(blk.rows, blk.cols, blk.sign.double()))
    assert _rel(split, plain) <= 1e-5
    assert _rel(split, f64) <= 2 * _rel(plain, f64) + 1e-6
    _, g = A.loss_and_grad(params, ds.adj, ds.feat, labels, p, blk)
    assert A.forward(params, ds.adj, ds.feat, p, blk).is_cuda
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        loss = A.tanh_margin_loss(
            A.forward_plain(params, ds.adj, ds.feat, q, blk), labels)
        g_plain, = torch.autograd.grad(loss, q)
        q64 = p.double().requires_grad_(True)
        loss64 = A.tanh_margin_loss(
            A.forward_plain(p64, ds.adj, ds.feat.double(), q64,
                            A.Block(blk.rows, blk.cols, blk.sign.double())),
            labels)
        g64, = torch.autograd.grad(loss64, q64)
    assert _rel(g, g_plain) <= 1e-4
    assert _rel(g, g64) <= 2 * _rel(g_plain, g64) + 1e-6


def test_one_epoch_on_the_card_equals_the_cpu(case):
    out, blk_np, p_np = case
    got = {}
    for dev in ("cpu", "cuda"):
        ds, params, labels = out[dev]
        blk = A.Block.of(*blk_np, dev)
        p = torch.as_tensor(p_np, device=dev)
        _, g = A.loss_and_grad(params, ds.adj, ds.feat, labels, p, blk)
        p1, _ = A.epoch_step(params, ds.adj, ds.feat, labels, p, blk, 200,
                             0.2, 1e-7)
        got[dev] = g.cpu().numpy(), p1.cpu().numpy()
    g = got["cpu"][0]
    sure = np.abs(g) > 1e-6 * np.abs(g).max()
    assert (~sure).sum() <= 0.01 * sure.size
    np.testing.assert_allclose(got["cuda"][1][sure], got["cpu"][1][sure],
                               rtol=0, atol=1e-6)


def test_random_adj_on_the_card_is_the_cpu_graph(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    edges = []
    for dev in ("cpu", "cuda"):
        ds = load("synth-small", seed=0, device=dev)
        args = finalize(Args(dataset="synth-small", attack="random_adj",
                             save_path=str(tmp_path / dev), device=dev,
                             eval_epochs=10, hidden=16))
        out = A.attack(ds, args)
        assert out.adj.device.type == dev and out.feat.device.type == dev
        edges.append(G.to_edge_index(out.adj))
    np.testing.assert_array_equal(edges[0], edges[1])


def test_prbcd_on_the_card_keeps_its_budget(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = load("synth-small", split="random", seed=0, device="cuda")
    args = finalize(Args(dataset="synth-small", attack="metattack",
                         save_path=str(tmp_path), device="cuda"))
    budget = int(args.ptb_r * ds.adj.nnz / 2)
    host = A.prbcd_attack(ds, args, block_size=5000, epochs=20,
                          fine_tune_epochs=5)
    before = set(A._edge_key_set(G.to_edge_index(ds.adj), ds.n_nodes))
    after = set(A._edge_key_set(np.stack([host.row, host.col]), ds.n_nodes))
    assert 0 < len(before ^ after) <= budget
