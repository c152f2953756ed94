"""The blocked SpMM and shared-memory gather CUDA kernels against their
plain versions, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_spmm_cuda.py -m cuda`` (the suite's conftest imports JAX,
which the card's machine need not have).  ``chip_smoke.py`` makes the same
comparisons at the arxiv twin's shapes.  Tolerances: the gather is a copy
and must be exact; the SpMM sums float32 products in another order than
the plain version, so max|Δ| ≤ 1e-5·max|ref| + 1e-6.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.kernels import smem_gather as SG
from graphslim_tpu_torch.kernels import spmm_blocked as SB

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ragged_adj(n, e, seed, dev, heavy=True, weights=True):
    """Random directed graph with rows n//3.. n//2 empty and, with
    ``heavy``, one row that points at every column."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = (row < n // 3) | (row >= n // 2)
    row, col = row[keep], col[keep]
    if heavy:
        row = np.concatenate([row, np.full(n, n - 1)])
        col = np.concatenate([col, np.arange(n)])
    w = rng.normal(size=row.shape[0]).astype(np.float32) if weights else None
    return G.from_edge_index(np.stack([row, col]), n, edge_weight=w,
                             device=dev)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("n_src,d,n_idx,ts", [
    (4096, 128, 32768, 128), (4096, 128, 32768, 448), (1000, 40, 5000, 64),
    (777, 1, 3000, None), (300, 130, 1, 16), (5000, 256, 2500, None)])
def test_gather_equals_index_select(card, n_src, d, n_idx, ts, staged):
    g = torch.Generator(device=card).manual_seed(n_src + d)
    x = torch.randn(n_src, d, generator=g, device=card)
    idx = torch.randint(0, n_src, (n_idx,), generator=g, device=card)
    out = SG.gather_rows_cuda(x, idx, staged=staged, ts=ts)
    torch.cuda.synchronize()
    assert torch.equal(out, SG.gather_rows_plain(x, idx))
    out32 = SG.gather_rows_cuda(x, idx.to(torch.int32), staged=staged,
                                ts=ts)
    assert torch.equal(out32, out)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 3, 40, 128, 129, 256])
@pytest.mark.parametrize("n_src,n_idx", [(169343, 6649), (5000, 1336),
                                         (4096, 300000), (50, 7)])
def test_direct_gather_is_exact_at_every_width(card, d, dtype, n_src, n_idx):
    """The direct kernel (what ``gather_rows`` launches): 16-byte pieces
    when d is a multiple of 4, 4-byte pieces otherwise, one piece a thread;
    equal to ``index_select`` and bit-equal across runs."""
    g = torch.Generator(device=card).manual_seed(d + n_idx)
    x = torch.randn(n_src, d, generator=g, device=card)
    idx = torch.randint(0, n_src, (n_idx,), generator=g, device=card)
    idx = idx.to(dtype)
    out = SG.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, SG.gather_rows_plain(x, idx.long()))
    assert torch.equal(out, SG.gather_rows(x, idx))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_direct_gather_repeated_empty_and_unaligned(card, dtype):
    x = torch.randn(1000, 40, device=card)
    same = torch.full((5000,), 7, device=card, dtype=dtype)
    assert torch.equal(SG.gather_rows(x, same), x[7].expand(5000, 40))
    few = torch.tensor([3, 3, 999, 0, 3], device=card, dtype=dtype)
    assert torch.equal(SG.gather_rows(x, few), x[few.long()])
    before = SG.LAUNCHES["smem_gather"]
    empty = SG.gather_rows(x, torch.zeros(0, device=card, dtype=dtype))
    assert empty.shape == (0, 40) and SG.LAUNCHES["smem_gather"] == before
    # a source that is not 16-byte aligned takes the 4-byte pieces
    base = torch.randn(1000 * 40 + 1, device=card)
    off = base[1:].view(1000, 40)
    assert off.data_ptr() % 16 != 0
    idx = torch.randint(0, 1000, (777,), device=card).to(dtype)
    assert torch.equal(SG.gather_rows(off, idx), off[idx.long()])
    with pytest.raises(ValueError, match="empty source"):
        SG.gather_rows(torch.zeros(0, 4, device=card), few)


def test_direct_plan_sizes_the_grid_to_the_pieces():
    """Host arithmetic of a direct launch (runs anywhere): all indices in
    one blockIdx.y unless that would hold 2^31 pieces."""
    assert SG.direct_plan(1336, 128, True) == 1336
    assert SG.direct_plan(6649, 40, True) == 6649
    assert SG.direct_plan(32768, 128, True) == 32768
    assert SG.direct_plan(300000, 129, False) == 300000
    e_per_y = SG.direct_plan(2 ** 27, 129, False)
    assert e_per_y * 129 < 2 ** 31 <= (e_per_y + 1) * 129
    assert SG.direct_plan(0, 4, True) == 1


def test_gather_dispatch_counts_launches(card):
    x = torch.randn(100, 8, device=card)
    idx = torch.arange(99, -1, -1, device=card)
    before = SG.LAUNCHES["smem_gather"]
    assert torch.equal(SG.gather_rows(x, idx), x.flip(0))
    assert SG.LAUNCHES["smem_gather"] == before + 1
    with pytest.raises(ValueError):
        SG.gather_rows_cuda(x.double(), idx)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 16, 40, 41, 128, 129, 200,
                               256, 1434])
@pytest.mark.parametrize("sizes", [
    dict(td=128, ts=128, chunk=256, stage_min=128),       # staged blocks
    dict(td=128, ts=128, chunk=256, stage_min=10 ** 9),   # direct only
    dict(td=32, ts=448, chunk=50, stage_min=8),           # mixed, cut runs
    dict()])
def test_spmm_matches_plain_and_float64(card, d, sizes):
    n = 500
    adj = _ragged_adj(n, 3000, 3, card)
    layout = adj.blocked(**sizes)
    g = torch.Generator(device=card).manual_seed(d)
    x = torch.randn(n, d, generator=g, device=card)
    out = SB.spmm_blocked(layout, x)
    torch.cuda.synchronize()
    ref = SB.spmm_blocked_plain(layout, x)
    f64 = adj.to_dense().double() @ x.double()
    tol = 1e-5 * float(f64.abs().max()) + 1e-6
    assert (out - ref).abs().max() <= tol
    assert (out.double() - f64).abs().max() <= tol
    assert (out[n // 3: n // 2] == 0).all()
    assert torch.equal(out, SB.spmm_blocked(layout, x))


@pytest.mark.parametrize("d", [7, 1434])
@pytest.mark.parametrize("sizes", [
    dict(td=128, ts=128, chunk=256, stage_min=128), dict()])
def test_spmm_on_nearly_full_tiles(card, d, sizes):
    """A graph whose tiles are nearly full, as Kron's coarse graphs are
    (the cora twin's: 979 rows, about 955 entries a row)."""
    n = 400
    rng = np.random.default_rng(d)
    row, col = np.nonzero(rng.random((n, n)) < 0.95)
    w = rng.uniform(0.1, 1.0, row.shape[0]).astype(np.float32)
    adj = G.from_edge_index(np.stack([row, col]), n, edge_weight=w,
                            device=card)
    layout = adj.blocked(**sizes)
    x = torch.randn(n, d, generator=torch.Generator(device=card).manual_seed(
        d), device=card)
    out = SB.spmm_blocked(layout, x)
    torch.cuda.synchronize()
    f64 = adj.to_dense().double() @ x.double()
    tol = 1e-5 * float(f64.abs().max()) + 1e-6
    assert (out - SB.spmm_blocked_plain(layout, x)).abs().max() <= tol
    assert (out.double() - f64).abs().max() <= tol
    assert torch.equal(out, SB.spmm_blocked(layout, x))


def test_spmm_unweighted_and_tiny(card):
    adj = _ragged_adj(70, 200, 5, card, heavy=False, weights=False)
    x = torch.randn(70, 12, device=card)
    assert torch.allclose(adj.matmul(x), adj.to_dense() @ x, atol=1e-5)
    empty = G.from_edge_index(np.zeros((2, 0), dtype=np.int64), 9,
                              device=card)
    assert (empty.matmul(torch.ones(9, 5, device=card)) == 0).all()


@pytest.mark.parametrize("symmetric", [False, True])
def test_matmul_gradient_is_the_transposed_product(card, symmetric):
    n, d = 300, 40
    if symmetric:
        rng = np.random.default_rng(1)
        ei = np.stack([rng.integers(0, n, 900), rng.integers(0, n, 900)])
        adj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                           device=card))
    else:
        adj = _ragged_adj(n, 2000, 7, card)
    x = torch.randn(n, d, device=card, requires_grad=True)
    g = torch.randn(n, d, device=card)
    before = SB.LAUNCHES["spmm_blocked"]
    with torch.enable_grad():
        out = adj.matmul(x)
        (gx,) = torch.autograd.grad(out, x, g)
    assert SB.LAUNCHES["spmm_blocked"] == before + 2
    want = adj.to_dense().double().T @ g.double()
    assert (gx.double() - want).abs().max() <= \
        1e-5 * float(want.abs().max()) + 1e-6
    assert (adj.blocked(transpose=True) is adj.blocked()) == symmetric


def test_spmm_refuses_what_it_does_not_take(card):
    adj = _ragged_adj(50, 100, 2, card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        adj.matmul(torch.ones(50, 4, device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        adj.matmul(torch.ones(49, 4, device=card))
    with pytest.raises(ValueError):
        SB.spmm_blocked_cuda(adj.blocked(), torch.ones(50, 4))


@pytest.mark.parametrize("d", [1, 40, 64, 129, 192, 256])
def test_spmm_matches_float64_and_repeats_at_every_width(card, d):
    """Forward and backward on a random graph with the twin's entries a
    row (about 27) and the default layout (every block direct): one walk
    of the entries up to 128 columns (129 in floats), slabs of 128 above,
    against float64 within 1e-5·max|ref| + 1e-6, and bit for bit across
    two runs."""
    n = 20000
    rng = np.random.default_rng(d)
    ei = rng.integers(0, n, (2, 27 * n))
    adj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True, device=card))
    layout = adj.blocked()
    assert SB.launch_plan(d, d % 4 == 0)["n_slabs"] == (2 if d > 129 else 1)
    g = torch.Generator(device=card).manual_seed(d)
    x = torch.randn(n, d, generator=g, device=card)
    out = SB.spmm_blocked(layout, x)
    torch.cuda.synchronize()
    f64 = adj.to_dense().double() @ x.double()
    assert (out.double() - f64).abs().max() <= \
        1e-5 * float(f64.abs().max()) + 1e-6
    assert torch.equal(out, SB.spmm_blocked(layout, x))
    gy = torch.randn(n, d, generator=g, device=card)
    back = SB.spmm_blocked(adj.blocked(transpose=True), gy)
    b64 = adj.to_dense().double().T @ gy.double()
    assert (back.double() - b64).abs().max() <= \
        1e-5 * float(b64.abs().max()) + 1e-6
    assert torch.equal(back, SB.spmm_blocked(adj.blocked(transpose=True), gy))
