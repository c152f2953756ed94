"""The port's SpMM layer against the JAX package (CPU, small).

The blocked layout and its plain version are held to the JAX package's
blocked Pallas kernel (interpret mode, both scatter modes) and to its COO
SpMM at atol 1e-4, the tolerance of the JAX package's own test (float32
sums in another order).  The segment reductions, ``sddmm``, ``rmatmul`` and
``sum_rows`` are held at 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import graph as JG
from graphslim_tpu.kernels import segment as JS
from graphslim_tpu.kernels.pallas_spmm_blocked import (
    build_blocked as jax_build_blocked, spmm_blocked as jax_spmm_blocked)
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.kernels import segment as S
from graphslim_tpu_torch.kernels import spmm as SP
from graphslim_tpu_torch.kernels import spmm_blocked as SB


# the JAX kernels package re-exports a function under the module's name
JSP = importlib.import_module("graphslim_tpu.kernels.spmm")


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def case():
    """The inputs of tests/test_kernels_extra.py on both sides."""
    rng = np.random.default_rng(3)
    n, e, d = 500, 3000, 16
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    jadj = JG.gcn_norm(JG.from_edge_index(ei, n, symmetrize=True,
                                          dedup=True))
    tadj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True, dedup=True,
                                        device="cpu"))
    x = rng.normal(size=(n, d)).astype(np.float32)
    return jadj, tadj, x


SIZES = {"jax_test": dict(td=128, ts=128, chunk=256, stage_min=128),
         "direct_only": dict(td=128, ts=128, chunk=256, stage_min=10 ** 9),
         "cut_runs": dict(td=64, ts=32, chunk=7, stage_min=3),
         "defaults": dict()}


@pytest.mark.parametrize("scatter", ["onehot", "cumsum"])
def test_blocked_plain_matches_jax_blocked_kernel(case, scatter):
    jadj, tadj, x = case
    csr = [np.asarray(a) for a in (jadj.indptr, jadj.col, jadj.val)]
    bc = jax_build_blocked(*csr, td=128, ts=128, chunk=256)
    want = np.asarray(jax_spmm_blocked(bc, jnp.asarray(x), interpret=True,
                                       scatter=scatter))
    layout = SB.build_blocked(*csr, td=128, ts=128, chunk=256,
                              stage_min=128, device="cpu")
    got = SB.spmm_blocked(layout, _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_blocked_plain_matches_matmul_on_both_sides(case, sizes):
    jadj, tadj, x = case
    want = np.asarray(jadj.matmul(jnp.asarray(x)))
    got = SB.spmm_blocked(tadj.blocked(**SIZES[sizes]), _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(tadj.matmul(_t(x)).numpy(), want, atol=1e-4)


def _global_entries(layout):
    """(dst, src, val) of every stored entry, from the layout arrays."""
    lens = np.diff(layout.blk_ptr.numpy())
    blk_of = np.repeat(np.arange(layout.n_blocks), lens)
    src_tile = layout.blk_src.numpy()[blk_of]
    src = layout.src_local.numpy() + np.maximum(src_tile, 0) * layout.ts
    dst = layout.dst_local.numpy() + layout.blk_dst.numpy()[blk_of] \
        * layout.td
    return dst, src, layout.val.numpy(), blk_of


@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_layout_invariants(case, sizes):
    _, tadj, _ = case
    layout = tadj.blocked(**SIZES[sizes])
    dst, src, val, blk_of = _global_entries(layout)
    # every stored entry exactly once
    order = np.lexsort((src, dst))
    np.testing.assert_array_equal(dst[order], tadj.row.numpy())
    np.testing.assert_array_equal(src[order], tadj.col.numpy())
    np.testing.assert_array_equal(val[order], tadj.val.numpy())
    assert 0.0 < layout.fill <= 1.0
    assert layout.dst_local.dtype == torch.int32
    # offsets tables
    blk_ptr = layout.blk_ptr.numpy()
    assert blk_ptr[0] == 0 and blk_ptr[-1] == tadj.nnz
    lens = np.diff(blk_ptr)
    assert (lens >= 1).all() and (lens <= layout.chunk).all()
    tile_ptr = layout.tile_ptr.numpy()
    assert tile_ptr[0] == 0 and tile_ptr[-1] == layout.n_blocks
    assert (np.diff(tile_ptr) >= 0).all()
    assert (np.diff(layout.blk_dst.numpy()) >= 0).all()
    # bounds: monotone, span the block, and name each row's dst-sorted run
    bounds = layout.bounds.numpy()
    assert bounds.shape == (layout.n_blocks, layout.td + 1)
    assert (np.diff(bounds, axis=1) >= 0).all()
    assert (bounds[:, 0] == 0).all() and (bounds[:, -1] == lens).all()
    dl = layout.dst_local.numpy()
    for b in range(layout.n_blocks):
        d_b = dl[blk_ptr[b]:blk_ptr[b + 1]]
        assert (np.diff(d_b) >= 0).all()
        np.testing.assert_array_equal(
            bounds[b], np.searchsorted(d_b, np.arange(layout.td + 1)))
    # a staged block's rows lie inside its source tile
    staged = layout.blk_src.numpy()[blk_of] >= 0
    assert (layout.src_local.numpy()[staged] < layout.ts).all()
    assert layout.n_staged == int((layout.blk_src.numpy() >= 0).sum())


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 90), d=st.sampled_from([1, 16, 40]),
       density=st.floats(0.0, 0.2), td=st.sampled_from([1, 8, 64]),
       ts=st.sampled_from([4, 32, 128]), chunk=st.sampled_from([3, 2048]),
       stage_min=st.sampled_from([1, 6, None]), seed=st.integers(0, 10 ** 6))
def test_blocked_plain_on_ragged_graphs(n, d, density, td, ts, chunk,
                                        stage_min, seed):
    """Ragged n, empty rows and one heavy row, against the dense product."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < density) * rng.normal(size=(n, n))
    dense[n // 3: n // 2] = 0.0                  # empty rows
    dense[n - 1] = rng.normal(size=n)            # a row heavier than a tile
    dense = dense.astype(np.float32)
    row, col = np.nonzero(dense)
    adj = G.from_edge_index(np.stack([row, col]), n,
                            edge_weight=dense[row, col], device="cpu")
    x = rng.normal(size=(n, d)).astype(np.float32)
    layout = adj.blocked(td=td, ts=ts, chunk=chunk, stage_min=stage_min)
    out = SB.spmm_blocked(layout, _t(x)).numpy()
    want = dense.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(out, want, atol=1e-5 * max(
        1.0, np.abs(want).max()))
    assert (out[n // 3: n // 2] == 0).all()
    dst, src, val, _ = _global_entries(layout)
    assert sorted(zip(dst.tolist(), src.tolist())) == \
        sorted(zip(row.tolist(), col.tolist()))


@pytest.mark.parametrize("n,td", [(1336, 16), (20000, 32), (40000, 64)])
def test_default_destination_tile_shrinks_for_small_matrices(n, td):
    """Tiles of 64 rows unless that leaves the card under 512 thread
    blocks a column slab: then 32 or 16, so a coreset's subgraph (1336
    rows) spreads over 84 blocks instead of 21."""
    indptr = np.arange(n + 1)
    layout = SB.build_blocked(indptr, np.arange(n), None, device="cpu")
    assert layout.td == td
    x = torch.arange(2.0 * n).reshape(n, 2)
    assert torch.equal(SB.spmm_blocked_plain(layout, x), x)


@pytest.mark.parametrize("d", [16, 40, 64, 128, 129, 256])
def test_launch_plan_walks_the_entries_once_at_every_width(d):
    """One walk of a destination tile's entries covers every column up to
    128 float4 columns and 160 floats (the evaluator's [X | 1] at d = 129
    included); wider float4 rows (d = 256) take slabs of 128, one walk a
    slab.  The lanes cover every column; at d ≤ 64 several entries go to a
    warp at once so most of its lanes work (d = 40: 3 entries of 10
    float4s, 30 lanes)."""
    vec = d % 4 == 0
    plan = SB.launch_plan(d, vec)
    unit = 4 if vec else 1
    slab = SB.SLAB if vec and d > SB.SLAB else d
    assert plan["slab"] == slab and plan["n_slabs"] == -(-d // slab)
    assert plan["lpr"] * plan["nv"] * unit >= slab
    assert 1 <= plan["nv"] <= 5 and 1 <= plan["lpr"] <= 32
    assert plan["busy"] >= 30
    if d <= 64:
        assert plan["nv"] == 1 and 32 // plan["lpr"] >= 2
    # a staged tile of the slab's columns fits at the default ts = 64
    assert SB.launch_plan(d, vec, staged=True) == plan


def test_launch_plan_keeps_slabs_where_a_staged_tile_needs_them():
    """A staged source tile of ts rows holds the slab's columns: at
    ts = 448 only 128 float columns fit a block's shared memory, so a row
    of 150 floats walks twice there; without staged blocks, or at 129
    floats, it walks once."""
    staged = SB.launch_plan(150, False, ts=448, staged=True)
    assert (staged["slab"], staged["n_slabs"]) == (128, 2)
    assert SB.launch_plan(150, False, ts=448)["n_slabs"] == 1
    assert SB.launch_plan(129, False, ts=448, staged=True)["n_slabs"] == 1


@pytest.mark.parametrize("d,walks", [(40, 1), (64, 1), (128, 1), (129, 1),
                                     (192, 2), (256, 2)])
def test_launch_plan_cuts_wide_float4_rows_of_an_x_beyond_l2(d, walks):
    """Float4 rows wider than 128 columns take slabs of 128, whatever the
    matrix: on the arxiv twin, whose x at d = 256 is over three times L2,
    a slab of 128 columns gathers from half the bytes and two slabs beat
    one walk.  Rows of floats (d = 129) keep one walk."""
    vec = d % 4 == 0
    plan = SB.launch_plan(d, vec)
    assert plan["n_slabs"] == walks
    assert plan["slab"] == (SB.SLAB if walks > 1 else d)


def test_unweighted_adjacency_means_ones():
    ei = np.array([[0, 0, 2, 3], [1, 2, 0, 3]])
    adj = G.from_edge_index(ei, 4, device="cpu")
    assert adj.val is None
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    want = adj.to_dense() @ x
    assert torch.equal(SB.spmm_blocked(adj.blocked(), x), want)
    assert torch.equal(adj.matmul(x), want)


@pytest.mark.parametrize("symmetric", [False, True])
def test_spmm_blocked_gradient_is_the_transposed_product(case, symmetric):
    """``SpmmBlocked`` on the plain path: gradcheck in float64, and the
    gradient against the dense product at 1e-5."""
    _, tadj, _ = case
    if symmetric:
        adj = tadj
    else:
        rng = np.random.default_rng(5)
        ei = np.stack([rng.integers(0, 60, 300), rng.integers(0, 60, 300)])
        adj = G.from_edge_index(ei, 60, device="cpu", edge_weight=rng.normal(
            size=300).astype(np.float32))
    n = adj.n_rows
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, 5, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    with torch.enable_grad():
        assert torch.autograd.gradcheck(
            lambda t: SB.SpmmBlocked.apply(t, adj), (x,))
        g = torch.randn(n, 5, generator=gen, dtype=torch.float64)
        (gx,) = torch.autograd.grad(SB.SpmmBlocked.apply(x, adj), x, g)
    want = adj.to_dense().double().T @ g
    assert torch.allclose(gx, want, atol=1e-5)
    # a symmetric matrix shares one layout with its transpose
    assert (adj.blocked(transpose=True) is adj.blocked()) == symmetric


def test_spmm_blocked_refuses_a_gradient_for_the_values():
    ei = np.array([[0, 1], [1, 0]])
    adj = G.from_edge_index(ei, 2, edge_weight=np.ones(2, np.float32),
                            device="cpu")
    adj = adj.with_val(adj.val.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError):
        SB.SpmmBlocked.apply(torch.ones(2, 3), adj)


def test_kernel_takes_float32_only(case):
    _, tadj, x = case
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SB._check(tadj.blocked(), _t(x).to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        SB._check(tadj.blocked(), _t(x).double())


@pytest.fixture(scope="module")
def segments():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 12, 200)
    ids[ids == 5] = 6                      # an empty segment
    return ids, rng.normal(size=(200, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_segment_reductions_match_jax(segments, name, ndim):
    ids, data = segments
    data = data if ndim == 2 else data[:, 0]
    want = np.asarray(getattr(JS, name)(jnp.asarray(data), jnp.asarray(ids),
                                        12))
    got = getattr(S, name)(_t(data), _t(ids), 12).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_segment_softmax_matches_jax(segments):
    ids, data = segments
    want = np.asarray(JS.segment_softmax(jnp.asarray(data[:, 0]),
                                         jnp.asarray(ids), 12))
    got = S.segment_softmax(_t(data[:, 0]), _t(ids), 12).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sddmm_rmatmul_sum_rows_match_jax(case):
    jadj, tadj, x = case
    rng = np.random.default_rng(9)
    b = rng.normal(size=x.shape).astype(np.float32)
    want = np.asarray(JSP.sddmm(jadj.row, jadj.col, jnp.asarray(x),
                                jnp.asarray(b)))
    # 16-term dot products up to |12|: 1e-6 of the largest value
    np.testing.assert_allclose(
        SP.sddmm(tadj.row, tadj.col, _t(x), _t(b)).numpy(), want,
        atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(
        tadj.rmatmul(_t(x), tadj.n_rows).numpy(),
        np.asarray(jadj.rmatmul(jnp.asarray(x), jadj.n_rows)), atol=1e-6)
    np.testing.assert_allclose(tadj.sum_rows().numpy(),
                               np.asarray(jadj.sum_rows()), atol=1e-6)
    np.testing.assert_allclose(
        SP.spmm_plain(tadj.row, tadj.col, tadj.val, _t(x),
                      tadj.n_rows).numpy(),
        np.asarray(JSP.spmm_xla(jadj.row, jadj.col, jadj.val,
                                jnp.asarray(x), jadj.n_rows)), atol=1e-6)


def _rect(m: int, n: int, density: float, seed: int):
    """A random [m, n] matrix with rows m//3..m//2 empty and one row that
    points at every column, as CSR arrays and dense."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < density) * rng.normal(size=(m, n))
    dense[m // 3: m // 2] = 0.0
    dense[m - 1] = rng.normal(size=n)
    dense = dense.astype(np.float32)
    row, col = np.nonzero(dense)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=m), out=indptr[1:])
    return indptr, col, dense[row, col], dense


@pytest.mark.parametrize("m,n", [(200, 77), (70, 300), (129, 1), (5, 1000)])
@pytest.mark.parametrize("sizes", [dict(td=16, ts=32, chunk=7, stage_min=4),
                                   dict(td=64, ts=64, chunk=2048,
                                        stage_min=10 ** 9), dict()])
def test_rectangular_layout_matches_the_dense_product(m, n, sizes):
    """An [m, n] layout (m ≠ n; a source count that is no multiple of the
    tile; empty rows; a staged and a direct branch): the plain version
    equals the dense product, and x must have n rows."""
    indptr, col, val, dense = _rect(m, n, 0.1, m * n)
    layout = SB.build_blocked(indptr, col, val, device="cpu", n_cols=n,
                              **sizes)
    assert (layout.n_rows, layout.n_cols) == (m, n)
    x = np.random.default_rng(1).normal(size=(n, 24)).astype(np.float32)
    out = SB.spmm_blocked(layout, _t(x)).numpy()
    want = dense.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5 * max(
        1.0, np.abs(want).max()))
    assert (out[m // 3: m // 2] == 0).all()
    with pytest.raises(ValueError, match=f"expected \\({n}, d\\)"):
        SB._check(layout, _t(np.zeros((m + n, 24), np.float32)))
    with pytest.raises(ValueError, match="outside"):
        SB.build_blocked(indptr, col, val, device="cpu", n_cols=int(
            col.max()) if col.size else 0)


def test_square_layout_unchanged_by_the_column_count(case):
    """A square matrix built with and without ``n_cols`` gives the same
    layout and the same product, bit for bit."""
    h = G.host_of(case[1])
    a = SB.build_blocked(h.indptr, h.col, h.val, device="cpu")
    b = SB.build_blocked(h.indptr, h.col, h.val, device="cpu",
                         n_cols=h.n_rows)
    for f in ("dst_local", "src_local", "val", "bounds", "blk_ptr",
              "blk_dst", "blk_src", "tile_ptr"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.n_cols == a.n_rows == b.n_cols
    x = torch.randn(h.n_rows, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(SB.spmm_blocked(a, x), SB.spmm_blocked(b, x))
