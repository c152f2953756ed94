"""Blocked SpMM for Hopper: layout, kernel wrapper, plain version.

``out = A @ x`` over a (dst_tile, src_tile)-blocked, dst-sorted COO layout.
The hand-written CUDA C++ kernel (``csrc/spmm_blocked.cu``) replaces the
TPU kernel ``kern`` of
``graphslim_tpu/kernels/pallas_spmm_blocked.py::spmm_blocked``, which the
TPU compiler could not build for want of an on-chip row gather; Hopper's
shared memory has one.

What the layout keeps of the TPU design, and what it changes for the card:

* entries are grouped by destination tile (``td`` rows) and, inside it, by
  source tile (``ts`` rows of ``x``), dst-sorted within a stored block, with
  ``bounds[b, r]`` the first entry of block ``b`` whose ``dst_local >= r``;
* stored blocks have variable length (an offsets table ``blk_ptr``), with
  no padding slots, so ``fill`` is 1; a (dst_tile, src_tile) run longer than
  ``chunk`` entries is cut into pieces of at most ``chunk``;
* a run is *staged* (its source tile is copied into shared memory and
  rows are gathered from there) only when it has at least ``stage_min``
  entries, by default ``STAGE_REUSE`` = 24 uses of every staged row.  The
  sparser runs of a destination tile are merged into one *direct* block
  (``blk_src = -1``) whose ``src_local`` holds global rows of ``x``, read
  through L2 and L1: staging a whole tile for a handful of rows would read
  more of ``x`` than the gather needs, and L1 (the same memory as shared
  memory) already serves moderate reuse.  Measured on the H100 at d = 128
  (``tools/spmm_tile_sweep.py``, td = ts = 64): at 14 uses a staged row the
  direct branch wins (0.33 against 0.39 ms), at 32 the staged one (0.64
  against 0.92 ms).  Those are synthetic banded graphs: the ogbn-arxiv
  twin in its random node order has about one entry per tile pair, so on
  the graphs the port loads every block is direct, and the staged branch
  runs only in the tests and the sweep;
* a destination tile has 64 rows, fewer for a matrix too small to fill the
  card with such tiles: on a coreset's subgraph (1336 rows) tiles of 16
  rows run the kernel in 0.010 ms against 0.016-0.021 ms with 64
  (``chip_smoke.py``, H100);
* one thread block owns one destination tile and walks its entries once
  for every column of ``x`` up to 128 float4 or 160 float columns
  (:func:`launch_plan`): lanes over the columns at d > 64, several entries
  of a row at once on groups of lanes at d ≤ 64; wider rows take slabs of
  128 columns, one walk each; no sum crosses thread blocks: no atomics,
  results repeat bit for bit.

The kernel is bound by bytes: entries × 8 B (index + value) + one read of
``x`` + one write of ``out`` at the card's memory rate.

:func:`spmm_blocked` launches the kernel for a CUDA tensor (or raises) and
takes :func:`spmm_blocked_plain` for a CPU tensor.  :class:`SpmmBlocked`
is the autograd Function behind ``SparseAdj.matmul`` on the card: its
backward launches the same kernel on the transposed layout.  ``LAUNCHES``
counts the kernel's launches, ``LAUNCHES_BY_WIDTH`` the same by d.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from graphslim_tpu_torch.kernels.build import load_library
from graphslim_tpu_torch.utils import resolve_device

SLAB = 128       # columns of a slab where d is cut into slabs (launch_plan)
WALK_FLOATS = 160  # widest row of floats (d no multiple of 4) walked once
TD = 64          # default destination-tile rows of a large matrix ...
TD_MIN = 16      # ... halved down to this while the matrix has fewer than
MIN_TILES = 512  # this many tiles (thread blocks a column slab: 4 an SM)
TS = 64          # default source-tile rows: 32 KB of shared memory a slab
CHUNK = 2048     # default longest stored block
STAGE_REUSE = 24  # uses of every staged row at which staging starts to pay
_MAX_SMEM = 232448   # bytes of shared memory a block can use on an H100

LAUNCHES = {"spmm_blocked": 0}
LAUNCHES_BY_WIDTH: dict = {}   # d → launches of the kernel at that width

_LIB = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_WIDTH.clear()


@dataclasses.dataclass(frozen=True)
class BlockedCOO:
    """Variable-length (dst_tile, src_tile)-blocked COO layout (tensors on
    one device; int32 indices)."""

    dst_local: torch.Tensor   # [nnz] row within the destination tile
    src_local: torch.Tensor   # [nnz] row within the source tile (staged)
    #                           or global source row (direct block)
    val: torch.Tensor         # [nnz] float32
    bounds: torch.Tensor      # [n_blocks, td + 1] per-row entry offsets
    blk_ptr: torch.Tensor     # [n_blocks + 1] first entry of a block
    blk_dst: torch.Tensor     # [n_blocks] destination tile
    blk_src: torch.Tensor     # [n_blocks] source tile, -1 = direct block
    tile_ptr: torch.Tensor    # [n_tiles + 1] first block of a dst tile
    n_rows: int               # the matrix is square
    td: int
    ts: int
    chunk: int
    n_staged: int             # stored blocks that are staged
    fill: float               # stored entries / slots (1: no padding)
    build_seconds: float

    @property
    def n_blocks(self) -> int:
        return self.blk_src.shape[0]

    @property
    def nnz(self) -> int:
        return self.val.shape[0]

    @property
    def device(self) -> torch.device:
        return self.val.device

    def describe(self) -> str:
        return (f"td={self.td} ts={self.ts} chunk={self.chunk}: "
                f"{self.build_seconds:.2f}s, blocks={self.n_blocks} "
                f"({self.n_staged} staged), fill={self.fill:.3f}, "
                f"slots={self.nnz / 1e6:.2f}M")


def build_blocked(indptr, col, val, td: Optional[int] = None, ts: int = TS,
                  chunk: int = CHUNK, stage_min: Optional[int] = None,
                  device=None) -> BlockedCOO:
    """Host-side layout build from the CSR arrays of a square matrix (rows
    sorted), moved once to ``device`` (the CUDA card unless the caller says
    otherwise).  ``val=None`` means ones.  ``td=None`` takes ``TD`` rows a
    destination tile, fewer for a matrix too small to fill the card with
    tiles of that size (a coreset's subgraph)."""
    t0 = time.perf_counter()
    indptr = np.asarray(indptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    n = indptr.shape[0] - 1
    nnz = col.shape[0]
    if td is None:
        td = TD
        while td > TD_MIN and -(-n // td) < MIN_TILES:
            td //= 2
    if min(td, ts, chunk) < 1:
        raise ValueError(f"td, ts and chunk must be positive, got "
                         f"{td}/{ts}/{chunk}")
    stage_min = STAGE_REUSE * ts if stage_min is None else int(stage_min)
    values = (np.ones(nnz, dtype=np.float32) if val is None
              else np.asarray(val, dtype=np.float32))
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dt = row // td
    st = col // ts
    n_tiles = -(-n // td)
    n_st = -(-n // ts) + 1
    # entries per (dst_tile, src_tile) run; sparse runs become direct (-1)
    _, inv, counts = np.unique(dt * n_st + st, return_inverse=True,
                               return_counts=True)
    st = np.where(counts[inv] >= stage_min, st, -1)
    # CSR order sorts by row, so a stable sort keeps dst order inside a run
    order = np.lexsort((st, dt))
    row, col, values, dt, st = (row[order], col[order], values[order],
                                dt[order], st[order])
    key = dt * n_st + (st + 1)
    run_start = np.concatenate([[0], np.flatnonzero(np.diff(key)) + 1]) \
        if nnz else np.zeros(0, dtype=np.int64)
    run_len = np.diff(np.concatenate([run_start, [nnz]]))
    pieces = -(-run_len // chunk)
    piece_of = np.repeat(np.arange(run_start.shape[0]), pieces)
    first_piece = np.cumsum(pieces) - pieces
    blk_start = run_start[piece_of] + chunk * (
        np.arange(piece_of.shape[0]) - first_piece[piece_of])
    n_blocks = blk_start.shape[0]
    blk_ptr = np.concatenate([blk_start, [nnz]]).astype(np.int64)
    blk_dst = dt[blk_start]
    blk_src = st[blk_start]
    tile_ptr = np.searchsorted(blk_dst, np.arange(n_tiles + 1), side="left")
    dst_local = row - dt * td
    src_local = np.where(st >= 0, col - st * ts, col)
    blk_of = np.repeat(np.arange(n_blocks), np.diff(blk_ptr))
    per_row = np.bincount(blk_of * td + dst_local,
                          minlength=n_blocks * td).reshape(n_blocks, td)
    bounds = np.zeros((n_blocks, td + 1), dtype=np.int64)
    np.cumsum(per_row, axis=1, out=bounds[:, 1:])
    dev = resolve_device(device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=dev)

    return BlockedCOO(
        dst_local=i32(dst_local), src_local=i32(src_local),
        val=torch.as_tensor(values, device=dev), bounds=i32(bounds),
        blk_ptr=i32(blk_ptr), blk_dst=i32(blk_dst), blk_src=i32(blk_src),
        tile_ptr=i32(tile_ptr), n_rows=n, td=td, ts=ts,
        chunk=chunk, n_staged=int((blk_src >= 0).sum()),
        fill=1.0 if nnz else 0.0,
        build_seconds=time.perf_counter() - t0)


def transpose_csr(indptr, col, val) -> tuple:
    """(indptr, col, val) of Aᵀ from the CSR arrays of a square matrix A
    (host NumPy)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    n = indptr.shape[0] - 1
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.lexsort((row, col))
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(col, minlength=n), out=t_indptr[1:])
    return (t_indptr, row[order],
            None if val is None else np.asarray(val)[order])


# ---------------------------------------------------------------------------
# Plain version (CPU path and the kernel's reference on the card)
# ---------------------------------------------------------------------------

def spmm_blocked_plain(layout: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in tensor ops over the same layout arrays:
    gather by ``src_local`` + tile offset, scale, ``index_add_`` by
    ``dst_local`` + tile offset."""
    blk_of = torch.repeat_interleave(
        torch.arange(layout.n_blocks, device=layout.device),
        torch.diff(layout.blk_ptr.long()))
    src0 = torch.clamp(layout.blk_src.long(), min=0) * layout.ts
    src = layout.src_local.long() + src0[blk_of]
    dst = layout.dst_local.long() + layout.blk_dst.long()[blk_of] * layout.td
    gathered = x.index_select(0, src) * layout.val.to(x.dtype).unsqueeze(-1)
    out = x.new_zeros((layout.n_rows, x.shape[1]))
    return out.index_add_(0, dst, gathered)


# ---------------------------------------------------------------------------
# Build, binding and launch
# ---------------------------------------------------------------------------

def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = load_library("spmm_blocked")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spmm_blocked.argtypes = [ptr] * 8 + [i32] * 11 + [ptr]
    lib.spmm_blocked.restype = i32
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


def _check(layout: BlockedCOO, x: torch.Tensor) -> None:
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(
            "the blocked SpMM kernel takes float32; bf16 storage of x "
            "goes only to the ELL product (kernels/ell.spmm_ell) and GAT's "
            "messages, never to the blocked layout, as in the JAX package "
            "(ROADMAP.md §3)")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] != layout.n_rows:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({layout.n_rows}, d)")
    if x.device != layout.device:
        raise ValueError(f"x is on {x.device}, the layout on "
                         f"{layout.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def launch_plan(d: int, vec: bool, ts: int = TS,
                staged: bool = False) -> dict:
    """How one launch covers ``d`` columns (``csrc/spmm_blocked.cu``).

    ``slab``: columns a thread block walks the entries for.  All of ``d``
    up to ``SLAB`` = 128 float4 columns, or ``WALK_FLOATS`` = 160 when d
    is no multiple of 4 (the evaluator's [X | 1] at d = 129): one walk of a
    destination tile's entries.  Wider rows, and a staged source tile of
    ``ts`` rows that would not fit shared memory, take slabs of 128
    (on the arxiv twin at d = 256 one walk read 1.3534 ms against 1.0885
    for two slabs, ``chip_smoke.py`` on an H100 80GB HBM3 at 700 W:
    ``PERF.md``).  ``n_slabs``: walks of a tile's entries
    (grid.y).  A lane covers ``nv`` ≤ 5 items (float4s with ``vec``, else
    floats) of a row at ``lpr`` = 32 lanes a row; a row of at most 16
    items takes ``lpr`` = items lanes and ``32 // lpr`` entries at once.
    ``busy``: lanes of a warp that work."""
    unit = 4 if vec else 1
    slab = d if d <= (SLAB if vec else WALK_FLOATS) else SLAB
    if staged and ts * slab * 4 > _MAX_SMEM:
        slab = SLAB
    items = -(-slab // unit)
    if items <= 16:
        lpr, nv = items, 1
    else:
        lpr, nv = 32, -(-items // 32)
    return dict(slab=slab, n_slabs=-(-d // slab), lpr=lpr, nv=nv,
                busy=(32 // lpr) * min(lpr, items))


def spmm_blocked_cuda(layout: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel: ``A @ x`` as float32 [n_rows, d]."""
    if not x.is_cuda:
        raise ValueError("the blocked SpMM kernel takes CUDA tensors")
    _check(layout, x)
    d = x.shape[1]
    out = torch.empty((layout.n_rows, d), dtype=torch.float32,
                      device=x.device)
    if layout.n_rows == 0 or d == 0:
        return out
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = launch_plan(d, vec, layout.ts, layout.n_staged > 0)
    smem = layout.ts * plan["slab"] * 4 if layout.n_staged else 0
    if smem > _MAX_SMEM:
        raise ValueError(f"a staged source tile of ts={layout.ts} rows "
                         f"needs {smem} bytes of shared memory, over the "
                         f"{_MAX_SMEM} a block has")
    lib = build()
    rc = lib.spmm_blocked(
        layout.tile_ptr.data_ptr(), layout.blk_ptr.data_ptr(),
        layout.blk_src.data_ptr(), layout.bounds.data_ptr(),
        layout.src_local.data_ptr(), layout.val.data_ptr(), x.data_ptr(),
        out.data_ptr(), layout.n_rows, layout.n_rows, d, layout.td,
        layout.ts, layout.tile_ptr.shape[0] - 1, smem, int(vec),
        plan["slab"], plan["lpr"], plan["nv"],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_blocked_kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["spmm_blocked"] += 1
    LAUNCHES_BY_WIDTH[d] = LAUNCHES_BY_WIDTH.get(d, 0) + 1
    return out


def spmm_blocked(layout: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the layout: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if x.device.type == "cuda":
        return spmm_blocked_cuda(layout, x)
    if x.device.type == "cpu":
        return spmm_blocked_plain(layout, x)
    raise ValueError(f"no blocked SpMM path for device {x.device}")


class SpmmBlocked(torch.autograd.Function):
    """``adj @ x`` through :func:`spmm_blocked` on ``adj.blocked()``; the
    backward is ``adjᵀ @ g``, the same function on the transposed layout
    (``adj.blocked(transpose=True)``, built at the first backward).  There
    is no gradient with respect to the adjacency's values."""

    @staticmethod
    def forward(ctx, x, adj):
        if adj.val is not None and adj.val.requires_grad:
            raise NotImplementedError(
                "the blocked SpMM has no gradient with respect to the "
                "adjacency's values")
        ctx.adj = adj
        return spmm_blocked(adj.blocked(), x.contiguous())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return spmm_blocked(ctx.adj.blocked(transpose=True),
                            g.contiguous()), None
