"""Fused PGE pair-scoring kernels for Hopper, with their plain version.

The PGE generator scores every (i, j) synthetic-node pair with an MLP; at
ogbn-arxiv scale (n_syn = 1354, nhid 256) that MLP is the bulk of the
operations of a GCond outer step.  Two hand-written CUDA C++ kernels for
``sm_90a`` (``csrc/pge_kernels.cuh``) replace the TPU kernels
``graphslim_tpu/kernels/pallas_pge.py::_fwd_kernel`` (forward) and
``::_bwd_kernel`` (backward).  They read the factorized first-layer
projections ``a = x·W₀ₐ`` and ``b = x·W₀ᵦ + b₀`` and write the [n, n]
scores (forward) or the seven gradients (backward).  The forward keeps
each tile's pre-BatchNorm activations and statistics in a workspace in
device memory, which the backward reads instead of recomputing them.

BatchNorm statistics range over each (TI × TJ) = (16 × 128) tile of pairs,
with the pairs outside [n, n] masked out — the tile-local semantics of
``pallas_pge.py``, which :func:`pair_scores_plain` repeats with tensor ops.

Bound on the H100 at the slice's shapes (n = 1354, H = 256, L2 = 1): the
forward is 240 GFLOP of matmul over the valid pairs (0.24 ms at the
989 TFLOP/s bf16 peak) and bound by operations; the backward does twice
those operations (dW and dX) and reads the 1.9 GB workspace (0.56 ms at
3.35 TB/s), so it is bound by bytes.  With ``mm_bf16`` (the main path) the
matmuls run on the tensor cores (``mma.sync``), else on the CUDA cores in
fp32.

:func:`pair_scores` takes the kernels for a CUDA tensor and the plain
version for a CPU tensor; a CUDA tensor never falls back.  The kernels are
built with ``nvcc`` at first use into ``build/kernels/`` and bound with
ctypes; ``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from graphslim_tpu_torch.kernels.build import load_library

TI = 16           # score-tile rows    (csrc/pge_kernels.cuh: pge::TI)
TJ = 128          # score-tile columns (pge::TJ)
P = TI * TJ       # pairs per tile: the BatchNorm population
EPS = 1e-5        # BatchNorm epsilon
_H_MULTIPLE = 64  # the kernels' matmul tile width (pge::BN)

LAUNCHES = {"pge_fwd": 0, "pge_bwd": 0}

_LIB = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stat_rows(L2: int) -> int:
    """Rows of H floats in a block's statistics scratch
    (pge_kernels.cuh: stat_rows)."""
    return 4 * (L2 + 1) + 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

def build() -> ctypes.CDLL:
    """Compile the kernels (once per source version) and load them.

    ``BUILD_INFO`` records the library's path, the build seconds (0 when
    an existing build was reused) and nvcc's ``-Xptxas -v`` report.
    """
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = load_library("pge")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pge_fwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.pge_fwd.restype = i32
    lib.pge_bwd.argtypes = [ptr] * 18 + [i32] * 5 + [ptr]
    lib.pge_bwd.restype = i32
    lib.pge_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.pge_blocks_per_sm.restype = i32
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


def _grid(lib, device: torch.device, ntiles: int, bwd: bool,
          mm_bf16: bool) -> int:
    """Persistent grid: as many blocks as fit on the card at once (two
    per SM by the kernels' launch bounds), at most one per tile."""
    per_sm = ctypes.c_int(0)
    rc = lib.pge_blocks_per_sm(int(bwd), int(mm_bf16), ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"PGE kernel occupancy query failed: CUDA error "
                           f"{rc}, {per_sm.value} blocks per SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(ntiles, per_sm.value * sms))


def _check(a, b, wmid, bmid, gamma, beta, wlast, n: int, g=None):
    if not a.is_cuda:
        raise ValueError("the PGE kernels take CUDA tensors")
    H = a.shape[1]
    L2 = wmid.shape[0]
    shapes = {"a": (a, (n, H)), "b": (b, (n, H)),
              "wmid": (wmid, (L2, H, H)), "bmid": (bmid, (L2, H)),
              "gamma": (gamma, (L2 + 1, H)), "beta": (beta, (L2 + 1, H)),
              "wlast": (wlast, (1, H))}
    if g is not None:
        shapes["g"] = (g, (n, n))
    for name, (t, shape) in shapes.items():
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1 or H % _H_MULTIPLE:
        raise ValueError(f"the PGE kernels need n >= 1 and a width that is "
                         f"a multiple of {_H_MULTIPLE}; got n={n}, H={H}")
    return H, L2


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _workspace_sizes(n: int, H: int, L2: int) -> tuple:
    """Floats of the per-tile workspace and statistics the forward kernel
    writes and the backward kernel reads."""
    ntiles = _cdiv(n, TI) * _cdiv(n, TJ)
    return ntiles * L2 * P * H, ntiles * _stat_rows(L2) * H


def pge_fwd(a, b, wmid, bmid, gamma, beta, wlast, n: int,
            mm_bf16: bool) -> tuple:
    """(scores [n, n] without the final bias, workspace, statistics) from
    the forward kernel; the last two are what :func:`pge_bwd` reads."""
    H, L2 = _check(a, b, wmid, bmid, gamma, beta, wlast, n)
    lib = build()
    ntiles = _cdiv(n, TI) * _cdiv(n, TJ)
    grid = _grid(lib, a.device, ntiles, False, mm_bf16)
    f32 = dict(dtype=torch.float32, device=a.device)
    out = torch.empty(n, n, **f32)
    n_ws, n_stat = _workspace_sizes(n, H, L2)
    ws = torch.empty(n_ws, **f32)
    stat = torch.empty(n_stat, **f32)
    rc = lib.pge_fwd(_p(a), _p(b), _p(wmid), _p(bmid), _p(gamma), _p(beta),
                     _p(wlast), _p(out), _p(ws), _p(stat), n, H, L2, grid,
                     int(mm_bf16), _stream(a.device))
    if rc != 0:
        raise RuntimeError(f"pge_fwd_kernel launch failed: CUDA error {rc}")
    LAUNCHES["pge_fwd"] += 1
    return out, ws, stat


def pge_bwd(a, b, wmid, bmid, gamma, beta, wlast, g, ws, stat, n: int,
            mm_bf16: bool) -> tuple:
    """(da, db, dwmid, dbmid, dgamma, dbeta, dwlast) from the backward
    kernel, given the forward kernel's workspace and statistics for the
    same inputs; per-block and per-tile partials are summed here."""
    H, L2 = _check(a, b, wmid, bmid, gamma, beta, wlast, n, g=g)
    for name, t, size in zip(("ws", "stat"), (ws, stat),
                             _workspace_sizes(n, H, L2)):
        if (t.device != a.device or t.dtype != torch.float32
                or t.numel() != size or not t.is_contiguous()):
            raise ValueError(f"{name} is not the forward kernel's {name} "
                             f"for these shapes")
    lib = build()
    ni, nj = _cdiv(n, TI), _cdiv(n, TJ)
    grid = _grid(lib, a.device, ni * nj, True, mm_bf16)
    f32 = dict(dtype=torch.float32, device=a.device)
    dwmid = torch.zeros(grid, L2, H, H, **f32)
    dbmid = torch.zeros(grid, L2, H, **f32)
    dgamma = torch.zeros(grid, L2 + 1, H, **f32)
    dbeta = torch.zeros(grid, L2 + 1, H, **f32)
    dwlast = torch.zeros(grid, H, **f32)
    da_part = torch.empty(nj, ni * TI, H, **f32)
    db_part = torch.empty(ni, nj * TJ, H, **f32)
    dbuf = torch.empty(grid * 2 * P * H, **f32)
    rc = lib.pge_bwd(_p(a), _p(b), _p(wmid), _p(bmid), _p(gamma), _p(beta),
                     _p(wlast), _p(g), _p(dwmid), _p(dbmid), _p(dgamma),
                     _p(dbeta), _p(dwlast), _p(da_part), _p(db_part),
                     _p(dbuf), _p(ws), _p(stat), n, H, L2, grid,
                     int(mm_bf16), _stream(a.device))
    if rc != 0:
        raise RuntimeError(f"pge_bwd_kernel launch failed: CUDA error {rc}")
    LAUNCHES["pge_bwd"] += 1
    return (da_part.sum(0)[:n], db_part.sum(0)[:n], dwmid.sum(0),
            dbmid.sum(0), dgamma.sum(0), dbeta.sum(0),
            dwlast.sum(0).reshape(1, H))


class PGEPairScores(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, a, b, wmid, bmid, gamma, beta, wlast, n, mm_bf16):
        out, ws, stat = pge_fwd(a, b, wmid, bmid, gamma, beta, wlast, n,
                                mm_bf16)
        ctx.save_for_backward(a, b, wmid, bmid, gamma, beta, wlast, ws,
                              stat)
        ctx.n, ctx.mm_bf16 = n, mm_bf16
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *inputs, ws, stat = ctx.saved_tensors
        grads = pge_bwd(*inputs, g.contiguous(), ws, stat, ctx.n,
                        ctx.mm_bf16)
        return (*grads, None, None)


# ---------------------------------------------------------------------------
# Plain version (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad], dim=0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def pair_scores_plain(a, b, wmid, bmid, gamma, beta, wlast, n: int,
                      mm_bf16: bool = True) -> torch.Tensor:
    """The kernels' function in tensor ops over the padded tile grid,
    differentiable through autograd (``pallas_pge.pair_scores_ref`` with
    optional bf16 matmul operands)."""
    H = a.shape[1]
    L2 = wmid.shape[0]
    ni, nj = _cdiv(n, TI), _cdiv(n, TJ)
    ap = _pad_rows(a, ni * TI).reshape(ni, 1, TI, 1, H)
    bp = _pad_rows(b, nj * TJ).reshape(1, nj, 1, TJ, H)
    h = (ap + bp).reshape(ni * nj, P, H)
    gi = torch.arange(ni * TI, device=a.device).reshape(ni, 1, TI, 1) < n
    gj = torch.arange(nj * TJ, device=a.device).reshape(1, nj, 1, TJ) < n
    mask = (gi & gj).to(a.dtype).reshape(ni * nj, P, 1)
    count = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    for l in range(L2 + 1):
        if l > 0:
            w = wmid[l - 1]
            h = (_bf16(h) @ _bf16(w) if mm_bf16 else h @ w) + bmid[l - 1]
        hm = h * mask
        mean = hm.sum(1, keepdim=True) / count
        var = (hm * hm).sum(1, keepdim=True) / count - mean * mean
        xhat = (h - mean) * torch.rsqrt(var + EPS)
        h = torch.relu(xhat * gamma[l] + beta[l])
    out = (h * wlast[0]).sum(-1)
    out = out.reshape(ni, nj, TI, TJ).permute(0, 2, 1, 3)
    return out.reshape(ni * TI, nj * TJ)[:n, :n]


def pair_scores(a, b, wmid, bmid, gamma, beta, wlast, n: int,
                mm_bf16: bool = True) -> torch.Tensor:
    """Pair-MLP scores [n, n] (before symmetrize/sigmoid, no last bias):
    the CUDA kernels for a CUDA tensor, the plain version for a CPU one."""
    if a.device.type == "cuda":
        return PGEPairScores.apply(
            a.contiguous(), b.contiguous(), wmid.contiguous(),
            bmid.contiguous(), gamma.contiguous(), beta.contiguous(),
            wlast.contiguous(), n, mm_bf16)
    if a.device.type == "cpu":
        return pair_scores_plain(a, b, wmid, bmid, gamma, beta, wlast, n,
                                 mm_bf16)
    raise ValueError(f"no PGE path for device {a.device}")
