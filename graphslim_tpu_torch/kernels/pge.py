"""Fused PGE pair-scoring kernels for Hopper, with their plain version.

The PGE generator scores every (i, j) synthetic-node pair with an MLP; at
ogbn-arxiv scale (n_syn = 1354, nhid 256) that MLP is the bulk of the
operations of a GCond outer step.  Two hand-written CUDA C++ kernels for
``sm_90a`` (``csrc/pge_kernels.cuh``) replace the TPU kernels
``graphslim_tpu/kernels/pallas_pge.py::_fwd_kernel`` (forward) and
``::_bwd_kernel`` (backward).  They read the factorized first-layer
projections ``a = x·W₀ₐ`` and ``b = x·W₀ᵦ + b₀`` and write the [n, n]
scores (forward) or the seven gradients (backward).  The forward takes
each hidden layer's BatchNorm statistics in the epilogue of its product
and runs the top layer's product a second time to apply BatchNorm, ReLU
and the dot with ``wlast`` there (:func:`pair_scores_fwd_plain` is that
dataflow in tensor ops).  A launch whose scores feed the backward keeps
each tile's pre-BatchNorm activations and statistics in a workspace in
device memory, which the backward reads instead of recomputing them; a
launch under no gradient keeps none (:func:`keeps_workspace`).  The
backward keeps no gradient of a tile in device memory: a reduction pass
gives each layer's dγ and dβ, dz is formed while the operands of its two
products are staged, and layer 0 keeps only row and column sums, from
which da, db, dγ₀ and dβ₀ follow in closed form.
:func:`pair_scores_bwd_plain` is that dataflow in tensor ops.

BatchNorm statistics range over each (TI × TJ) = (16 × 128) tile of pairs,
with the pairs outside [n, n] masked out — the tile-local semantics of
``pallas_pge.py``, which :func:`pair_scores_plain` repeats with tensor ops.

Bound on the H100 at the slice's shapes (n = 1354, H = 256, L2 = 1): the
forward is 240 GFLOP of matmul over the valid pairs (0.24 ms at the
989 TFLOP/s bf16 peak) and bound by operations; the backward does twice
those operations (dW and dX) and reads the 1.9 GB workspace (0.56 ms at
3.35 TB/s), so it is bound by bytes.  The forward launch that keeps the
workspace also writes its 1.96 GB: 0.585 ms at 3.35 TB/s.  The matmuls
run on the tensor cores (``wgmma``) with bf16 operands and fp32
accumulators, the TPU kernel's numerics and the kernels' only precision.
``PERF.md`` holds the kernels' times beside these bounds.

:func:`pair_scores` takes the kernels for a CUDA tensor and the plain
version for a CPU tensor; a CUDA tensor never falls back (float32 matmul
operands, ``mm_bf16=False``, exist only in the plain version, which the
CPU runs and the tests hold the kernels to).  The kernels are
built with ``nvcc`` at first use into ``build/kernels/`` and bound with
ctypes; ``LAUNCHES`` counts each kernel's launches, the forward's two
kinds apart (``pge_fwd_ws`` keeps the workspace, ``pge_fwd_nows`` not).
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
_H_MULTIPLE = 64  # the kernels' products run in 64-column blocks

LAUNCHES = {"pge_fwd_ws": 0, "pge_fwd_nows": 0, "pge_bwd": 0}
# the last forward and backward launch: grid and the bytes of device-memory
# workspace or scratch the wrapper allocated for it
LAST_FWD: dict = {}
LAST_BWD: dict = {}

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
    lib.pge_bwd.argtypes = [ptr] * 18 + [i32] * 4 + [ptr]
    lib.pge_bwd.restype = i32
    lib.pge_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.pge_blocks_per_sm.restype = i32
    lib.pge_bwd_smem_bytes.argtypes = [i32]
    lib.pge_bwd_smem_bytes.restype = i32
    lib.pge_fwd_smem_bytes.argtypes = [i32]
    lib.pge_fwd_smem_bytes.restype = i32
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


_PER_SM: dict = {}


def blocks_per_sm(lib, bwd: bool, H: int) -> int:
    """Blocks of the forward or backward kernel that one SM holds at once
    (they depend on the width through the kernels' shared memory); asked
    once per case."""
    key = (bwd, H)
    if key not in _PER_SM:
        per_sm = ctypes.c_int(0)
        rc = lib.pge_blocks_per_sm(int(bwd), H, ctypes.byref(per_sm))
        if rc != 0 or per_sm.value < 1:
            raise RuntimeError(
                f"PGE kernel occupancy query failed: CUDA error {rc}, "
                f"{per_sm.value} blocks per SM")
        _PER_SM[key] = per_sm.value
    return _PER_SM[key]


def _grid(lib, device: torch.device, ntiles: int, bwd: bool,
          H: int) -> int:
    """Persistent grid: as many blocks as fit on the card at once (one per
    SM by the kernels' launch bounds), at most one per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(ntiles, blocks_per_sm(lib, bwd, H) * sms))


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


def fwd_buffer_sizes(n: int, H: int, L2: int, grid: int,
                     keep: bool) -> tuple:
    """Floats of (workspace, statistics) one forward launch allocates: the
    per-tile ones the backward reads when ``keep``, else a per-block
    buffer that only middle layers use (none for L2 ≤ 1)."""
    if keep:
        return _workspace_sizes(n, H, L2)
    return grid * max(L2 - 1, 0) * P * H, 0


def keeps_workspace(grad_enabled: bool, requires_grad: bool) -> bool:
    """Whether a forward launch keeps the per-tile workspace: only when
    its scores can reach the backward, i.e. gradients are recorded and
    some input requires one."""
    return grad_enabled and requires_grad


def pge_fwd(a, b, wmid, bmid, gamma, beta, wlast, n: int,
            keep: bool = True) -> tuple:
    """(scores [n, n] without the final bias, workspace, statistics) from
    the forward kernel; with ``keep`` the last two are the per-tile ones
    :func:`pge_bwd` reads, else the launch's own scratch (empty at
    L2 ≤ 1)."""
    H, L2 = _check(a, b, wmid, bmid, gamma, beta, wlast, n)
    lib = build()
    if lib.pge_fwd_smem_bytes(H) < 0:
        raise ValueError(f"the PGE forward kernel takes widths whose "
                         f"operands fit a block's shared memory (up to "
                         f"320), got {H}")
    ntiles = _cdiv(n, TI) * _cdiv(n, TJ)
    grid = _grid(lib, a.device, ntiles, False, H)
    f32 = dict(dtype=torch.float32, device=a.device)
    out = torch.empty(n, n, **f32)
    n_ws, n_stat = fwd_buffer_sizes(n, H, L2, grid, keep)
    ws = torch.empty(n_ws, **f32)
    stat = torch.empty(n_stat, **f32)
    LAST_FWD.update(grid=grid, keep=keep,
                    workspace_bytes=4 * (n_ws + n_stat))
    rc = lib.pge_fwd(_p(a), _p(b), _p(wmid), _p(bmid), _p(gamma), _p(beta),
                     _p(wlast), _p(out), _p(ws), _p(stat), n, H, L2, grid,
                     int(keep), _stream(a.device))
    if rc != 0:
        raise RuntimeError(f"pge_fwd_kernel launch failed: CUDA error {rc}")
    LAUNCHES["pge_fwd_ws" if keep else "pge_fwd_nows"] += 1
    return out, ws, stat


_MAX_H_BWD = 1024   # pge::MAX_H_BWD: the reduction pass's thread map


def bwd_scratch_shapes(n: int, H: int, L2: int, grid: int) -> dict:
    """Shapes of the float32 device-memory scratch one backward launch
    allocates: per-block partials of the parameter gradients, per-tile
    partials of da and db, and, only with two or more hidden layers, per
    block the raw dX of the middle layers (one buffer, two from L2 = 3).
    No [P, H] gradient buffer exists for L2 ≤ 1."""
    ni, nj = _cdiv(n, TI), _cdiv(n, TJ)
    shapes = {"dwmid": (grid, L2, H, H), "dbmid": (grid, L2, H),
              "dgamma": (grid, L2 + 1, H), "dbeta": (grid, L2 + 1, H),
              "dwlast": (grid, H), "da_part": (nj, ni * TI, H),
              "db_part": (ni, nj * TJ, H)}
    if L2 >= 2:
        shapes["dbuf"] = (grid, min(2, L2 - 1), P, H)
    return shapes


def pge_bwd(a, b, wmid, bmid, gamma, beta, wlast, g, ws, stat,
            n: int) -> tuple:
    """(da, db, dwmid, dbmid, dgamma, dbeta, dwlast) from the backward
    kernel, given the forward kernel's workspace and statistics for the
    same inputs; per-block and per-tile partials are summed here."""
    H, L2 = _check(a, b, wmid, bmid, gamma, beta, wlast, n, g=g)
    if H > _MAX_H_BWD:
        raise ValueError(f"the PGE backward kernel takes widths up to "
                         f"{_MAX_H_BWD}, got {H}")
    for name, t, size in zip(("ws", "stat"), (ws, stat),
                             _workspace_sizes(n, H, L2)):
        if (t.device != a.device or t.dtype != torch.float32
                or t.numel() != size or not t.is_contiguous()):
            raise ValueError(f"{name} is not the forward kernel's {name} "
                             f"for these shapes")
    lib = build()
    ni, nj = _cdiv(n, TI), _cdiv(n, TJ)
    grid = _grid(lib, a.device, ni * nj, True, H)
    f32 = dict(dtype=torch.float32, device=a.device)
    # partials a block adds to are zeroed; the per-tile ones and the dX
    # buffers are written before they are read
    buf = {name: (torch.empty if name in ("da_part", "db_part", "dbuf")
                  else torch.zeros)(shape, **f32)
           for name, shape in bwd_scratch_shapes(n, H, L2, grid).items()}
    dbuf = buf.get("dbuf")
    LAST_BWD.update(grid=grid, scratch_bytes=sum(
        t.numel() * t.element_size() for t in buf.values()))
    rc = lib.pge_bwd(_p(a), _p(b), _p(wmid), _p(bmid), _p(gamma), _p(beta),
                     _p(wlast), _p(g), _p(buf["dwmid"]), _p(buf["dbmid"]),
                     _p(buf["dgamma"]), _p(buf["dbeta"]), _p(buf["dwlast"]),
                     _p(buf["da_part"]), _p(buf["db_part"]),
                     None if dbuf is None else _p(dbuf), _p(ws), _p(stat),
                     n, H, L2, grid, _stream(a.device))
    if rc != 0:
        raise RuntimeError(f"pge_bwd_kernel launch failed: CUDA error {rc}")
    LAUNCHES["pge_bwd"] += 1
    return (buf["da_part"].sum(0)[:n], buf["db_part"].sum(0)[:n],
            buf["dwmid"].sum(0), buf["dbmid"].sum(0), buf["dgamma"].sum(0),
            buf["dbeta"].sum(0), buf["dwlast"].sum(0).reshape(1, H))


class PGEPairScores(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``."""

    @staticmethod
    def forward(ctx, a, b, wmid, bmid, gamma, beta, wlast, n):
        out, ws, stat = pge_fwd(a, b, wmid, bmid, gamma, beta, wlast, n,
                                keep=True)
        ctx.save_for_backward(a, b, wmid, bmid, gamma, beta, wlast, ws,
                              stat)
        ctx.n = n
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *inputs, ws, stat = ctx.saved_tensors
        grads = pge_bwd(*inputs, g.contiguous(), ws, stat, ctx.n)
        return (*grads, None)


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


def pair_scores_fwd_plain(a, b, wmid, bmid, gamma, beta, wlast, n: int,
                          mm_bf16: bool = True) -> torch.Tensor:
    """The forward kernel's dataflow in tensor ops, without
    autograd → scores [n, n].

    Layer 0: statistics in float64 from the factorization over the tile's
    valid rows and columns, then the folded operand X₀ = relu(b·s + a')
    with a' = a·s + t.  A hidden layer's statistics come from partial sums
    as the kernel's epilogue takes them, all in float64: a warp adds the
    16 pairs of one tile column, and those partials add up.  The
    output dot applies BatchNorm, ReLU and ``wlast`` to the top layer's z
    (the kernel recomputes that product; its value is the same)."""
    H, L2 = a.shape[1], wmid.shape[0]
    ni, nj = _cdiv(n, TI), _cdiv(n, TJ)
    T = ni * nj
    mm = (lambda x, y: _bf16(x) @ _bf16(y)) if mm_bf16 else torch.matmul
    at = _pad_rows(a, ni * TI).reshape(ni, 1, TI, H).expand(ni, nj, TI, H)
    bt = _pad_rows(b, nj * TJ).reshape(1, nj, TJ, H).expand(ni, nj, TJ, H)
    at, bt = at.reshape(T, TI, H), bt.reshape(T, TJ, H)
    rows = torch.arange(ni * TI, device=a.device).reshape(ni, 1, TI) < n
    cols = torch.arange(nj * TJ, device=a.device).reshape(1, nj, TJ) < n
    rmask = rows.expand(ni, nj, TI).reshape(T, TI, 1)
    cmask = cols.expand(ni, nj, TJ).reshape(T, TJ, 1)
    mask = (rmask.reshape(T, TI, 1, 1) & cmask.reshape(T, 1, TJ, 1))
    nvr = rmask.sum(1, keepdim=True).double()
    nvc = cmask.sum(1, keepdim=True).double()
    count = nvr * nvc                                     # [T, 1, 1]

    def fold(mean, var, l):
        invstd = torch.rsqrt(var.to(a.dtype) + EPS)
        scale = invstd * gamma[l]
        return scale, beta[l] - mean.to(a.dtype) * scale

    ad, bd = at.double() * rmask, bt.double() * cmask
    sa, sb = ad.sum(1, keepdim=True), bd.sum(1, keepdim=True)
    mean = sa / nvr + sb / nvc
    e2 = (nvc * (ad * ad).sum(1, keepdim=True)
          + nvr * (bd * bd).sum(1, keepdim=True) + 2 * sa * sb) / count
    scale, shift = fold(mean, e2 - mean * mean, 0)
    ap = (at * scale + shift) * rmask                     # [T, TI, H]
    x = torch.relu(bt[:, None] * scale[:, None] + ap[:, :, None])
    x = x.reshape(T, P, H)
    for l in range(1, L2 + 1):
        z = mm(x, wmid[l - 1]) + bmid[l - 1]
        zm = (z.reshape(T, TI, TJ, H) * mask)
        zd = zm.double()
        s1 = zd.sum(1).sum(1, keepdim=True)               # [T, 1, H]
        s2 = (zd * zd).sum(1).sum(1, keepdim=True)
        mean = s1 / count
        scale, shift = fold(mean, s2 / count - mean * mean, l)
        x = torch.relu(z * scale + shift)
    out = (x * wlast[0]).sum(-1)
    out = out.reshape(ni, nj, TI, TJ).permute(0, 2, 1, 3)
    return out.reshape(ni * TI, nj * TJ)[:n, :n]


def pair_scores_bwd_plain(a, b, wmid, bmid, gamma, beta, wlast, g, n: int,
                          mm_bf16: bool = True) -> tuple:
    """The backward kernel's dataflow in tensor ops, without autograd →
    (da, db, dwmid, dbmid, dgamma, dbeta, dwlast) for the cotangent ``g``
    [n, n] of the scores.

    Per tile and layer, from the top: one reduction pass gives dγ, dβ (and
    dwlast); dz = (γ·dy − γ·dβ/count − x̂·γ·dγ/count)·invstd is formed where
    the two products read it (dW += Xᵀ·dz and dX = dz·Wᵀ) and never stored.
    Layer 0 keeps only the row and column sums of dy₀ = relu′·dX: x̂₀ =
    (a[i] + b[j] − μ)·invstd has closed-form row and column sums, so dγ₀,
    da and db follow from those sums and the per-channel constants."""
    H, L2 = a.shape[1], wmid.shape[0]
    ni, nj = _cdiv(n, TI), _cdiv(n, TJ)
    T = ni * nj
    mm = (lambda x, y: _bf16(x) @ _bf16(y)) if mm_bf16 else torch.matmul
    at = _pad_rows(a, ni * TI).reshape(ni, 1, TI, H).expand(ni, nj, TI, H)
    bt = _pad_rows(b, nj * TJ).reshape(1, nj, TJ, H).expand(ni, nj, TJ, H)
    at, bt = at.reshape(T, TI, H), bt.reshape(T, TJ, H)
    rows = torch.arange(ni * TI, device=a.device).reshape(ni, 1, TI) < n
    cols = torch.arange(nj * TJ, device=a.device).reshape(1, nj, TJ) < n
    rmask = rows.expand(ni, nj, TI).reshape(T, TI, 1).to(a.dtype)
    cmask = cols.expand(ni, nj, TJ).reshape(T, TJ, 1).to(a.dtype)
    mask = (rmask.reshape(T, TI, 1, 1) * cmask.reshape(T, 1, TJ, 1)
            ).reshape(T, P, 1)
    nvr, nvc = rmask.sum(1, keepdim=True), cmask.sum(1, keepdim=True)
    count = nvr * nvc                                     # [T, 1, 1]
    gt = torch.zeros(ni * TI, nj * TJ, dtype=a.dtype, device=a.device)
    gt[:n, :n] = g
    gt = gt.reshape(ni, TI, nj, TJ).permute(0, 2, 1, 3).reshape(T, P, 1)

    # the forward's workspace: pre-BN activations and statistics per layer
    z, mean, invstd = [], [], []
    h = (at[:, :, None, :] + bt[:, None, :, :]).reshape(T, P, H)
    for l in range(L2 + 1):
        if l > 0:
            h = mm(h, wmid[l - 1]) + bmid[l - 1]
        hm = h * mask
        mu = hm.sum(1, keepdim=True) / count
        var = (hm * hm).sum(1, keepdim=True) / count - mu * mu
        z.append(h)
        mean.append(mu)
        invstd.append(torch.rsqrt(var + EPS))
        h = torch.relu((h - mu) * invstd[l] * gamma[l] + beta[l])

    dwmid, dbmid = torch.zeros_like(wmid), torch.zeros_like(bmid)
    dgamma, dbeta = torch.zeros_like(gamma), torch.zeros_like(beta)
    up = gt * wlast[0]                  # gradient of the top layer's output
    for l in range(L2, 0, -1):
        xh = (z[l] - mean[l]) * invstd[l]
        pre = xh * gamma[l] + beta[l]
        if l == L2:
            dwlast = (torch.relu(pre) * gt * mask).sum((0, 1)).reshape(1, H)
        # reduction pass
        dy = torch.where(pre > 0, up, torch.zeros_like(up)) * mask
        db_l = dy.sum(1, keepdim=True)
        dg_l = (dy * xh).sum(1, keepdim=True)
        sxh = (xh * mask).sum(1, keepdim=True)
        sg = gamma[l] * invstd[l]
        c1, c2 = sg * db_l / count, sg * dg_l / count
        dgamma[l], dbeta[l] = dg_l.sum((0, 1)), db_l.sum((0, 1))
        dbmid[l - 1] = (sg * db_l - count * c1 - c2 * sxh).sum((0, 1))
        # dz where the products read it
        dz = (dy * sg - c1 - xh * c2) * mask
        xprev = torch.relu((z[l - 1] - mean[l - 1]) * invstd[l - 1]
                           * gamma[l - 1] + beta[l - 1])
        if mm_bf16:
            dwmid[l - 1] = torch.einsum("tpk,tpn->kn", _bf16(xprev),
                                        _bf16(dz))
        else:
            dwmid[l - 1] = torch.einsum("tpk,tpn->kn", xprev, dz)
        up = mm(dz, wmid[l - 1].T)      # raw dX of layer l - 1

    # layer 0: row and column sums of dy0, then closed forms
    mu, ist = mean[0], invstd[0]
    pre = (z[0] - mu) * ist * gamma[0] + beta[0]
    if L2 == 0:
        dwlast = (torch.relu(pre) * gt * mask).sum((0, 1)).reshape(1, H)
    dy = (torch.where(pre > 0, up, torch.zeros_like(up)) * mask
          ).reshape(T, TI, TJ, H)
    R, C = dy.sum(2), dy.sum(1)                           # [T, TI|TJ, H]
    db0 = R.sum(1, keepdim=True)
    dg0 = ist * ((at * R).sum(1, keepdim=True)
                 + (bt * C).sum(1, keepdim=True) - mu * db0)
    sa = (at * rmask).sum(1, keepdim=True)
    sb = (bt * cmask).sum(1, keepdim=True)
    sg = gamma[0] * ist
    c1, c2 = sg * db0 / count, sg * dg0 / count
    dgamma[0], dbeta[0] = dg0.sum((0, 1)), db0.sum((0, 1))
    da_t = (sg * R - nvc * c1
            - c2 * ist * (nvc * at + sb - nvc * mu)) * rmask
    db_t = (sg * C - nvr * c1
            - c2 * ist * (nvr * bt + sa - nvr * mu)) * cmask
    da = da_t.reshape(ni, nj, TI, H).sum(1).reshape(ni * TI, H)[:n]
    db = db_t.reshape(ni, nj, TJ, H).sum(0).reshape(nj * TJ, H)[:n]
    return da, db, dwmid, dbmid, dgamma, dbeta, dwlast


def pair_scores(a, b, wmid, bmid, gamma, beta, wlast, n: int,
                mm_bf16: bool = True) -> torch.Tensor:
    """Pair-MLP scores [n, n] (before symmetrize/sigmoid, no last bias):
    the CUDA kernels for a CUDA tensor, the plain version for a CPU one.
    On the card a launch keeps the workspace only where a gradient can
    follow (:func:`keeps_workspace`); the kernels take bf16 matmul
    operands only, so ``mm_bf16=False`` raises there."""
    if a.device.type == "cuda":
        if not mm_bf16:
            raise ValueError("the card's PGE kernels take bf16 matmul "
                             "operands only (mm_bf16=True); float32 "
                             "operands run in pair_scores_plain")
        args = [t.contiguous() for t in (a, b, wmid, bmid, gamma, beta,
                                         wlast)]
        if keeps_workspace(torch.is_grad_enabled(),
                           any(t.requires_grad for t in args)):
            return PGEPairScores.apply(*args, n)
        return pge_fwd(*args, n, keep=False)[0]
    if a.device.type == "cpu":
        return pair_scores_plain(a, b, wmid, bmid, gamma, beta, wlast, n,
                                 mm_bf16)
    raise ValueError(f"no PGE path for device {a.device}")
