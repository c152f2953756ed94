"""Row gather for Hopper: ``out[e] = x[idx[e]]``.

The hand-written CUDA C++ kernels (``csrc/smem_gather.cu``) replace the TPU
probe kernel ``kern`` of ``benchmark/probe_spmm.py::vmem_gather``, which
measured the rate of a row gather from a source tile held on chip: the rate
that decides whether the blocked SpMM's staged source tile pays.  A TPU
core holds the probe's whole 2 MB source in on-chip memory; a thread block
has 227 KB of shared memory, so the staged kernel gives each block a slice
of ``ts`` source rows, which it copies into shared memory and serves the
indices that fall into it from (``staged=True``, what the probe times over
``ts``).  The direct kernel reads the rows straight from ``x`` through L2
(``staged=False``).  On the H100 the direct one was never slower than the
staged one at one use of a staged row (``chip_smoke.py``, gather probe),
so :func:`gather_rows` takes it.  Both are bound by bytes (``out`` +
``idx`` + ``x``); at the sizes the port gathers, a launch is a chain of
latencies, which the direct kernel keeps one link long per thread and
spreads over the whole card (see the note in the source).

:func:`gather_rows` launches the direct kernel for a CUDA tensor (or
raises) and takes :func:`gather_rows_plain` (``torch.index_select``) for a
CPU tensor.  ``LAUNCHES`` counts the kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphslim_tpu_torch.kernels.build import load_library

TILE_BYTES = 64 * 1024   # default shared-memory slice of a staging block
_MAX_SMEM = 232448       # bytes of shared memory a block can use on an H100
_NT = 256                # threads of a block (csrc/spmm_common.cuh: NT)

LAUNCHES = {"smem_gather": 0}

_LIB = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, info = load_library("smem_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.smem_gather.argtypes = [ptr, ptr, i32, ptr] + [i32] * 7 + [ptr]
    lib.smem_gather.restype = i32
    lib.gather_direct.argtypes = [ptr, ptr, i32, ptr] + [i32] * 5 + [ptr]
    lib.gather_direct.restype = i32
    BUILD_INFO.update(info)
    _LIB = lib
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function as one tensor op."""
    return torch.index_select(x, 0, idx)


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError("the gather kernel takes CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 matrix, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if idx.device != x.device or idx.ndim != 1 or \
            idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("idx must be an int32 or int64 vector on x's "
                         "device")
    if x.shape[0] == 0 and idx.shape[0] and x.shape[1]:
        raise ValueError("cannot gather from an empty source")


def direct_plan(n_idx: int, d: int, vec: bool) -> int:
    """Indices per blockIdx.y of a direct launch: the copy is cut into
    pieces of 16 bytes (``vec``) or 4, one a thread, so that a small gather
    covers the card; one blockIdx.y holds fewer than 2^31 pieces."""
    dv = d // 4 if vec else d
    return max(1, min(n_idx, (2 ** 31 - 1) // dv))


def _gather_direct(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n_src, d = x.shape
    n_idx = idx.shape[0]
    out = torch.empty((n_idx, d), dtype=torch.float32, device=x.device)
    if n_idx == 0 or d == 0:
        return out
    if not idx.is_contiguous():
        idx = idx.contiguous()
    xp, op = x.data_ptr(), out.data_ptr()
    vec = d % 4 == 0 and xp % 16 == 0 and op % 16 == 0
    rc = build().gather_direct(
        xp, idx.data_ptr(), idx.dtype == torch.int64, op, n_src, d, n_idx,
        direct_plan(n_idx, d, vec), vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_direct_kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["smem_gather"] += 1
    return out


def gather_rows_cuda(x: torch.Tensor, idx: torch.Tensor, *,
                     staged: bool = False, ts=None) -> torch.Tensor:
    """One launch of a kernel.  ``x`` is float32 [n_src, d] and contiguous,
    ``idx`` int32 or int64 [E] with values in [0, n_src).  ``staged``: each
    block copies its slice of ``ts`` source rows (default: a 64 KB slice)
    into shared memory first and serves the indices of its chunk that fall
    into it; otherwise the direct kernel reads the rows from ``x``."""
    _check(x, idx)
    if not staged:
        return _gather_direct(x, idx)
    n_src, d = x.shape
    n_idx = idx.shape[0]
    out = torch.empty((n_idx, d), dtype=torch.float32, device=x.device)
    if n_idx == 0 or d == 0:
        return out
    idx = idx.contiguous()
    if ts is None:
        ts = max(1, min(n_src, TILE_BYTES // (4 * d)))
    smem = ts * d * 4
    if ts < 1 or smem > _MAX_SMEM:
        raise ValueError(f"a slice of ts={ts} rows of {d} floats needs "
                         f"{smem} bytes of shared memory, over the "
                         f"{_MAX_SMEM} a block has")
    n_tiles = -(-n_src // ts)
    sms = _sm_count(x.device)
    # a staging block amortizes its copy over at least 1024 indices
    chunks = max(1, min(-(-4 * sms // n_tiles), -(-n_idx // 1024)))
    per_chunk = -(-n_idx // chunks)
    e_per_block = -(-per_chunk // _NT) * _NT
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = build()
    rc = lib.smem_gather(x.data_ptr(), idx.data_ptr(),
                         int(idx.dtype == torch.int64), out.data_ptr(),
                         n_src, d, n_idx, ts, e_per_block, smem, int(vec),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"smem_gather_kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["smem_gather"] += 1
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (rows): the kernel for a CUDA tensor, the plain version
    for a CPU one.  Not differentiable: the callers select rows of data."""
    if x.is_cuda:
        _check(x, idx)
        return _gather_direct(x, idx)
    if x.device.type == "cpu":
        return gather_rows_plain(x.detach(), idx)
    raise ValueError(f"no gather path for device {x.device}")
