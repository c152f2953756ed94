"""ctypes bindings for the C++ host ops of ``graphslim_native.cpp``.

The source beside this file is compiled with ``g++`` at first use into
``build/native/`` as a library named by a hash of the source, the flags
(``CXXFLAGS``) and the target ``-march=native`` resolves to on this host,
so an edited source or another host's CPU gets a build of its own.  A
failed build raises with the compiler's output: no op has a Python
fallback.  Bound here are the ops the structural reducers call: the
greedy t-spanner, the greedy matching and the exact blossom matching.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "graphslim_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_LIB = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot "
                           "be built")
    return cxx


def library_path(cxx: str) -> Path:
    """The library's path: named by a hash of the source, the flags and
    the target options they resolve to (``g++ -Q --help=target``)."""
    target = subprocess.run([cxx, *CXXFLAGS, "-Q", "--help=target"],
                            capture_output=True).stdout
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
                            + target).hexdigest()[:16]
    return BUILD_DIR / f"libgraphslim_native_{digest}.so"


def build() -> Path:
    """Compile the library unless a build of this source is there."""
    cxx = _compiler()
    so = library_path(cxx)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
    cmd = [cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                           + res.stderr[-4000:])
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The native library, built first when it has no build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.greedy_matching.restype = ctypes.c_int64
    lib.greedy_matching.argtypes = [i64p, i64p, f64p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_double, i64p]
    lib.t_spanner.restype = ctypes.c_int64
    lib.t_spanner.argtypes = [i64p, i64p, f64p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_double, i64p]
    lib.max_weight_matching.restype = ctypes.c_int64
    lib.max_weight_matching.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                        ctypes.c_int64, i64p]
    _LIB = lib
    return lib


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _edges(src, dst) -> tuple:
    return (np.ascontiguousarray(src, dtype=np.int64),
            np.ascontiguousarray(dst, dtype=np.int64))


def t_spanner(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
              n: int, t: float) -> np.ndarray:
    """Indices of the edges the exact greedy t-spanner keeps (lightest
    first; an edge stays iff the kept edges give no path within ``t·w``)."""
    lib = load()
    src, dst = _edges(src, dst)
    w = np.ascontiguousarray(weight, dtype=np.float64)
    out = np.empty(src.shape[0], dtype=np.int64)
    kept = lib.t_spanner(_i64(src), _i64(dst), _f64(w), src.shape[0], n,
                         float(t), _i64(out))
    return out[:kept]


def greedy_matching(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                    n: int, r: float) -> np.ndarray:
    """Heaviest-first disjoint edge matching, stopped at ``r·n`` pairs
    → pairs [k, 2]."""
    lib = load()
    src, dst = _edges(src, dst)
    w = np.ascontiguousarray(weight, dtype=np.float64)
    out = np.empty(2 * src.shape[0] + 2, dtype=np.int64)
    cnt = lib.greedy_matching(_i64(src), _i64(dst), _f64(w), src.shape[0],
                              n, float(r), _i64(out))
    return out[: 2 * cnt].reshape(-1, 2)


def max_weight_matching(src: np.ndarray, dst: np.ndarray,
                        weight: np.ndarray, n: int) -> np.ndarray:
    """Exact Edmonds blossom maximum-weight matching → pairs [k, 2].

    Float weights are scaled to int64 at 2^24 relative resolution (the
    duals of the primal-dual blossom stay integral, so the matching is
    exact for the scaled weights); edges of non-positive weight are
    ignored."""
    lib = load()
    src, dst = _edges(src, dst)
    w = np.asarray(weight, dtype=np.float64)
    wmax = float(w.max()) if w.size else 0.0
    if wmax <= 0:
        return np.zeros((0, 2), dtype=np.int64)
    wi = np.ascontiguousarray(
        np.maximum(np.round(w / wmax * (1 << 24)), 0).astype(np.int64))
    out = np.empty(2 * n + 2, dtype=np.int64)
    cnt = lib.max_weight_matching(_i64(src), _i64(dst), _i64(wi),
                                  src.shape[0], n, _i64(out))
    return out[: 2 * cnt].reshape(-1, 2)
