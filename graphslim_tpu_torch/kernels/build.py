"""Build and load the CUDA C++ kernels under ``csrc/``.

Each kernel module names one ``.cu`` file (plain C interface) and the
headers it includes.  ``nvcc`` compiles it for ``sm_90a`` at first use into
``build/kernels/`` as a shared library named by a hash of those sources, so
an edited source is rebuilt, and ctypes loads it.  :func:`prebuild` starts
the compilers of several libraries at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from graphslim_tpu_torch.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# name → (main .cu, every source that the hash covers)
LIBRARIES = {
    "pge": ("pge.cu", ("pge.cu", "pge_kernels.cuh")),
    "spmm_blocked": ("spmm_blocked.cu", ("spmm_blocked.cu",
                                         "spmm_common.cuh")),
    "smem_gather": ("smem_gather.cu", ("smem_gather.cu",
                                       "spmm_common.cuh")),
    "edge_scorer": ("edge_scorer.cu", ("edge_scorer.cu",)),
}

_SECONDS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str) -> tuple:
    _, sources = LIBRARIES[name]
    digest = hashlib.sha256(b"".join(
        (CSRC / s).read_bytes() for s in sources)).hexdigest()[:16]
    return (BUILD_DIR / f"lib{name}_{digest}.so",
            BUILD_DIR / f"lib{name}_{digest}.log")


def _command(name: str, out: Path) -> list:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / LIBRARIES[name][0])]


def prebuild(names=None) -> dict:
    """Compile every library of ``names`` (default: all) that has no build
    yet, one ``nvcc`` each, all started together → {name: seconds}."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        so, log = _paths(name)
        if so.exists():
            _SECONDS.setdefault(name, 0.0)
            continue
        tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, cmd, tmp, so, log, time.perf_counter()))
    errors = []
    for name, proc, cmd, tmp, so, log, t0 in running:
        out, _ = proc.communicate()
        _SECONDS[name] = time.perf_counter() - t0
        log.write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {LIBRARIES[name][0]}:\n"
                          + out[-4000:])
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _SECONDS[n] for n in names}


def load_library(name: str) -> tuple:
    """(ctypes library, build info) of one kernel library, compiled first
    when it has no build, in a ``kernels.load`` span (attributes
    ``library`` and ``built``, true when nvcc ran; counter
    ``kernels.built``).  The info holds the path, the build seconds (0
    when an existing build was reused; those of an earlier
    :func:`prebuild` when it built the library) and nvcc's ``-Xptxas -v``
    report."""
    with span("kernels.load", library=name) as s:
        so, log = _paths(name)
        built = not so.exists()
        prebuild([name])
        s.set(built=built)
        if built:
            count("kernels.built", 1)
        info = dict(path=str(so), seconds=_SECONDS.get(name, 0.0),
                    report=log.read_text() if log.exists() else "")
        return ctypes.CDLL(str(so)), info
