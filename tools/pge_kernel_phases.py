#!/usr/bin/env python3
"""Where the PGE kernels' time goes, on one CUDA card.

Run from the root of a checkout on a machine with a card:
``python3 tools/pge_kernel_phases.py``.  Two measurements, at the slice's
shapes (n = 1354, H = 256) with bf16 matmul operands unless noted:

1. ``layers``: forward and backward ms of the real kernels for 0, 1 and 2
   hidden layers, in both precisions; the step from 0 to 1 is the cost of
   one hidden layer.
2. ``phases``: a diagnostic copy of the kernels, built under
   ``build/phases/``, in which a runtime mask skips one phase at a time
   (its results are wrong; only its time counts), and two variants whose
   forward matmul reads a constant A or B operand instead of loading it.
   The drop in time when a phase is skipped is that phase's cost.

Prints one line per timing; the numbers go to ``PERF.md`` with the card's
name and power limit, which the first line prints.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from graphslim_tpu_torch.kernels import pge as K  # noqa: E402
from graphslim_tpu_torch.kernels.build import nvcc  # noqa: E402

N, H = 1354, 256
CSRC = os.path.join(HERE, "graphslim_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "phases")

# Statements of csrc/pge_kernels.cuh guarded by a bit of the skip mask.
GUARDS = {
    "    layer_fwd<BF16>(C, l, smem);": 1,
    "    stats(C, l);": 2,
    "        s += C.xval(A.L2, p, c) * A.wlast[c];": 4,
    "      block_gemm<BF16, true, false>(": 8,
    "      block_gemm<BF16, false, true>(": 16,
    "    relu_back(C, G, L2, true, D, pdgamma, pdbeta, pdwlast);": 32,
    "      relu_back(C, G, l - 1, false, D2, pdgamma, pdbeta, pdwlast);": 32,
    "      bn_back(C, l, D, pdbmid);": 64,
    "    bn_back(C, 0, D, pdbmid);": 64,
}
MASKS = {"all phases": 0, "skip hidden matmul": 1,
         "skip layer-1 statistics": 2, "skip output dot": 4,
         "skip dW matmul": 8, "skip dX matmul": 16, "skip relu_back": 32,
         "skip bn_back": 64}
A_LOAD = "      [&](int p, int k) { return C.xval(l - 1, p, k); },"
B_LOAD = "      [&](int k, int n) { return W[(size_t)k * H + n]; },"


def diagnostic_source(variant: str) -> str:
    src = open(os.path.join(CSRC, "pge_kernels.cuh")).read()
    for stmt in (A_LOAD, B_LOAD):
        if stmt not in src:
            raise SystemExit(f"pge_kernel_phases: not found: {stmt!r}")
    src = src.replace("namespace pge {",
                      "namespace pge {\n__device__ int g_skip;", 1)
    for stmt, bit in GUARDS.items():
        if stmt not in src:
            raise SystemExit(f"pge_kernel_phases: not found: {stmt!r}")
        body = stmt.lstrip()
        src = src.replace(stmt, stmt[:len(stmt) - len(body)]
                          + f"if (!(g_skip & {bit})) " + body)
    if variant == "a_const":
        src = src.replace(A_LOAD, A_LOAD.replace(
            "C.xval(l - 1, p, k)", "(float)((p ^ k) & 7)"))
    elif variant == "b_const":
        src = src.replace(B_LOAD, B_LOAD.replace(
            "W[(size_t)k * H + n]", "(float)((k + n) & 7)"))
    return src


def build_variant(variant: str) -> str:
    d = os.path.join(OUT, variant)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "pge_kernels.cuh"), "w") as f:
        f.write(diagnostic_source(variant))
    cu = open(os.path.join(CSRC, "pge.cu")).read() + (
        '\nextern "C" int set_skip(int v) {\n'
        "  return (int)cudaMemcpyToSymbol(pge::g_skip, &v, sizeof(int));\n}\n")
    with open(os.path.join(d, "pge.cu"), "w") as f:
        f.write(cu)
    so = os.path.join(d, "libpge_phases.so")
    res = subprocess.run(
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
         os.path.join(d, "pge.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"pge_kernel_phases: nvcc failed for {variant}:\n"
                         + res.stderr[-3000:])
    return so


def load(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pge_fwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.pge_fwd.restype = i32
    lib.pge_bwd.argtypes = [ptr] * 18 + [i32] * 5 + [ptr]
    lib.pge_bwd.restype = i32
    lib.pge_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.pge_blocks_per_sm.restype = i32
    lib.set_skip.argtypes = [i32]
    lib.set_skip.restype = i32
    return lib


def times(L2: int, bf16: bool) -> tuple:
    args = CS.pge_inputs(N, H, L2, seed=1, beta_shift=0.0)
    g = torch.randn(N, N, device="cuda")
    fwd = CS.timed_ms(lambda: K.pge_fwd(*args, N, bf16), 5)
    _, ws, stat = K.pge_fwd(*args, N, bf16)
    bwd = CS.timed_ms(lambda: K.pge_bwd(*args, g, ws, stat, N, bf16), 3)
    return fwd, bwd


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pge_kernel_phases: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    K.build()
    for L2 in (0, 1, 2):
        for bf16 in (False, True):
            f, b = times(L2, bf16)
            print(f"layers L2={L2} bf16={bf16}: fwd {f:.3f} ms, bwd "
                  f"{b:.3f} ms", flush=True)
    variants = ("base", "a_const", "b_const")
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(build_variant, variants)))
    for variant, so in libs.items():
        K._LIB = load(so)
        masks = MASKS if variant == "base" else {"all phases": 0}
        for name, mask in masks.items():
            if K._LIB.set_skip(mask) != 0:
                raise SystemExit("pge_kernel_phases: set_skip failed")
            f, b = times(1, True)
            print(f"phases {variant} {name}: fwd {f:.3f} ms, bwd "
                  f"{b:.3f} ms", flush=True)
    K._LIB = None


if __name__ == "__main__":
    main()
