#!/usr/bin/env python3
"""Where the PGE kernels' time goes, on one CUDA card.

Run from the root of a checkout on a machine with a card:
``python3 tools/pge_kernel_phases.py``.  Two measurements, at the slice's
shapes (n = 1354, H = 256), with the kernels' bf16 matmul operands:

1. ``layers``: forward (the launch that keeps the workspace, and the one
   without) and backward ms of the real kernels for 0, 1 and 2 hidden
   layers; the step from 0 to 1 is the cost of one hidden layer.
2. ``phases``: diagnostic builds of the same sources under
   ``build/phases/`` (their results are wrong; only their time counts).
   ``csrc/pge_kernels.cuh`` carries the guards: with ``-DPGE_PHASES`` a
   runtime mask skips one phase at a time: in the forward the products'
   ``wgmma``, the statistics epilogue, the store of z and the output dot
   (the top layer's second product); in the backward the
   reduction pass, the dW product, the dX product, the layer-0 epilogue
   of the dX product (``l0_tile_sums``) and ``finish0``, and in every step
   of the two products the fetch, the convert-and-store or the
   ``wgmma`` part.  ``-DPGE_CONST=bits`` builds variants
   that replace an operand's staging arithmetic and loads by a constant:
   the forward matmul's A operand (X) or its W, the backward's dz (the B
   operand
   of dW and the A operand of dX; also its loads or its arithmetic alone)
   and the dW product's X operand.  The drop in time when a phase is
   skipped, or an operand is constant, is its cost.

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

# Bits of the runtime skip mask (enum Skip of csrc/pge_kernels.cuh).
MASKS = {"all phases": 0, "forward: skip wgmma": 1,
         "forward: skip statistics epilogue": 2,
         "forward: skip output dot (second product)": 4,
         "forward: skip store of z": 2048,
         "forward: only the statistics pass's staging": 1 + 2 + 4 + 2048,
         "skip dW product": 8, "skip dX product": 16,
         "skip reduction pass": 32, "skip layer-0 epilogue": 64,
         "skip finish0": 128, "backward: only reduction pass": 8 + 16 + 128,
         "backward: only dW product": 16 + 32 + 128,
         "backward: only dX product": 8 + 32 + 128,
         "backward: no phase (the wrapper's fills and sums)":
             8 + 16 + 32 + 128,
         # parts of a step of gemm_stage4 (both products of the backward)
         "products: skip fetch": 256,
         "products: skip convert and store": 512,
         "products: skip wgmma": 1024,
         "products: only fetch": 512 + 1024,
         "products: only convert and store": 256 + 1024,
         "products: only wgmma": 256 + 512,
         "products: the bare walk (a barrier a step)": 256 + 512 + 1024,
         "dW alone: only fetch": 16 + 32 + 128 + 512 + 1024,
         "dX alone: only fetch": 8 + 32 + 128 + 512 + 1024,
         "dW alone: the bare walk": 16 + 32 + 128 + 256 + 512 + 1024,
         "dX alone: the bare walk": 8 + 32 + 128 + 256 + 512 + 1024,
         "dW alone: skip fetch": 16 + 32 + 128 + 256,
         "dX alone: skip fetch": 8 + 32 + 128 + 256}
# Variant -> bits of -DPGE_CONST (enum Const of csrc/pge_kernels.cuh).
VARIANTS = {"base": 0, "a_const": 1, "b_const": 2, "dz_const": 4 + 8,
            "dz_noload": 4, "dz_nocvt": 8, "x_const": 16}


def build_variant(variant: str) -> str:
    d = os.path.join(OUT, variant)
    os.makedirs(d, exist_ok=True)
    so = os.path.join(d, "libpge_phases.so")
    res = subprocess.run(
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-DPGE_PHASES", f"-DPGE_CONST={VARIANTS[variant]}", "-o", so,
         os.path.join(CSRC, "pge.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"pge_kernel_phases: nvcc failed for {variant}:\n"
                         + res.stderr[-3000:])
    # registers and spills of the kernels (the forward at H = 256)
    lines = res.stderr.splitlines()
    for i, ln in enumerate(lines):
        for key, what in (("pge_bwd_kernel", "bwd"),
                          ("pge_fwd_kernelILi4", "fwd")):
            if key in ln and "Compiling" in ln:
                print(f"ptxas {variant} {what}: "
                      + " | ".join(x.strip() for x in lines[i + 1:i + 3]),
                      flush=True)
    return so


def load(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pge_fwd.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.pge_fwd.restype = i32
    lib.pge_bwd.argtypes = [ptr] * 18 + [i32] * 4 + [ptr]
    lib.pge_bwd.restype = i32
    lib.pge_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.pge_blocks_per_sm.restype = i32
    lib.pge_fwd_smem_bytes.argtypes = [i32]
    lib.pge_fwd_smem_bytes.restype = i32
    lib.pge_set_skip.argtypes = [i32]
    lib.pge_set_skip.restype = i32
    return lib


def times(L2: int) -> tuple:
    """(forward keeping the workspace, forward without, backward) ms."""
    args = CS.pge_inputs(N, H, L2, seed=1, beta_shift=0.0)
    g = torch.randn(N, N, device="cuda")
    fwd = CS.timed_ms(lambda: K.pge_fwd(*args, N), 5)
    bare = CS.timed_ms(lambda: K.pge_fwd(*args, N, keep=False), 5)
    _, ws, stat = K.pge_fwd(*args, N)
    bwd = CS.timed_ms(lambda: K.pge_bwd(*args, g, ws, stat, N), 3)
    return fwd, bare, bwd


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pge_kernel_phases: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # what the card streams: one read of a tensor of the workspace's size
    x = torch.empty(K._workspace_sizes(N, H, 1)[0], device="cuda").normal_()
    ms = CS.timed_ms(lambda: x.sum(), 5)
    print(f"stream: torch.sum over {x.numel() * 4 / 1e9:.3f} GB in "
          f"{ms:.3f} ms = {x.numel() * 4 / ms / 1e9:.3f} TB/s; clocks "
          + subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                            "clocks.max.sm,clocks.max.mem",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
    del x
    K.build()
    for L2 in (0, 1, 2):
        f, f0, b = times(L2)
        print(f"layers L2={L2}: fwd {f:.3f} ms (no-grad {f0:.3f}), bwd "
              f"{b:.3f} ms", flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
    for variant, so in libs.items():
        K._LIB = load(so)
        K._PER_SM.clear()
        masks = MASKS if variant == "base" else {"all phases": 0}
        for name, mask in masks.items():
            if K._LIB.pge_set_skip(mask) != 0:
                raise SystemExit("pge_kernel_phases: pge_set_skip failed")
            f, f0, b = times(1)
            print(f"phases {variant} {name}: fwd {f:.3f} ms (no-grad "
                  f"{f0:.3f}), bwd {b:.3f} ms", flush=True)
    K._LIB = None
    K._PER_SM.clear()


if __name__ == "__main__":
    main()
