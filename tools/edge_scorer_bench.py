#!/usr/bin/env python3
"""MSGC's edge scorer kernels at the MSGC arxiv cell's size, on one card.

Run from the root of a checkout on a machine with a card:
``python3 tools/edge_scorer_bench.py``.  At n = 909 synthetic nodes,
d = 128 features, 40 classes and 16 skeletons (about 1.02 M entries), in
float32 with TF32 off, it prints:

1. the card's name and power limit, and nvcc's register and spill report
   of each kernel;
2. medians of CUDA-event times over ``--reps`` calls: the kernels'
   forward under no gradient, their forward that keeps z2, and
   forward with backward; the same for the plain version
   (``ScorerPlain``) and for the tensor-op scorer that the kernels
   replaced (autograd through every op); each with its peak memory above
   the inputs;
3. the forward's least time (``2·E·(2d·H + H²)`` operations at 67
   TFLOP/s) and its share of it;
4. device time by kernel over one forward and backward, from
   ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphslim_tpu_torch.kernels import edge_scorer as ES  # noqa: E402
from graphslim_tpu_torch.models import nn  # noqa: E402
from graphslim_tpu_torch.reduce import msgc  # noqa: E402

N, D, C, B = 909, 128, 40, 16
FP32_PEAK = 67e12
GIB = 1 << 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def setup(seed: int):
    rng = np.random.default_rng(seed)
    pool = rng.choice(C, 50 * N, p=rng.dirichlet(np.ones(C)))
    y = msgc.proportional_labels(pool, N, C)
    rows, cols, batches = msgc.build_skeletons(y, C, B, seed)
    dev = torch.device("cuda")
    scorer = msgc.EdgeScorer(D, N, B, rows, cols, batches, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = scorer.init(g)
    for v in params.values():
        for p in v:
            for t in p.values():
                t.requires_grad_(True)
    feat = torch.randn(N, D, generator=g, device=dev).requires_grad_(True)
    return scorer, params, feat


def flat(params):
    (l1, l2, l3), (n1, n2) = params["layers"], params["bns"]
    return [l1["w"], l1["b"], l2["w"], l2["b"], l3["w"], l3["b"],
            n1["scale"], n1["bias"], n2["scale"], n2["bias"]]


def tensor_ops(entries, feat, *p):
    """The scorer the kernels replaced: autograd through every op."""
    h = torch.cat([feat[entries.rows], feat[entries.cols]], dim=1)
    w1, b1, w2, b2, w3, b3, s1, t1, s2, t2 = p
    h = torch.relu(nn.bn_apply({"scale": s1, "bias": t1}, h @ w1 + b1))
    h = torch.relu(nn.bn_apply({"scale": s2, "bias": t2}, h @ w2 + b2))
    return torch.sigmoid((h @ w3 + b3).reshape(-1))


def timed(fn, reps: int) -> tuple:
    """(median ms, peak GiB above what was allocated before) of ``fn``."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    peak = (torch.cuda.max_memory_allocated() - base) / GIB
    return statistics.median(times), peak


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2)
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    ES.build()
    print(f"build: {ES.BUILD_INFO['seconds']:.1f} s")
    for line in ES.BUILD_INFO["report"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    scorer, params, feat = setup(a.seed)
    E = scorer.entries.E
    p = flat(params)
    w = torch.randn(E, device="cuda")
    print(f"E = {E}, n = {N}, 2d = {2 * D}, H = {msgc.SCORER_HIDDEN}")

    def nograd(fn):
        def run():
            with torch.no_grad():
                fn(scorer.entries, feat, *p)
        return run

    def keep(fn):
        def run():
            with torch.enable_grad():
                fn(scorer.entries, feat, *p)
        return run

    def both(fn):
        def run():
            with torch.enable_grad():
                s = fn(scorer.entries, feat, *p)
                torch.autograd.grad((s * w).sum(), p + [feat])
        return run

    kernels = ES.ScorerKernels.apply
    plain = ES.ScorerPlain.apply
    rows = [("kernels", "forward, no gradient",
             nograd(lambda *x: ES.forward(*x)[0])),
            ("kernels", "forward keeping z2", keep(kernels)),
            ("kernels", "forward + backward", both(kernels)),
            ("plain", "forward, no gradient",
             nograd(lambda *x: ES.forward_plain(*x)[0])),
            ("plain", "forward + backward", both(plain)),
            ("tensor ops", "forward, no gradient", nograd(tensor_ops)),
            ("tensor ops", "forward keeping", keep(tensor_ops)),
            ("tensor ops", "forward + backward", both(tensor_ops))]
    got = {}
    for who, what, fn in rows:
        ms, peak = timed(fn, a.reps)
        got[(who, what)] = ms
        print(f"{who:10s} {what:24s} {ms:9.3f} ms  peak {peak:.4f} GiB")
    flops = 2.0 * E * (2 * D * 256 + 256 * 256 + 256)
    least = flops / FP32_PEAK * 1e3
    fwd = got[("kernels", "forward, no gradient")]
    print(f"forward least {least:.3f} ms ({flops / 1e12:.4f} TFLOP at 67 "
          f"TFLOP/s): kernels at {100 * least / fwd:.2f} % of it")

    from torch.profiler import ProfilerActivity, profile
    both(kernels)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        both(kernels)()
        torch.cuda.synchronize()
    total = 0.0
    lines = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0:
            total += t
            lines.append((t, ev.count, ev.key))
    for t, n, key in sorted(lines, reverse=True)[:20]:
        print(f"  {t / 1e3:9.3f} ms  x{n:<3d} {key[:110]}")
    print(f"  {total / 1e3:9.3f} ms device time, one forward and backward")


if __name__ == "__main__":
    main()
