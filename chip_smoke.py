#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``graphslim_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
line of output each, any failed check raises (non-zero exit):

1. the card's name and power limit; build of the kernels (one nvcc for
   each source under ``graphslim_tpu_torch/csrc``, all started together);
2. the PGE forward kernel against its plain version on the card, at the
   slice's shapes (n = 1354, H = 256, L2 = 1) and smaller ragged ones,
   in fp32 and with bf16 matmul operands;
3. the PGE backward kernel against autograd of the plain version, on all
   seven gradients, and in both precisions against a float64 plain
   version; at the slice's shape its time beside the bytes of
   device-memory scratch a launch allocates;
4. GCond on the full-width ``ogbn-arxiv`` twin (n_syn 1354, hidden 256,
   PGE nhid 256, 3 epochs × 20 outer steps, a checkpoint evaluation) through
   ``create_reducer(...).reduce()``, with the kernels' launch counts and a
   torch.profiler breakdown of one epoch;
5. SGC evaluation of ``benchmark/artifacts/arxiv_gcond_r0.01.npz``
   (3 seeds × 300 epochs, accuracy ≥ 0.80) and of the graph from phase 4;
6. the shared-memory row gather against ``torch.index_select`` (exact), at
   the TPU probe's shape (x 4096 × 128, 32,768 indices) for the source
   tile sizes the blocked SpMM considers, staged and direct, with its
   rates, at the shapes the coreset path gives it (every class's pool
   of the twin's training nodes out of 40- and 128-wide embeddings, then
   the 1336 selected rows), and at a width that is no multiple of 4 (the
   largest pool out of a 129-wide matrix, int32 and int64 indices);
7. the blocked SpMM kernel against its plain version and a float64
   product: (a) n = 500, d = 16, td = ts = 128; (b) the arxiv twin's
   normalized adjacency at d = 128, 256, 40 and 129, forward and backward,
   timed beside its bound and ``torch.sparse.mm``; (c) ragged graphs with
   empty rows and a row heavier than a tile; each result must repeat bit
   for bit;
8. the coreset path at full width through ``train_all.run`` on
   ``ogbn-arxiv`` (r = 0.01, hidden 256, 300 epochs): ``kcenter`` with
   GCN, ``herding`` with ``agg`` and SGC, ``cent_p`` with GCN, 3 seeds
   each, with the kernels' launch counts, a check of the GCN that KCenter
   trains (validation ≥ 0.60; logits through the kernel and through its
   plain version agree) and a torch.profiler breakdown of one epoch; then
   the blocked SpMM against its plain version, a float64 product and
   ``torch.sparse.mm`` on the subgraphs that kcenter and cent_p selected.

Phases 6 and 7 run before phase 4.  The line before the last is the
``kernels`` JSON; the last line is ``{"ok": true, "device": {...}}``.
``--only kernels`` stops after the kernel comparisons (phases 2, 3, 6, 7).
Without a CUDA card, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances of the kernel/plain comparisons, max|Δ| ≤ rtol·max|ref| + atol.
# Forward, fp32: only the summation order differs.  bf16: both versions
# round the matmul operands to bf16 (relative error 2^-9 each); a rounding
# flip of one operand moves a product by that much.
TOL_FWD = {False: (1e-4, 1e-5), True: (2e-2, 1e-4)}
# Backward, bf16: 1.5e-2, 1.7 times the largest reading on the H100 (8.8e-3
# of max|grad|, dwmid at n = 1354): the kernel rounds dz to bf16 before its
# matmuls where autograd of the plain version rounds the matmul results
# instead.  A per-channel sum over all pairs (dbeta, dgamma) can cancel to
# a small result, and there the two roundings differ by more (4.7e-2 of
# max|dbeta| at n = 500, beta + 4); such a gradient passes only where the
# kernel is nearer float64 than the plain version.  Both bf16 gradients
# are held to the float64 gradient with fp32 operands (the exact
# function): |kernel - f64| ≤ 2·|plain bf16 - f64| + 1e-4·max|f64|.
# fp32: per case below.  At n ≥ 500 the fp32 gradient is ill-conditioned in
# a few tiles (a pre-activation within rounding of the ReLU kink, or a
# channel whose BatchNorm variance nearly cancels): measured on the H100,
# the plain fp32 version is up to 1.7e-3·max|grad| off a float64 run of
# itself even with the BatchNorm shifts beta + 4 that keep pre-activations
# off the kink, and 2.3e-3·max with generic inputs, at whole tile rows.  So
# the kernel is held to rtol 1e-4 against the plain fp32 version where that
# version is accurate (n ≤ 500 off the kink, n = 45), and otherwise to a
# bound that covers the plain version's own error.  Against float64 it is
# held off the kink to |kernel - f64| ≤ 2·|plain fp32 - f64| + 1e-4·max,
# and with generic inputs, where kink flips land on either side, to a
# stated flip-sized bound rtol·max|f64|.
RTOL_BWD_BF16 = (1.5e-2, 1e-4)
GRAD_NAMES = ("da", "db", "dwmid", "dbmid", "dgamma", "dbeta", "dwlast")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median over ``reps`` launches, each between its own CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one launch where a launch is shorter than the host
    code that makes it: the card is kept busy (``torch.cuda._sleep``) while
    the host queues ``reps`` launches, which then run back to back between
    one pair of events.  :func:`median_ms` would read the host's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)      # ≈ 20 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, ref) -> float:
    return float((got - ref).abs().max()) if ref.numel() else 0.0


def check_close(name: str, got, ref, tol, bad: list, scale=None) -> float:
    """max|got - ref|; a message goes to ``bad`` when it exceeds
    rtol·max|scale| + atol (``scale`` defaults to ``ref``)."""
    rtol, atol = tol
    scale = ref if scale is None else scale
    err = max_err(got, ref)
    lim = rtol * float(scale.abs().max()) + atol if ref.numel() else atol
    if not (err <= lim):
        bad.append(f"{name}: max|Δ| {err:.3e} > {lim:.3e}")
    return err


def pge_inputs(n: int, H: int, L2: int, seed: int, beta_shift: float):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    return [r(n, H), r(n, H), r(L2, H, H, scale=H ** -0.5),
            r(L2, H, scale=0.1), 1.0 + r(L2 + 1, H, scale=0.1),
            beta_shift + r(L2 + 1, H, scale=0.1), r(1, H, scale=H ** -0.5)]


def pge_bounds(n: int, H: int, L2: int, bf16: bool) -> dict:
    """Least times of the forward and backward on the card, the larger of
    two: operations of the n² valid pairs' matmuls (forward 2·n²·H²·L2;
    backward twice that, dW and dX) over the peak for the operand type, and
    bytes over HBM bandwidth, each input read once and each output written
    once.  The forward's function is the scores alone: the workspace it
    also writes is a choice of this design, so it is not counted.  The
    backward reads that workspace as an input (the valid pairs' pre-
    BatchNorm activations, n²·H·L2 floats) instead of recomputing it."""
    peak = PEAK_BF16 if bf16 else PEAK_FP32
    flops = {"fwd": 2.0 * n * n * H * H * L2}
    flops["bwd"] = 2 * flops["fwd"]
    params = (L2 * H * H + L2 * H + 2 * (L2 + 1) * H + H) * 4
    ab, scores, ws = 2 * n * H * 4, n * n * 4, n * n * H * L2 * 4
    nbytes = {"fwd": ab + params + scores,
              "bwd": ab + params + scores + ws + ab + params}
    out = {}
    for k in ("fwd", "bwd"):
        t_ops, t_bytes = flops[k] / peak, nbytes[k] / PEAK_BYTES
        out[k] = 1e3 * max(t_ops, t_bytes)
        out[k + "_by"] = "operations" if t_ops > t_bytes else "bytes"
    return out


# ---------------------------------------------------------------------------
# Phases 2-3: kernels against their plain version
# ---------------------------------------------------------------------------

def plain_grads(K, args, R, n: int, bf16: bool, dtype=None) -> list:
    """The seven gradients of sum(plain(args) * R) by autograd."""
    import torch

    leaves = [(a if dtype is None else a.to(dtype)).clone()
              .requires_grad_(True) for a in args]
    with torch.enable_grad():
        s = K.pair_scores_plain(*leaves, n, bf16)
        gs = torch.autograd.grad((s * R.to(s.dtype)).sum(), leaves,
                                 allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


def plain_vjp_ms(K, args, R, n: int, bf16: bool) -> float:
    """Time of the plain version's backward alone (autograd through a
    graph built once), the counterpart of the backward kernel."""
    import torch

    leaves = [a.clone().requires_grad_(True) for a in args]
    with torch.enable_grad():
        loss = (K.pair_scores_plain(*leaves, n, bf16) * R).sum()
        ms = timed_ms(lambda: torch.autograd.grad(
            loss, leaves, retain_graph=True, allow_unused=True), 2)
    del loss
    return ms


# (n, H, L2, BatchNorm beta shift, fp32 backward rtol against the plain
# fp32 version, fp32 rtol against float64: None holds the kernel to twice
# the plain version's distance instead).  Each case's two precisions share
# its inputs.  The first case is the slice's shape and times the kernels;
# at H = 320 a backward block holds one pair of operand tiles, not two.
KERNEL_CASES = [(1354, 256, 1, 0.0, 1e-2, 1e-2),
                (1354, 256, 1, 4.0, 5e-3, None),
                (500, 256, 1, 4.0, 1e-4, None),
                (500, 256, 1, 0.0, 1e-2, 1e-2),
                (200, 256, 2, 4.0, 1e-4, None),
                (150, 320, 1, 4.0, 1e-4, None),
                (45, 64, 0, 0.0, 1e-4, None)]


def f64_distances(grads, gref, g64, rtol64, bad: list, tag: str,
                  rows: bool) -> dict:
    """Each gradient's distance to float64, the kernel's beside the plain
    version's, held to the bound ``rtol64`` names (see RTOL_BWD_BF16), and
    with ``rows`` the rows of da that are off float64 by more than
    1e-3·max for each (a ReLU flip moves a few rows, a wrong formula all
    of them)."""
    out = {}
    for i, name in enumerate(GRAD_NAMES):
        if not g64[i].numel():
            continue
        # dbmid is analytically 0: its scale is that of dbeta
        top = float((g64[5] if name == "dbmid" else g64[i]).abs().max())
        e_k = max_err(grads[i].double(), g64[i])
        e_p = max_err(gref[i].double(), g64[i])
        lim = (2 * e_p + 1e-4 * top if rtol64 is None
               else rtol64 * top + 1e-5)
        if not e_k <= lim:
            bad.append(f"bwd {name} {tag}: |kernel - f64| {e_k:.3e} > "
                       f"{lim:.3e}")
        out[name] = (e_k, e_p)
    if not rows:
        return out
    big = 1e-3 * float(g64[0].abs().max())
    out["da rows off (kernel/plain)"] = tuple(
        int(((x.double() - g64[0]).abs() > big).any(1).sum())
        for x in (grads[0], gref[0]))
    return out


def compare_kernels(K, stats: dict) -> None:
    import torch

    bad: list = []
    for case in KERNEL_CASES:
        n, H, L2, shift, rtol32, rtol64 = case
        main_shape = case == KERNEL_CASES[0]
        args = pge_inputs(n, H, L2, seed=n + L2, beta_shift=shift)
        R = torch.randn(n, n, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
        # the exact function's gradient: fp32 operands, float64 arithmetic
        g64 = plain_grads(K, args, R, n, False, torch.float64)
        for bf16 in (False, True):
            tol_bwd = RTOL_BWD_BF16 if bf16 else (rtol32, 1e-5)
            tag = f"n={n} H={H} L2={L2} beta+{shift:g} bf16={bf16}"
            out, ws, stat = K.pge_fwd(*args, n, bf16)
            torch.cuda.synchronize()
            with torch.no_grad():
                ref = K.pair_scores_plain(*args, n, bf16)
            e_f = check_close(f"fwd {tag}", out, ref, TOL_FWD[bf16], bad)
            grads = K.pge_bwd(*args, R, ws, stat, n, bf16)
            torch.cuda.synchronize()
            gref = plain_grads(K, args, R, n, bf16)
            e64 = f64_distances(grads, gref, g64, None if bf16 else rtol64,
                                bad, tag, rows=not bf16)
            errs, rel = {}, {}
            for name, got, want in zip(GRAD_NAMES, grads, gref):
                # dbmid is analytically 0 (BatchNorm shift invariance):
                # its scale is that of dbeta, the same kind of sum
                scale = gref[5] if name == "dbmid" else want
                off: list = []
                errs[name] = check_close(f"bwd {name} {tag}", got, want,
                                         tol_bwd, off, scale)
                if off and bf16 and name in ("dgamma", "dbeta") and \
                        e64[name][0] <= e64[name][1]:
                    off = []       # a cancelling sum, kernel nearer f64
                bad += off
                if scale.numel():
                    rel[name] = errs[name] / max(
                        float(scale.abs().max()), 1e-30)
            e_b = max(errs.values())
            worst = max(rel, key=rel.get)
            line = (f"pge {tag}: fwd max|Δ| {e_f:.2e}; bwd max|Δ| "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + f" (largest / max|ref|: {rel[worst]:.2e}, {worst})"
                    + "; |kernel - f64| / |plain - f64|: "
                    + ", ".join(f"{k} {a:.3g}/{b:.3g}"
                                for k, (a, b) in e64.items()))
            if main_shape:
                b = pge_bounds(n, H, L2, bf16)
                fwd_ms = timed_ms(lambda: K.pge_fwd(*args, n, bf16), 10)
                bwd_ms = timed_ms(
                    lambda: K.pge_bwd(*args, R, ws, stat, n, bf16), 5)
                with torch.no_grad():
                    plain_fwd = timed_ms(
                        lambda: K.pair_scores_plain(*args, n, bf16), 3)
                plain_bwd = plain_vjp_ms(K, args, R, n, bf16)
                lib = K.build()
                line += (f"; fwd {fwd_ms:.3f} ms (plain {plain_fwd:.3f}, "
                         f"bound {b['fwd']:.3f} by {b['fwd_by']}); bwd "
                         f"{bwd_ms:.3f} ms (plain vjp {plain_bwd:.3f}, "
                         f"bound {b['bwd']:.3f} by {b['bwd_by']}; "
                         f"{K.LAST_BWD['scratch_bytes']} bytes of "
                         f"device-memory scratch a launch, "
                         f"{K.LAST_BWD['grid']} blocks of "
                         f"{lib.pge_bwd_smem_bytes(H, int(bf16))} bytes of "
                         f"shared memory, "
                         f"{K.blocks_per_sm(lib, True, bf16, H)} an SM)")
                if bf16:   # the main path's precision
                    stats["pge_fwd"] = dict(
                        max_abs_err=e_f, ms=fwd_ms, plain_ms=plain_fwd,
                        bound_ms=b["fwd"], bound_by=b["fwd_by"])
                    stats["pge_bwd"] = dict(
                        max_abs_err=e_b, ms=bwd_ms, plain_ms=plain_bwd,
                        bound_ms=b["bwd"], bound_by=b["bwd_by"])
            log(line)
            del grads, gref, out, ref, ws, stat
            torch.cuda.empty_cache()
        del g64
    if bad:
        fail("kernels disagree with their plain version:\n  "
             + "\n  ".join(bad))


# ---------------------------------------------------------------------------
# Phase 4: GCond on the arxiv twin
# ---------------------------------------------------------------------------

class Counter:
    """Wraps a bound method of one engine and counts its calls."""

    def __init__(self, obj, name: str):
        self.n = 0
        self.fn = getattr(obj, name)
        setattr(obj, name, self)

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


def device_time_by_kernel(prof) -> dict:
    """Device milliseconds per kernel name from a torch.profiler run."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def run_gcond(K, ds, save_path: str) -> tuple:
    """GCond through create_reducer(...).reduce(): epoch 0 warms up,
    epoch 1 is timed (then the checkpoint evaluation), epoch 2 runs under
    torch.profiler for the device-time breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.reduce import create_reducer

    args = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                         init="random", epochs=3, save_path=save_path,
                         run_inter_eval=1, device="cuda"),
                    explicit={"epochs", "run_inter_eval"})
    args = args.replace(checkpoints=(1,))
    eng = create_reducer("gcond", ds, args)
    if (eng.n_syn, args.hidden, eng.pge.cfg.nhid) != (1354, 256, 256):
        fail(f"not the full width: n_syn {eng.n_syn}, hidden "
             f"{args.hidden}, PGE nhid {eng.pge.cfg.nhid}")
    steps = Counter(eng, "match_loss_total")
    inference = Counter(eng, "inference_adj")
    inner = Counter(eng, "inner_adj")
    epoch_s = []
    profiled = {}
    epoch_fn = eng._epoch

    def timed_epoch(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(epoch_s) < 2:
            out = epoch_fn(*a, **kw)
            torch.cuda.synchronize()
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = epoch_fn(*a, **kw)
                torch.cuda.synchronize()
            profiled["kernels"] = device_time_by_kernel(prof)
        epoch_s.append(time.perf_counter() - t0)
        if len(epoch_s) == 3:
            profiled["wall_ms"] = epoch_s[-1] * 1e3
        return out

    eng._epoch = timed_epoch
    K.reset_launches()
    t0 = time.perf_counter()
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    denom = eng.nclass * args.outer_loop
    losses = [float(x) / denom for x in eng.epoch_loss_sums]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite epoch loss {losses}")
    outer = steps.n
    if outer != args.epochs * args.outer_loop or inner.n != outer:
        fail(f"outer steps {outer}, inner_adj calls {inner.n}")
    extra = inference.n - inner.n   # checkpoint + final inference_adj
    if launches["pge_bwd"] != outer:
        fail(f"pge_bwd launches {launches['pge_bwd']} != {outer}")
    if launches["pge_fwd"] != 2 * outer + extra:
        fail(f"pge_fwd launches {launches['pge_fwd']} != 2·{outer} + "
             f"{extra}")
    feat = red.feat
    if feat.shape != (1354, 128) or not torch.isfinite(feat).all() or \
            not torch.isfinite(red.adj).all():
        fail("condensed graph not finite or of the wrong shape")
    sps = args.outer_loop / epoch_s[1]
    log(f"gcond ogbn-arxiv: n_syn {eng.n_syn}, {outer} outer steps, "
        f"{sps:.3f} outer steps/s (timed epoch 1; epochs "
        f"{[round(s, 3) for s in epoch_s]} s, reduce() {wall:.1f} s), "
        f"epoch losses {[round(x, 5) for x in losses]}, launches "
        f"{launches} (fwd = 2·{outer} + {extra} inference_adj)")
    kern = profiled["kernels"]
    busy = sum(kern.values())
    if not busy > 0:
        fail("torch.profiler recorded no device time")
    pge = {name: sum(v for k, v in kern.items() if f"pge::{name}_kernel" in k)
           for name in ("pge_fwd", "pge_bwd")}
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
    # the profiler's own host overhead stretches the profiled epoch's wall
    # time, so the idle share is an estimate across two epochs of the same
    # work: device busy of the profiled epoch 2 over the wall time of the
    # unprofiled epoch 1
    log(f"gcond profile (epoch 2, {args.outer_loop} outer steps, "
        f"torch.profiler): wall {profiled['wall_ms']:.1f} ms under the "
        f"profiler, device busy {busy:.1f} ms (idle share estimated as "
        f"1 - busy(epoch 2) / wall(unprofiled epoch 1): "
        f"{1 - busy / (epoch_s[1] * 1e3):.3f}); "
        f"pge_fwd {pge['pge_fwd']:.1f} ms, pge_bwd {pge['pge_bwd']:.1f} ms "
        f"({(pge['pge_fwd'] + pge['pge_bwd']) / busy:.3f} of busy); top: "
        + "; ".join(f"{k[:48]} {v:.1f} ms" for k, v in top))
    return red, launches


# ---------------------------------------------------------------------------
# Phase 6: the shared-memory row gather
# ---------------------------------------------------------------------------

# SpMM tolerance, max|Δ| ≤ rtol·max|ref| + atol: the kernel and the plain
# version sum the same float32 products in another order.
TOL_SPMM = (1e-5, 1e-6)
PROBE_SHAPE = (4096, 128, 32768)     # source rows, width, gathered rows
PROBE_TS = (64, 128, 256, 448)       # source tiles the SpMM considers


def gather_bound_ms(n_src: int, d: int, n_idx: int, idx_bytes: int) -> float:
    """Bytes over HBM bandwidth: the gathered rows written once, the
    indices read once, and the rows of x that the indices can name read
    once (at most all of x)."""
    nbytes = n_idx * d * 4 + n_idx * idx_bytes + min(n_idx, n_src) * d * 4
    return 1e3 * nbytes / PEAK_BYTES


def probe_gather(SG, stats: dict, ds) -> None:
    import numpy as np
    import torch

    from graphslim_tpu_torch.reduce.base import class_budgets

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_src, d, n_idx = PROBE_SHAPE
    x = torch.randn(n_src, d, generator=gen, device="cuda")
    idx = torch.randint(0, n_src, (n_idx,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx64 = idx.long()
    ref = SG.gather_rows_plain(x, idx64)
    lib_ms = queued_ms(lambda: torch.index_select(x, 0, idx64))
    bound = gather_bound_ms(n_src, d, n_idx, 4)
    gbytes = bound * 1e-3 * PEAK_BYTES / 1e9

    def rate(ms):
        return f"{ms:.4f} ms = {n_idx / ms / 1e3:.1f} Mrows/s = " \
               f"{gbytes / ms * 1e3:.0f} GB/s"

    parts = []
    for ts in PROBE_TS + (None,):
        kw = dict(staged=ts is not None, ts=ts)
        out = SG.gather_rows_cuda(x, idx, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"gather {kw} differs from index_select")
        ms = queued_ms(lambda: SG.gather_rows_cuda(x, idx, **kw))
        parts.append((f"staged ts={ts} " if ts else "direct ") + rate(ms))
    log(f"gather probe x [{n_src}, {d}] f32, idx [{n_idx}] (source warm in "
        f"L2; device time of launches queued back to back), exact; bound "
        f"{bound:.4f} ms; index_select {rate(lib_ms)}; "
        + "; ".join(parts))

    # The calls a coreset run makes (reduce/coreset.py): every class's pool
    # of training nodes out of the embeddings (KCenter: the full-graph
    # GCN's logits, [n, nclass]; the agg variants: Â²X, [n, n_feat]), then
    # the selected rows out of the features.  The pools are the twin's own;
    # the selection here is each pool's first rows at the reducers' budgets.
    labels = ds.labels.cpu().numpy()[ds.idx_train]
    budgets, _, _ = class_budgets(labels, 0.01)
    pools = [np.asarray(ds.idx_train)[labels == c] for c in budgets]
    picked = np.concatenate([p[:min(int(k), len(p))]
                             for p, k in zip(pools, budgets.values())])
    largest = max(pools, key=len)
    logits = torch.randn(ds.n_nodes, ds.nclass, generator=gen, device="cuda")
    calls = [(f"class pool of {ds.nclass}-wide logits", logits, p)
             for p in pools]
    calls += [(f"class pool of {ds.n_feat}-wide features", ds.feat, p)
              for p in pools]
    calls.append(("selected rows of the features", ds.feat, picked))
    for what, src, rows in calls:
        rows = torch.as_tensor(rows, device="cuda")
        out = SG.gather_rows(src, rows)
        torch.cuda.synchronize()
        if not torch.equal(out, SG.gather_rows_plain(src, rows)) or \
                not torch.equal(out, SG.gather_rows(src, rows)):
            fail(f"gather of a {what} ({rows.shape[0]} rows) differs from "
                 f"index_select")
    parts = []
    for what, src, rows in ((calls[0][0], logits, largest),
                            (calls[-2][0], ds.feat, largest),
                            calls[-1]):
        rows = torch.as_tensor(rows, device="cuda")
        ms = queued_ms(lambda: SG.gather_rows(src, rows))
        lib_ms = queued_ms(lambda: torch.index_select(src, 0, rows))
        host = median_ms(lambda: SG.gather_rows(src, rows))
        host_lib = median_ms(lambda: torch.index_select(src, 0, rows))
        bound = gather_bound_ms(src.shape[0], src.shape[1], rows.shape[0],
                                rows.element_size())
        parts.append(f"{what}, x {list(src.shape)}, idx [{rows.shape[0]}]: "
                     f"{ms:.4f} ms (index_select {lib_ms:.4f} ms, bound "
                     f"{bound:.5f} ms by bytes; with the host's share of "
                     f"one call {host:.4f} against {host_lib:.4f} ms)")
        if src is logits:      # KCenter's shape goes into the kernels line
            stats["smem_gather"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=lib_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms)
    # a width that is no multiple of 4 (4-byte pieces): the evaluator's
    # hoisted [X | 1] is 129 wide
    wide = torch.randn(ds.n_nodes, 129, generator=gen, device="cuda")
    rows = torch.as_tensor(largest, device="cuda")
    for r in (rows, rows.to(torch.int32)):
        out = SG.gather_rows(wide, r)
        torch.cuda.synchronize()
        if not torch.equal(out, SG.gather_rows_plain(wide, rows)) or \
                not torch.equal(out, SG.gather_rows(wide, r)):
            fail(f"gather at d = 129 ({r.dtype}) differs from index_select")
    ms = queued_ms(lambda: SG.gather_rows(wide, rows))
    lib_ms = queued_ms(lambda: torch.index_select(wide, 0, rows))
    bound = gather_bound_ms(wide.shape[0], 129, rows.shape[0], 8)
    parts.append(f"largest pool out of a 129-wide matrix (4-byte pieces), "
                 f"idx [{rows.shape[0]}] int64 and int32 exact: {ms:.4f} ms "
                 f"(index_select {lib_ms:.4f} ms, bound {bound:.5f} ms by "
                 f"bytes)")
    del wide
    log(f"gather at the coreset path's shapes ({len(calls)} calls: "
        f"{len(pools)} class pools of {min(map(len, pools))} to "
        f"{len(largest)} rows at each width, {picked.shape[0]} selected "
        f"rows), direct, all exact; device time of launches queued back "
        f"to back, largest pool and selection: "
        + "; ".join(parts))


# ---------------------------------------------------------------------------
# Phase 7: the blocked SpMM
# ---------------------------------------------------------------------------

def spmm_bound_ms(nnz: int, n_rows: int, n_cols: int, d: int) -> float:
    """Bytes over HBM bandwidth: stored entries × (index + value), one
    read of x, one write of out."""
    return 1e3 * (nnz * 8 + (n_rows + n_cols) * d * 4) / PEAK_BYTES


def check_spmm(SB, tag: str, adj, layout, x, bad: list, f64=None) -> float:
    """Kernel against the plain version over the same layout and against
    a float64 product, and twice for bit-equality → max|kernel - plain|."""
    import torch

    from graphslim_tpu_torch.kernels.spmm import spmm_plain

    out = SB.spmm_blocked(layout, x)
    torch.cuda.synchronize()
    ref = SB.spmm_blocked_plain(layout, x)
    if f64 is None:
        f64 = spmm_plain(adj.row, adj.col, adj.values_or_ones().double(),
                         x.double(), adj.n_rows)
    err = check_close(f"spmm {tag} vs plain", out, ref, TOL_SPMM, bad, f64)
    check_close(f"spmm {tag} vs float64", out.double(), f64, TOL_SPMM, bad)
    check_close(f"spmm plain {tag} vs float64", ref.double(), f64, TOL_SPMM,
                bad)
    if not torch.equal(out, SB.spmm_blocked(layout, x)):
        bad.append(f"spmm {tag}: two runs differ")
    return err


def ragged_graph(G, n: int, e: int, seed: int):
    """Random weighted digraph with rows n//3..n//2 empty and one row that
    points at every column (heavier than any tile)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = (row < n // 3) | (row >= n // 2)
    row = np.concatenate([row[keep], np.full(n, n - 1)])
    col = np.concatenate([col[keep], np.arange(n)])
    w = rng.normal(size=row.shape[0]).astype(np.float32)
    return G.from_edge_index(np.stack([row, col]), n, edge_weight=w,
                             device="cuda")


def compare_spmm_small(SB, G) -> None:
    import numpy as np
    import torch

    bad: list = []
    # (a) the shape of the JAX package's own test of its kernel
    rng = np.random.default_rng(3)
    n, e, d = 500, 3000, 16
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    adj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                       device="cuda"))
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                        device="cuda")
    layout = adj.blocked(td=128, ts=128, chunk=256, stage_min=128)
    err = check_spmm(SB, "(a) n=500 d=16 td=ts=128", adj, layout, x, bad)
    log(f"spmm (a) n={n} d={d} {layout.describe()}: max|Δ| {err:.2e}")
    # (c) ragged: empty rows, a row heavier than a tile, staged and direct
    # blocks mixed, runs cut into pieces
    n, d = 3000, 40
    adj = ragged_graph(G, n, 40000, 11)
    x = torch.randn(n, d, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    for sizes in (dict(stage_min=64),
                  dict(td=32, ts=448, chunk=50, stage_min=8),
                  dict(td=128, ts=256, chunk=4096, stage_min=10 ** 9)):
        layout = adj.blocked(**sizes)
        err = check_spmm(SB, f"(c) ragged {sizes}", adj, layout, x, bad)
        out = SB.spmm_blocked(layout, x)
        if not (out[n // 3: n // 2] == 0).all():
            bad.append(f"spmm (c) {sizes}: empty rows are not zero")
        log(f"spmm (c) ragged n={n} d={d} nnz={adj.nnz} "
            f"{layout.describe()}: max|Δ| {err:.2e}")
    if bad:
        fail("blocked SpMM disagrees:\n  " + "\n  ".join(bad))


def compare_spmm_arxiv(SB, ds, stats: dict) -> None:
    """(b): the arxiv twin's normalized adjacency, forward and backward at
    the widths the coreset path uses."""
    import torch

    adj = ds.adj_norm()
    layout = adj.blocked()
    layout_t = adj.blocked(transpose=True)
    n, nnz = adj.n_rows, adj.nnz
    log(f"spmm (b) arxiv twin: {n} rows, {nnz} stored entries "
        f"({nnz / n:.2f} a row); layout {layout.describe()}; transposed "
        f"layout {'shared (symmetric)' if layout_t is layout else 'built'}")
    csr = adj.to_csr()
    bad: list = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    # features, hidden, classes, and [X | 1] of the evaluator's hoist (not
    # a multiple of 4: the kernel's scalar branch, two column slabs)
    for d in (128, 256, 40, 129):
        x = torch.randn(n, d, generator=gen, device="cuda")
        g = torch.randn(n, d, generator=gen, device="cuda")
        err = check_spmm(SB, f"(b) arxiv d={d} fwd", adj, layout, x, bad)
        # backward through the autograd Function: A^T g on the transposed
        # layout, against the plain version and a float64 A^T g
        leaf = x.clone().requires_grad_(True)
        with torch.enable_grad():
            (gx,) = torch.autograd.grad(adj.matmul(leaf), leaf, g)
        g64 = adj.rmatmul(g.double(), n)
        ref_t = SB.spmm_blocked_plain(layout_t, g)
        err_b = check_close(f"spmm (b) arxiv d={d} bwd vs plain", gx, ref_t,
                            TOL_SPMM, bad, g64)
        check_close(f"spmm (b) arxiv d={d} bwd vs float64", gx.double(),
                    g64, TOL_SPMM, bad)
        ms = median_ms(lambda: SB.spmm_blocked(layout, x))
        ms_b = median_ms(lambda: SB.spmm_blocked(layout_t, g))
        plain = median_ms(lambda: SB.spmm_blocked_plain(layout, x), 5, 1)
        lib = median_ms(lambda: torch.sparse.mm(csr, x))
        bound = spmm_bound_ms(nnz, n, n, d)
        moved = (nnz * (8 + d * 4) + layout.bounds.numel() * 4
                 + n * d * 4) / 1e9
        log(f"spmm (b) arxiv d={d}: fwd max|Δ| {err:.2e}, bwd max|Δ| "
            f"{err_b:.2e}; kernel {ms:.4f} ms (transposed layout "
            f"{ms_b:.4f} ms; plain {plain:.3f} ms; torch.sparse.mm "
            f"{lib:.4f} ms; bound {bound:.4f} ms by bytes); the kernel "
            f"requests {moved:.3f} GB (every entry's row of x, through "
            f"L2), {moved / ms * 1e3:.0f} GB/s")
        stats[f"spmm_blocked_d{d}"] = dict(
            max_abs_err=max(err, err_b), ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by="bytes", library_ms=lib)
        del x, g, leaf, gx, g64, ref_t
        torch.cuda.empty_cache()
    if bad:
        fail("blocked SpMM disagrees on the arxiv twin:\n  "
             + "\n  ".join(bad))


def compare_spmm_subgraphs(SB, G, subgraphs: dict) -> None:
    """The other shape the coreset path gives the kernel: the normalized
    adjacency of the selected nodes' subgraph, on which a GCN evaluation
    trains (a hoisted first aggregation of [X | 1], then one forward and
    one backward launch an epoch at the class count).  Runs after phase 8,
    on the subgraphs it selected."""
    import torch

    bad: list = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for method, raw in subgraphs.items():
        adj = G.gcn_norm(raw)
        layout = adj.blocked()
        wide = adj.blocked(td=64)     # the tile a large matrix gets
        csr = adj.to_csr()
        n, nnz = adj.n_rows, adj.nnz
        heaviest = int(torch.diff(adj.indptr).max())
        parts = []
        for d in (128, 256, 40, 129):
            x = torch.randn(n, d, generator=gen, device="cuda")
            tag = f"{method} subgraph n={n} d={d}"
            err = check_spmm(SB, tag, adj, layout, x, bad)
            check_spmm(SB, tag + " td=64", adj, wide, x, bad)
            ms = queued_ms(lambda: SB.spmm_blocked(layout, x))
            ms64 = queued_ms(lambda: SB.spmm_blocked(wide, x))
            plain = queued_ms(lambda: SB.spmm_blocked_plain(layout, x))
            lib = queued_ms(lambda: torch.sparse.mm(csr, x))
            parts.append(
                f"d={d}: max|Δ| {err:.2e}, kernel {ms:.4f} ms (td=64 "
                f"{ms64:.4f} ms; plain {plain:.4f} ms; torch.sparse.mm "
                f"{lib:.4f} ms; bound {spmm_bound_ms(nnz, n, n, d):.5f} ms "
                f"by bytes)")
        log(f"spmm on the {method} subgraph: {n} rows, {nnz} stored "
            f"entries, heaviest row {heaviest}; layout {layout.describe()} "
            f"({-(-n // layout.td)} destination tiles); device time of "
            f"launches queued back to back; "
            + "; ".join(parts))
    if bad:
        fail("blocked SpMM disagrees on a selected subgraph:\n  "
             + "\n  ".join(bad))


# ---------------------------------------------------------------------------
# Phase 8: the coreset path
# ---------------------------------------------------------------------------

def run_coresets(SB, SG, G) -> tuple:
    """kcenter / herding+agg / cent_p through train_all.run at full width;
    returns the kernels' launch counts over the three runs and the selected
    subgraphs that the GCN evaluations trained on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphslim_tpu_torch import models as M
    from graphslim_tpu_torch import train_all as TA
    from graphslim_tpu_torch import utils
    from graphslim_tpu_torch.config import Args, finalize

    seen: dict = {}
    create, evaluator = TA.create_reducer, TA.Evaluator

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            before = SB.LAUNCHES["spmm_blocked"]
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seen[key] = (time.perf_counter() - t0,
                         SB.LAUNCHES["spmm_blocked"] - before)
            seen[key + " result"] = out
            return out
        return wrapper

    def create_timed(method, data, args, **kw):
        agent = create(method, data, args, **kw)
        agent.reduce = timed(agent.reduce, "reduce")
        seen["agent"], seen["data"] = agent, data
        return agent

    class TimedEvaluator(evaluator):
        def evaluate(self, *a, **kw):
            # the full graph's normalization and layout, where the reducer
            # did not need them, would otherwise count as evaluation
            t0 = time.perf_counter()
            self.data.adj_norm().blocked()
            torch.cuda.synchronize()
            seen["setup"] = time.perf_counter() - t0
            return timed(super().evaluate, "evaluate")(*a, **kw)

    TA.create_reducer, TA.Evaluator = create_timed, TimedEvaluator
    SB.reset_launches()
    SG.reset_launches()
    kcenter, subgraphs = None, {}
    with tempfile.TemporaryDirectory() as tmp:
        for method, agg, model in (("kcenter", False, "GCN"),
                                   ("herding", True, "SGC"),
                                   ("cent_p", False, "GCN")):
            args = finalize(Args(
                dataset="ogbn-arxiv", method=method, agg=agg,
                reduction_rate=0.01, hidden=256, eval_epochs=300,
                run_eval=3, eval_model=model, save_path=tmp,
                device="cuda"), explicit={"run_eval", "eval_epochs"})
            before = dict(SB.LAUNCHES, **SG.LAUNCHES)
            mean, std = TA.run(args)
            agent = seen["agent"]
            n_sel = int(agent.labels_syn.shape[0])
            if not (math.isfinite(mean) and math.isfinite(std)):
                fail(f"{method}: accuracy {mean} ± {std}")
            # per-class budgets max(int(n_c * r), 1) of the 90,941 train
            # nodes: 1336 without GCond's remainder absorption
            if (n_sel, args.hidden, args.eval_epochs) != (1336, 256, 300):
                fail(f"{method}: not the full width ({n_sel} nodes, hidden "
                     f"{args.hidden}, {args.eval_epochs} epochs)")
            la = SB.LAUNCHES["spmm_blocked"] - before["spmm_blocked"]
            lb = SG.LAUNCHES["smem_gather"] - before["smem_gather"]
            if la <= 0 or lb <= 0:
                fail(f"{method}: spmm_blocked launched {la} times, "
                     f"smem_gather {lb} times")
            log(f"coreset {method}{'+agg' if agg else ''} / {model} on "
                f"ogbn-arxiv r=0.01: {n_sel} nodes, reduce "
                f"{seen['reduce'][0]:.2f} s ({seen['reduce'][1]} SpMM "
                f"launches), full-graph normalization and layout left to "
                f"the evaluator {seen['setup']:.2f} s, evaluate 3 seeds x "
                f"300 epochs {seen['evaluate'][0]:.2f} s "
                f"({seen['evaluate'][1]} SpMM "
                f"launches), gather launches {lb}, accuracy {mean:.4f} ± "
                f"{std:.4f}")
            if method == "kcenter":
                kcenter = (agent, seen["data"], args, seen["reduce"][1])
            if model == "GCN":    # trained on the selected nodes' subgraph
                subgraphs[method] = seen["reduce result"].adj
    launches = dict(SB.LAUNCHES, **SG.LAUNCHES)
    TA.create_reducer, TA.Evaluator = create, evaluator

    # the full-graph GCN that KCenter trained
    agent, ds, args, reduce_launches = kcenter
    model, params, norm, best_val = agent.embed_model
    if reduce_launches != 6 * args.eval_epochs + 2:
        fail(f"kcenter reduce launched the SpMM {reduce_launches} times, "
             f"expected 6 an epoch (forward 2, backward 2, validation 2) "
             f"+ 2 for the embeddings")
    best_val = float(best_val)
    if not best_val >= 0.60:
        fail(f"KCenter's full-graph GCN validates at {best_val:.4f} < 0.60")

    class PlainAdj(G.SparseAdj):
        def matmul(self, x):
            return SB.spmm_blocked_plain(self.blocked(), x)

    plain_adj = PlainAdj(norm.indptr, norm.row, norm.col, norm.val,
                         norm._layouts)
    with torch.no_grad():
        logits = model.apply(params, ds.feat, norm)
        logits_plain = model.apply(params, ds.feat, plain_adj)
    gap = max_err(logits, logits_plain)
    top = float(logits_plain.abs().max())
    if not gap <= 1e-4 * top:
        fail(f"GCN logits through the kernel and through its plain version "
             f"differ by {gap:.3e} > 1e-4 x {top:.3e}")

    # one training epoch of that GCN under the profiler
    idx = torch.as_tensor(ds.idx_train, device="cuda")
    vidx = torch.as_tensor(ds.idx_val, device="cuda")
    batches = dict(train=(ds.feat, norm, ds.labels[idx], idx),
                   val=(ds.feat, norm, ds.labels[vidx], vidx))

    def fit(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.fit_with_val(model, utils.make_generator(0, "cuda"), **batches,
                       cfg=M.TrainConfig(epochs=epochs, lr=0.01))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fit(2)
    epoch_ms = (fit(12) - fit(2)) / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit(1)
    kern = device_time_by_kernel(prof)
    busy = sum(kern.values())
    if not busy > 0:
        fail("torch.profiler recorded no device time")
    spmm_ms = sum(v for k, v in kern.items() if "spmm_blocked_kernel" in k)
    top4 = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
    log(f"kcenter full-graph GCN: best validation {best_val:.4f}; logits "
        f"kernel vs plain max|Δ| {gap:.2e} (max|logit| {top:.2f}); one "
        f"training epoch (6 SpMM launches) {epoch_ms:.2f} ms unprofiled "
        f"(difference of a 12- and a 2-epoch fit); profiled epoch: device "
        f"busy {busy:.2f} ms, blocked SpMM {spmm_ms:.2f} ms "
        f"({spmm_ms / busy:.3f} of busy), idle share estimated as 1 - "
        f"busy / unprofiled epoch: {1 - busy / epoch_ms:.3f}; top: "
        + "; ".join(f"{k[:48]} {v:.2f} ms" for k, v in top4))
    return launches, subgraphs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels"], default=None)
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "graphslim_tpu_torch")):
        fail("graphslim_tpu_torch/ not found beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    os.environ.setdefault("GRAPHSLIM_TORCH_CACHE",
                          os.path.join(HERE, "build", "cache"))
    from graphslim_tpu_torch import graph as G
    from graphslim_tpu_torch.kernels import build as B
    from graphslim_tpu_torch.kernels import pge as K
    from graphslim_tpu_torch.kernels import smem_gather as SG
    from graphslim_tpu_torch.kernels import spmm_blocked as SB

    # --- phase 1 ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    B.prebuild()
    build_s = time.perf_counter() - t0
    for mod in (K, SB, SG):
        mod.build()
        report = [ln.strip() for ln in mod.BUILD_INFO["report"].splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"build: {mod.BUILD_INFO['seconds']:.1f} s nvcc -> "
            f"{os.path.relpath(mod.BUILD_INFO['path'], HERE)}; ptxas: "
            + " | ".join(report))
    log(f"build: {len(B.LIBRARIES)} libraries in parallel, {build_s:.1f} s")

    # --- phases 2-3 ------------------------------------------------------
    stats: dict = {}
    compare_kernels(K, stats)

    # --- phases 6-7 ------------------------------------------------------
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load, read_npz
    from graphslim_tpu_torch.eval import Evaluator

    t0 = time.perf_counter()
    ds = load("ogbn-arxiv", seed=0, device="cuda")
    log(f"load ogbn-arxiv twin: {ds.n_nodes} nodes, {ds.adj.nnz} edges, "
        f"{time.perf_counter() - t0:.1f} s")
    probe_gather(SG, stats, ds)
    compare_spmm_small(SB, G)
    compare_spmm_arxiv(SB, ds, stats)
    if opts.only == "kernels":
        return

    # --- phase 4 ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        red, launches = run_gcond(K, ds, tmp)
        saved = os.path.join(tmp, "reduced_graph", "gcond",
                             "ogbn-arxiv_0.01_1.npz")
        if not os.path.exists(saved):
            fail("the checkpoint did not save_reduced")

    # --- phase 5 ---------------------------------------------------------
    eargs = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                          run_eval=3, eval_epochs=300, device="cuda"),
                     explicit={"run_eval", "eval_epochs"})
    art = read_npz(os.path.join(HERE, "benchmark", "artifacts",
                                "arxiv_gcond_r0.01.npz"), device="cuda")
    ev = Evaluator(ds, eargs)
    t0 = time.perf_counter()
    (acc, std), _ = ev.evaluate(art, "SGC")
    t_eval = time.perf_counter() - t0
    if not acc >= 0.80:
        fail(f"artifact SGC accuracy {acc:.4f} < 0.80")
    (acc_new, std_new), _ = ev.evaluate(red, "SGC")
    if not math.isfinite(acc_new):
        fail(f"condensed-graph accuracy {acc_new}")
    log(f"eval SGC 3 seeds x 300 epochs: artifact {acc:.4f} ± {std:.4f} "
        f"({t_eval:.1f} s; JAX package 0.8142 ± 0.0001), fresh 3-epoch "
        f"GCond graph {acc_new:.4f} ± {std_new:.4f}")

    # --- phase 8 ---------------------------------------------------------
    del ev, art, red
    torch.cuda.empty_cache()
    core, subgraphs = run_coresets(SB, SG, G)
    compare_spmm_subgraphs(SB, G, subgraphs)

    src = "graphslim_tpu_torch/csrc/"
    kernels = [
        dict(name="pge_fwd", route="cuda", source=src + "pge_kernels.cuh",
             replaces="graphslim_tpu/kernels/pallas_pge.py:74",
             launches=launches["pge_fwd"], library_ms=None,
             **stats["pge_fwd"]),
        dict(name="pge_bwd", route="cuda", source=src + "pge_kernels.cuh",
             replaces="graphslim_tpu/kernels/pallas_pge.py:165",
             launches=launches["pge_bwd"], library_ms=None,
             **stats["pge_bwd"]),
        # timed at the hidden width, where the coreset path spends most
        dict(name="spmm_blocked", route="cuda",
             source=src + "spmm_blocked.cu",
             replaces="graphslim_tpu/kernels/pallas_spmm_blocked.py:198",
             launches=core["spmm_blocked"], **stats["spmm_blocked_d256"]),
        dict(name="smem_gather", route="cuda",
             source=src + "smem_gather.cu",
             replaces="benchmark/probe_spmm.py:82",
             launches=core["smem_gather"], **stats["smem_gather"]),
    ]
    for k in kernels:
        if not k["launches"] > 0:
            fail(f"kernel {k['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
