#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``graphslim_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
line of output each, any failed check raises (non-zero exit):

1. the card's name and power limit; build of the PGE kernels (nvcc);
2. the PGE forward kernel against its plain version on the card, at the
   slice's shapes (n = 1354, H = 256, L2 = 1) and smaller ragged ones,
   in fp32 and with bf16 matmul operands;
3. the PGE backward kernel against autograd of the plain version, on all
   seven gradients, and in both precisions against a float64 plain
   version;
4. GCond on the full-width ``ogbn-arxiv`` twin (n_syn 1354, hidden 256,
   PGE nhid 256, 3 epochs × 20 outer steps, a checkpoint evaluation) through
   ``create_reducer(...).reduce()``, with the kernels' launch counts and a
   torch.profiler breakdown of one epoch;
5. SGC evaluation of ``benchmark/artifacts/arxiv_gcond_r0.01.npz``
   (3 seeds × 300 epochs, accuracy ≥ 0.80) and of the graph from phase 4.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  ``--only kernels`` stops after
phase 3.  Without a CUDA card, or outside a checkout, it exits non-zero
and prints no result.
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
# its inputs.  The first case is the slice's shape and times the kernels.
KERNEL_CASES = [(1354, 256, 1, 0.0, 1e-2, 1e-2),
                (1354, 256, 1, 4.0, 5e-3, None),
                (500, 256, 1, 4.0, 1e-4, None),
                (500, 256, 1, 0.0, 1e-2, 1e-2),
                (200, 256, 2, 4.0, 1e-4, None),
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
                line += (f"; fwd {fwd_ms:.3f} ms (plain {plain_fwd:.3f}, "
                         f"bound {b['fwd']:.3f} by {b['fwd_by']}); bwd "
                         f"{bwd_ms:.3f} ms (plain vjp {plain_bwd:.3f}, "
                         f"bound {b['bwd']:.3f} by {b['bwd_by']})")
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
    from graphslim_tpu_torch.kernels import pge as K

    # --- phase 1 ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    K.build()
    report = [ln.strip() for ln in K.BUILD_INFO["report"].splitlines()
              if "registers" in ln or "spill" in ln]
    log(f"build: {K.BUILD_INFO['seconds']:.1f} s nvcc -> "
        f"{os.path.relpath(K.BUILD_INFO['path'], HERE)}; ptxas: "
        + " | ".join(report))

    # --- phases 2-3 ------------------------------------------------------
    stats: dict = {}
    compare_kernels(K, stats)
    if opts.only == "kernels":
        return

    # --- phase 4 ---------------------------------------------------------
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load, read_npz
    from graphslim_tpu_torch.eval import Evaluator

    t0 = time.perf_counter()
    ds = load("ogbn-arxiv", seed=0, device="cuda")
    log(f"load ogbn-arxiv twin: {ds.n_nodes} nodes, {ds.adj.nnz} edges, "
        f"{time.perf_counter() - t0:.1f} s")
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

    src = "graphslim_tpu_torch/csrc/pge_kernels.cuh"
    kernels = [
        dict(name="pge_fwd", route="cuda", source=src,
             replaces="graphslim_tpu/kernels/pallas_pge.py:74",
             launches=launches["pge_fwd"], library_ms=None,
             **stats["pge_fwd"]),
        dict(name="pge_bwd", route="cuda", source=src,
             replaces="graphslim_tpu/kernels/pallas_pge.py:165",
             launches=launches["pge_bwd"], library_ms=None,
             **stats["pge_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
