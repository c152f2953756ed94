"""Profiling utilities: ``torch.profiler`` traces and a throughput meter.

Counterpart of ``graphslim_tpu/profiling.py``.  :func:`trace` captures a
``torch.profiler`` trace around any reduction run (``--profile``): host
operators, and on the card the device's kernels too, written as a
Chrome/TensorBoard trace (``*.pt.trace.json``) under ``out_dir``.
:func:`session` is the profiler window it opens, also used on its own to
read device time.  :class:`Throughput` meters items per second around
repeated calls; where the JAX package times dispatch (its ``measure``
never blocks), this one synchronizes the card before each clock read when
the work runs there.  The FLOP counter and the A100 ceiling are the JAX
package's arithmetic.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time

import torch

log = logging.getLogger("graphslim_tpu_torch")

# Kernel records lost at the start of a profiled window: on an H100
# (torch 2.11, CUDA 12.8), once a process has run unprofiled work on the
# card since its first window, the trace of each window lacks its first
# few kernels (the first 1 to all 10 of 10 after 20 s to 3 min of matmuls
# between windows, device-only or with host operators, waiting or not,
# with or without CUPTI's teardown or lazy re-initialization;
# tools/profiler_windows.py --interleaved).  A window on the card
# therefore starts with PREAMBLE_SPINS spin kernels of about 2 ms
# (``torch.cuda._sleep``, entries named PREAMBLE_KERNEL), synchronized
# before its body: they take most of the loss (20 of them: 4 short
# windows in about 740 under that load, where 50 or 100 did worse and
# tearing CUPTI down after each window emptied every second one), and
# readers of device time leave them out.  The card's timestamps also map up to
# about 7 ms off the host clock that bounds a window, so a window waits
# SETTLE_S after its body before it stops.
PREAMBLE_SPINS = 20
PREAMBLE_CYCLES = 4_000_000       # about 2 ms a spin on an H100
PREAMBLE_KERNEL = "spin_kernel"
SETTLE_S = 0.02


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def session(device="cuda", host: bool = True):
    """A ``torch.profiler.profile`` window, yielded open: host operators
    (unless ``host`` is False) and, when ``device`` is a CUDA device, the
    card's kernels, its body preceded by the spin preamble and followed by
    ``SETTLE_S`` of waiting (see above)."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        if cuda:
            with torch.cuda.device(dev):
                for _ in range(PREAMBLE_SPINS):
                    torch.cuda._sleep(PREAMBLE_CYCLES)
            _sync(dev)
        yield prof
        _sync(dev)
        if cuda:
            time.sleep(SETTLE_S)


@contextlib.contextmanager
def trace(out_dir: str | None, enabled: bool = True, device="cuda"):
    """Trace the body into ``out_dir`` (TensorBoard's profiler plugin or
    ``chrome://tracing`` read it); nothing when disabled or without a
    directory."""
    if not enabled or not out_dir:
        yield
        return
    os.makedirs(out_dir, exist_ok=True)
    with session(device) as prof:
        yield
    path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


class Throughput:
    """Items/s meter around repeated calls (edges/s by default).  With
    ``device`` a CUDA device, ``measure`` synchronizes it before reading
    the clock at both ends, so the time is the work's and not its
    dispatch's."""

    def __init__(self, items_per_call: int, unit: str = "edges",
                 device="cuda"):
        self.items = items_per_call
        self.unit = unit
        self.device = torch.device(device)
        self.calls = 0
        self.elapsed = 0.0

    @contextlib.contextmanager
    def measure(self):
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.elapsed += time.perf_counter() - t0
        self.calls += 1

    @property
    def per_second(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.items * self.calls / self.elapsed

    def report(self) -> str:
        return (f"{self.per_second / 1e6:.1f} M {self.unit}/s "
                f"({self.calls} calls, {self.elapsed:.3f}s)")


def gcond_step_flops(*, n_classes: int, batch: int, fanouts, nfeat: int,
                     nhid: int, nclass: int, ntrans: int, n_syn: int,
                     pge_nhid: int, pge_nlayers: int,
                     deep_rows: int | None = None) -> dict:
    """Analytic FLOPs of one GCond outer step (forward and backward, f32
    semantics), walking the shapes: the real phase per class, the
    synthetic phase (one shared forward, a per-class vjp and the nested
    backward) and the PGE pair MLP over ``n_syn²`` pairs.  ``deep_rows``
    overrides the deepest block size (``batch·Π(fanout+1)`` by default;
    PyG's deduplicating sampler yields fewer unique rows)."""
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * (f + 1))
    deep = deep_rows if deep_rows is not None else sizes[-1]
    trans_dims = ([nfeat, nclass] if ntrans == 1
                  else [nfeat] + [nhid] * (ntrans - 1) + [nclass])

    def mlp(m, dims):
        return sum(2.0 * m * a * b for a, b in zip(dims[:-1], dims[1:]))

    real = n_classes * 3.0 * mlp(deep, trans_dims)
    syn_fwd = mlp(n_syn, trans_dims) + 2.0 * len(fanouts) * n_syn ** 2 \
        * nclass
    syn = syn_fwd + n_classes * 4.0 * syn_fwd
    pge_dims = [2 * nfeat] + [pge_nhid] * (pge_nlayers - 1) + [1]
    pge = 3.0 * mlp(n_syn * n_syn, pge_dims)
    return {"real": real, "syn": syn, "pge": pge,
            "total": real + syn + pge}


def a100_reference_ceiling_steps_per_s() -> tuple[float, dict]:
    """Upper bound on the reference PyTorch GCond's outer-step rate on an
    A100 at ``configs/gcond/ogbn-arxiv.json`` (SGC ntrans 2, hidden 256,
    r = 0.01): its FLOPs at 10,000 unique deep rows a class against the
    A100's fp32 peak of 19.5 TFLOP/s (the reference leaves TF32 off).
    The figure is the reference's A100 bound, not a measurement of this
    port."""
    f = gcond_step_flops(n_classes=40, batch=256, fanouts=(10, 5),
                         nfeat=128, nhid=256, nclass=40, ntrans=2,
                         n_syn=909, pge_nhid=256, pge_nlayers=3,
                         deep_rows=10_000)
    a100_fp32 = 19.5e12
    return a100_fp32 / f["total"], f
