"""Profiling utilities: spans and counters, ``torch.profiler`` traces and a
throughput meter.

Counterpart of ``graphslim_tpu/profiling.py``, with a span recorder the
JAX package does not have.  :func:`span` times a stretch of host code and
:func:`count` adds a quantity into the innermost open span and into a
process total; the condensation engine opens spans at its layer
boundaries (set-up: ``data.load``, ``engine.init``, ``kernels.load``,
``job.init``; each outer step: ``step`` and its phases) and the benchmark
reads them back through :func:`spans` and :func:`counters`.  Spans are on
the clock of ``time.time_ns``, the one ``torch.profiler`` maps the card's
kernel records to, so a program span and a kernel record compare
directly.  The recorder is on by default and costs two clock reads and
one append a span: no device synchronization, no CUDA event, no tensor
read.  ``RECORDER.enabled = False`` turns it off (:func:`span` then
returns one shared no-op).

:func:`trace` captures a ``torch.profiler`` trace around any reduction run
(``--profile``): host operators, and on the card the device's kernels too,
written as a Chrome/TensorBoard trace (``*.pt.trace.json``) under
``out_dir``, with every span the body opens as a ``record_function``
range of its name.  :func:`session` is the profiler window it opens, also
used on its own to read device time.  :class:`Throughput` meters items per
second around repeated calls; where the JAX package times dispatch (its
``measure`` never blocks), this one synchronizes the card before each
clock read when the work runs there.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import socket
import time

import torch

log = logging.getLogger("graphslim_tpu_torch")

# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

RING = 65_536        # step spans kept: about 14 a step at 70 steps/s, 15 s
JOB_SPAN = "reduce"  # the outermost one opens a job
STEP_SPAN = "step"   # numbers the outer steps of its job from 0


class Recorder:
    """Where spans and counters go: spans outside any outer step (set-up,
    epochs) in one bounded buffer, spans of the steps in a ring of
    ``RING``, both in the order they close; counter totals by name."""

    def __init__(self):
        self.enabled = True
        self.ranges = False          # also open record_function ranges
        self.stack: list = []        # open spans, innermost last
        self.kept = collections.deque(maxlen=RING)
        self.ring = collections.deque(maxlen=RING)
        self.totals: dict = {}
        self.ids = itertools.count()
        self.jobs = itertools.count()
        self.next_step = 0

    def clear(self) -> None:
        self.kept.clear()
        self.ring.clear()
        self.totals.clear()


RECORDER = Recorder()


class Span:
    """One timed stretch of host code (see :func:`span`)."""

    __slots__ = ("id", "name", "attrs", "start_ns", "end_ns", "parent",
                 "job", "step", "error", "counts", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.end_ns = None
        self.error = self.counts = self._range = None

    def __enter__(self):
        r = RECORDER
        parent = r.stack[-1] if r.stack else None
        self.id = next(r.ids)
        self.parent = parent
        self.job = None if parent is None else parent.job
        self.step = None if parent is None else parent.step
        if self.name == JOB_SPAN and self.job is None:
            self.job = next(r.jobs)
            r.next_step = 0
        elif self.name == STEP_SPAN:
            self.step = r.next_step
            r.next_step += 1
        r.stack.append(self)
        if r.ranges:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        r = RECORDER
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if exc_type is not None:
            self.error = exc_type.__name__
        r.stack.pop()
        (r.kept if self.step is None else r.ring).append(self)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def record(self) -> dict:
        return dict(id=self.id, name=self.name, start_ns=self.start_ns,
                    end_ns=self.end_ns,
                    parent=None if self.parent is None else self.parent.id,
                    job=self.job, step=self.step, attrs=dict(self.attrs),
                    error=self.error, counts=dict(self.counts or {}))


class _NoSpan:
    """The recorder off: records nothing, times nothing."""

    seconds = float("nan")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoSpan()


def span(name: str, **attrs):
    """A context manager recording ``name``'s start, end, parent span, job
    and outer step (``job``: the outermost open ``reduce`` span's; ``step``:
    the innermost open ``step`` span's index in its job, shared by every
    span inside it), ``attrs``, the exception that closed it if any, and
    the counts added while it was the innermost span."""
    if not RECORDER.enabled:
        return _NOOP
    return Span(name, attrs)


def count(name: str, n) -> None:
    """Add ``n`` into the innermost open span's ``name`` and the process
    total."""
    r = RECORDER
    if not r.enabled:
        return
    r.totals[name] = r.totals.get(name, 0) + n
    if r.stack:
        top = r.stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


def spans() -> list:
    """Every closed span kept, in the order they opened, as plain dicts:
    ``id``, ``name``, ``start_ns``, ``end_ns``, ``parent`` (an id or None),
    ``job``, ``step``, ``attrs``, ``error``, ``counts``."""
    r = RECORDER
    return [s.record() for s in sorted((*r.kept, *r.ring),
                                       key=lambda s: s.id)]


def counters() -> dict:
    """The process totals of every counter."""
    return dict(RECORDER.totals)


def clear() -> None:
    """Forget every closed span and counter total."""
    RECORDER.clear()


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
    ``chrome://tracing`` read it), each span the body opens a
    ``record_function`` range of its name; nothing when disabled or
    without a directory."""
    if not enabled or not out_dir:
        yield
        return
    os.makedirs(out_dir, exist_ok=True)
    ranges = RECORDER.ranges
    RECORDER.ranges = True
    try:
        with session(device) as prof:
            yield
    finally:
        RECORDER.ranges = ranges
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
