"""The profiled stretch of a traced run, and what its trace says.

The opening and closing of a window are a frozen copy of the port's
``graphslim_tpu_torch/profiling.py::session``, opened and closed by hand
at step boundaries inside a running job.  On an H100, once a process has
run unprofiled work on the card, a window's first kernel records go
missing; a window therefore starts with ``PREAMBLE_SPINS`` spin kernels of
about 2 ms (``torch.cuda._sleep``, named ``PREAMBLE_KERNEL`` in the
trace), synchronized before the stretch begins, and every reader leaves
them out.  The card's timestamps map up to a few milliseconds off the
host clock, so a window waits ``SETTLE_S`` after its stretch before it
stops.  The trace is of the device alone: tracing the host's operators
slows a job of thousands of them a step severalfold.

The reductions below are plain functions of ``(name, start_ns, end_ns)``
kernel records on the host's clock (``time.time_ns``).
"""

from __future__ import annotations

import time

PREAMBLE_SPINS = 20
PREAMBLE_CYCLES = 4_000_000       # about 2 ms a spin on an H100
PREAMBLE_KERNEL = "spin_kernel"
SETTLE_S = 0.02


class Window:
    """A device-only ``torch.profiler`` window, opened and closed by
    hand; ``t0_ns`` and ``t1_ns`` bound its stretch on the host's clock,
    after the preamble and before the settling wait."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = None

    def open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        with torch.cuda.device(self.device):
            for _ in range(PREAMBLE_SPINS):
                torch.cuda._sleep(PREAMBLE_CYCLES)
        torch.cuda.synchronize(self.device)
        self.t0_ns = time.time_ns()

    def close(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        time.sleep(SETTLE_S)
        self.prof.__exit__(None, None, None)

    def kernels(self) -> list:
        """Every device record of the window but the spins:
        ``(name, start_ns, end_ns)``."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if (e.device_type() != DeviceType.CUDA
                    or PREAMBLE_KERNEL in e.name()):
                continue
            out.append((e.name(), e.start_ns(), e.end_ns()))
        return out


def busy_ns(records: list) -> int:
    """Length of the union of the records' intervals."""
    total, end = 0, None
    for _, a, b in sorted(records, key=lambda r: r[1]):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(records: list, t0: int, t1: int) -> list:
    """``(start_ns, end_ns, next record's name)`` of every stretch in
    ``[t0, t1]`` that no record covers (the last one's next is '')."""
    gaps, end = [], t0
    for name, a, b in sorted(records, key=lambda r: r[1]):
        if a > end:
            gaps.append((end, a, name))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1, ""))
    return gaps


def by_name(records: list) -> dict:
    """``{name: (seconds summed, records)}``."""
    out: dict = {}
    for name, a, b in records:
        s, n = out.get(name, (0.0, 0))
        out[name] = (s + (b - a) / 1e9, n + 1)
    return out


def phase_at(phases: list, t: int) -> str:
    """The host phase in force at ``t``: ``phases`` is a time-ordered list
    of ``(t_ns, label)``, each label holding until the next."""
    label = "before the stretch"
    for ts, lab in phases:
        if ts > t:
            break
        label = lab
    return label
