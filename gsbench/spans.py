"""Readings of the program's own spans and counters.

The port records spans at its layer boundaries
(``graphslim_tpu_torch/profiling.py``): each a dict with ``name``,
``start_ns`` and ``end_ns`` on the clock of ``time.time_ns`` (the one the
device trace's records and the profiled stretch's bounds are on),
``parent`` (an id), ``job``, ``step`` and ``counts``.  A run's jobs are
its ``reduce`` calls: the warm-up's, then the window's, the last job.
The window's steps are the last job's ``step`` spans; set-up is every
span that starts before the first of them.

Each function returns None where the spans it needs are missing (a
program without the recorder, or a run that did not reach its window).
"""

from __future__ import annotations

import bisect

from gsbench.window import busy_ns, idle_gaps

STEP_CHILDREN = ("step.generator", "step.match", "step.backward",
                 "step.optimizers", "step.inner")


def program_spans(ctx: dict):
    """The run's spans: ``ctx["spans"]`` where given, else a snapshot of
    the port's recorder in this process, kept in ``ctx`` for the next
    reader; None where the port records none."""
    if "spans" not in ctx:
        try:
            from graphslim_tpu_torch import profiling
        except ImportError:
            return None
        snapshot = getattr(profiling, "spans", None)
        ctx["spans"] = snapshot() if snapshot is not None else None
    return ctx["spans"] or None


def window_steps(spans: list) -> list:
    """The last job's ``step`` spans in order, or []."""
    jobs = [s["job"] for s in spans if s["name"] == "reduce"
            and s["job"] is not None]
    if not jobs:
        return []
    last = max(jobs)
    return sorted((s for s in spans if s["name"] == "step"
                   and s["job"] == last), key=lambda s: s["start_ns"])


def setup_end_ns(spans: list):
    """Start of the window's first step: where set-up ends."""
    steps = window_steps(spans)
    return steps[0]["start_ns"] if steps else None


def setup_seconds(ctx: dict, name: str, before_job: bool = False):
    """Host seconds of the spans named ``name`` that start in set-up
    (with ``before_job``, only those of jobs before the window's)."""
    spans = program_spans(ctx)
    steps = window_steps(spans) if spans else []
    if not steps:
        return None
    end, last = steps[0]["start_ns"], steps[0]["job"]
    got = [s for s in spans if s["name"] == name and s["start_ns"] < end
           and not (before_job and s["job"] == last)]
    if not got:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in got) / 1e9


def union_ns(intervals: list) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    return busy_ns([("", a, b) for a, b in intervals])


def setup_unspanned(ctx: dict):
    """``ctx["setup_s"]`` less the union of the spans before the window's
    first step, each clipped there: what no span of the program covers
    (imports, the twin's file, the harness's own work)."""
    spans = program_spans(ctx)
    if not spans or "setup_s" not in ctx:
        return None
    end = setup_end_ns(spans)
    if end is None:
        return None
    covered = union_ns([(s["start_ns"], min(s["end_ns"], end))
                        for s in spans if s["start_ns"] < end])
    return ctx["setup_s"] - covered / 1e9


def idle_by_phase(ctx: dict):
    """``{child: idle ns}`` over the profiled stretch: each idle gap of
    the device put down to the step child open on the host at the gap's
    midpoint, ``None`` for gaps outside every step child; None without a
    profiled stretch or spans."""
    spans, k = program_spans(ctx), ctx.get("kernels")
    if not spans or not k or "stretch_ns" not in ctx:
        return None
    steps = {s["id"] for s in window_steps(spans)}
    kids = sorted(((s["start_ns"], s["end_ns"], s["name"]) for s in spans
                   if s["parent"] in steps and s["name"] in STEP_CHILDREN),
                  key=lambda c: c[0])
    if not kids:
        return None
    starts = [c[0] for c in kids]
    out = dict.fromkeys((*STEP_CHILDREN, None), 0)
    t0, t1 = ctx["stretch_ns"]
    for a, b, _ in idle_gaps(k, t0, t1):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = kids[i][2] if i >= 0 and mid < kids[i][1] else None
        out[name] += b - a
    return out


def idle_ms(ctx: dict, child: str):
    """Idle ms a profiled step put down to ``child``."""
    by = idle_by_phase(ctx)
    if by is None or not ctx.get("prof_steps"):
        return None
    return by[child] / 1e6 / ctx["prof_steps"]


def idle_share_unprofiled(ctx: dict):
    """1 − the device's busy time a profiled step over the mean period of
    the program's ``step`` spans before the profiled stretch, in %."""
    spans, k = program_spans(ctx), ctx.get("kernels")
    if not spans or not k or not ctx.get("prof_steps"):
        return None
    t0 = ctx["stretch_ns"][0]
    starts = [s["start_ns"] for s in window_steps(spans)
              if s["start_ns"] < t0]
    if len(starts) < 2:
        return None
    period = (starts[-1] - starts[0]) / (len(starts) - 1)
    return 100.0 * (1.0 - busy_ns(k) / ctx["prof_steps"] / period)


def per_step_count(ctx: dict, name: str):
    """The counter ``name`` summed over each window step that counted it,
    averaged over those steps."""
    spans = program_spans(ctx)
    if not spans:
        return None
    steps = window_steps(spans)
    if not steps:
        return None
    job = steps[0]["job"]
    by_step: dict = {}
    for s in spans:
        if s["job"] == job and s["step"] is not None \
                and name in (s["counts"] or {}):
            by_step[s["step"]] = by_step.get(s["step"], 0) \
                + s["counts"][name]
    if not by_step:
        return None
    return sum(by_step.values()) / len(by_step)
