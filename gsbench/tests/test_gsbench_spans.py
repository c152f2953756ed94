"""The span readers (``gsbench/spans.py``, ``gsbench/metrics/``) on a
hand-made run with known answers, a tiny CPU run of the driver, and a
program without the recorder."""

import contextlib
import sys
import tempfile
import time
import types

import pytest
import torch

from gsbench_tiny import tiny
from gsbench import cond_job, manifest, spans as S

# after gsbench_tiny has put the checkout's root on the path
import graphslim_tpu_torch  # noqa: E402

MS = 1_000_000  # ns

SETUP = ("load_s.graph", "init_s.engine", "init_s.job", "kernels_load_s",
         "warmup_s", "setup_s.unspanned")
STEP = ("idle_share.unprofiled", "idle_ms.generator", "idle_ms.match",
        "idle_ms.backward", "idle_ms.optimizers", "idle_ms.inner",
        "gathered_rows_per_step")


def _read(name, ctx):
    return manifest.reader(name).read(ctx)


def ns(ms: float) -> int:
    return round(ms * MS)


class Run:
    """Spans of a hand-made run, in ms."""

    def __init__(self):
        self.spans, self.stack = [], []

    def add(self, name, a, b, job=None, step=None, counts=None):
        parent = self.stack[-1] if self.stack else None
        s = dict(id=len(self.spans), name=name, start_ns=ns(a),
                 end_ns=ns(b), parent=parent, job=job, step=step,
                 attrs={}, error=None, counts=counts or {})
        self.spans.append(s)
        return s["id"]

    @contextlib.contextmanager
    def within(self, sid):
        self.stack.append(sid)
        yield
        self.stack.pop()

    def step(self, a, job, k, rows=100):
        """A step of 10 ms from ``a``: generator 1, match 3 (the gather
        counts ``rows``), backward 3, optimizers 1, inner 1, then 1 ms in
        no child (the host between the step's phases and the next)."""
        sid = self.add("step", a, a + 10, job, k)
        with self.within(sid):
            t = a
            for child, d in (("step.generator", 1), ("step.match", 3),
                             ("step.backward", 3), ("step.optimizers", 1),
                             ("step.inner", 1)):
                cid = self.add(child, t, t + d, job, k)
                if child == "step.match":
                    with self.within(cid):
                        self.add("match.gather", t + 1, t + 2, job, k,
                                 {"match.gathered_rows": rows})
                t += d


@pytest.fixture
def run():
    """Set-up from 1000 ms (process start at 0, setup_s 1.5 s): a load
    with its graph build nested, the engine's init, the warm-up job (its
    init, an epoch of two steps, the PGE library's load inside its first
    step), then the window's job: its init, then 20 steps of 10 ms from
    1500 ms; the profiled stretch is steps 10 to 13 (1600 to 1640 ms).
    The device idles three times there: 1600-1601 (step 10's generator),
    1624.5-1626.5 (step 12's backward, 1624-1627) and 1629.2-1629.8
    (step 12's last ms, in no child)."""
    r = Run()
    lid = r.add("data.load", 1000, 1100)
    with r.within(lid):
        r.add("data.read", 1000, 1050)
        r.add("data.graph", 1050, 1080)
        r.add("data.views", 1080, 1100)
    eid = r.add("engine.init", 1100, 1150)
    with r.within(eid):
        r.add("engine.tables", 1110, 1140)
    wid = r.add("reduce", 1200, 1300, job=0)
    with r.within(wid):
        r.add("job.init", 1200, 1220, job=0)
        ep = r.add("epoch", 1220, 1260, job=0)
        with r.within(ep):
            r.step(1220, 0, 0)
            r.add("kernels.load", 1221, 1222, job=0, step=0)
            r.step(1230, 0, 1)
    jid = r.add("reduce", 1400, 1800, job=1)
    with r.within(jid):
        r.add("job.init", 1400, 1450, job=1)
        ep = r.add("epoch", 1490, 1700, job=1)
        with r.within(ep):
            for k in range(20):
                r.step(1500 + 10 * k, 1, k, rows=120)
    kernels = [("k", ns(1601), ns(1624.5)), ("k", ns(1626.5), ns(1629.2)),
               ("k", ns(1629.8), ns(1640))]
    return dict(spans=r.spans, kernels=kernels, setup_s=1.5,
                stretch_ns=(ns(1600), ns(1640)), prof_steps=4)


def test_set_up_readers_read_their_spans(run):
    assert _read("load_s.graph", run) == pytest.approx(0.030)
    assert _read("init_s.engine", run) == pytest.approx(0.050)
    assert _read("init_s.job", run) == pytest.approx(0.020 + 0.050)
    assert _read("kernels_load_s", run) == pytest.approx(0.001)
    # the warm-up's epoch, not the window job's, which opens before its
    # first step
    assert _read("warmup_s", run) == pytest.approx(0.040)


def test_the_unspanned_set_up_is_the_exact_remainder(run):
    """Covered before 1500 ms: 1000-1150 (nested spans once), 1200-1300
    and 1400-1500 (the window's job, clipped at its first step): 350 ms
    of 1.5 s."""
    covered = S.union_ns([(s["start_ns"], min(s["end_ns"], ns(1500)))
                          for s in run["spans"]
                          if s["start_ns"] < ns(1500)])
    assert covered == ns(350)
    got = _read("setup_s.unspanned", run)
    assert got == pytest.approx(1.5 - 0.350, abs=1e-12)
    assert got + covered / 1e9 == pytest.approx(run["setup_s"], abs=1e-12)


def test_each_gap_lands_in_the_phase_open_at_its_midpoint(run):
    by = S.idle_by_phase(run)
    assert by == {"step.generator": ns(1), "step.match": 0,
                  "step.backward": ns(2), "step.optimizers": 0,
                  "step.inner": 0, None: ns(0.6)}
    busy = sum(b - a for _, a, b in run["kernels"])
    assert sum(by.values()) == ns(40) - busy
    assert _read("idle_ms.generator", run) == pytest.approx(0.25)
    assert _read("idle_ms.backward", run) == pytest.approx(0.5)
    for child in ("match", "optimizers", "inner"):
        assert _read(f"idle_ms.{child}", run) == 0
    # the five and the rest make the stretch's idle time a step
    five = sum(_read(f"idle_ms.{c}", run) for c in
               ("generator", "match", "backward", "optimizers", "inner"))
    rest = by[None] / 1e6 / 4
    assert five + rest == pytest.approx((40 - busy / MS) / 4)


def test_the_unprofiled_idle_share_is_busy_over_period(run):
    """Step spans every 10 ms before the stretch; 36.4 ms of device work
    over 4 profiled steps: 1 - 9.1 / 10 = 9 %."""
    assert _read("idle_share.unprofiled", run) == pytest.approx(9.0)
    # steps of 20 ms before the stretch: 1 - 9.1 / 20
    for s in run["spans"]:
        if s["name"] == "step" and s["job"] == 1 and s["step"] <= 5:
            s["start_ns"] = ns(1400 + 20 * s["step"])
    run["stretch_ns"] = (ns(1500), ns(1540))
    assert _read("idle_share.unprofiled", run) == pytest.approx(54.5)


def test_gathered_rows_per_step_reads_the_window_job(run):
    assert _read("gathered_rows_per_step", run) == 120


@pytest.mark.parametrize("name", SETUP + STEP)
def test_a_reader_gives_none_without_the_spans_it_needs(name, run,
                                                        monkeypatch):
    # no spans at all
    assert _read(name, dict(run, spans=[])) is None
    # a program whose profiling module has no recorder (the parent)
    fake = types.ModuleType("graphslim_tpu_torch.profiling")
    monkeypatch.setitem(sys.modules, "graphslim_tpu_torch.profiling", fake)
    monkeypatch.setattr(graphslim_tpu_torch, "profiling", fake,
                        raising=False)
    ctx = {k: v for k, v in run.items() if k != "spans"}
    assert _read(name, ctx) is None
    # spans, but no job reached its window
    only_setup = [s for s in run["spans"] if s["job"] is None]
    assert _read(name, dict(run, spans=only_setup)) is None


def test_a_tiny_cpu_run_gives_every_set_up_reading():
    """The driver's whole run on the CPU: set-up readers read the port's
    own spans, the remainder closes ``setup_s``, and the gathered rows
    are C·B·Π(f+1) of the engine's shapes."""
    from graphslim_tpu_torch import profiling

    torch.set_num_threads(2)
    profiling.clear()
    cfg, tr = tiny("gcond_reddit")
    t_start = time.perf_counter()
    rec = cond_job.run(cfg, tr, 3, 0.5, False, "cpu", t_start,
                       manifest.limits("gcond_reddit.r0.001"),
                       twin_root=tempfile.mkdtemp())
    ctx = dict(rec["ctx"])
    for name in SETUP:
        v = _read(name, ctx)
        if name == "kernels_load_s":
            assert v is None    # no CUDA library loads on the CPU
        else:
            assert v is not None and v >= 0, name
    spans = ctx["spans"]
    end = S.setup_end_ns(spans)
    covered = S.union_ns([(s["start_ns"], min(s["end_ns"], end))
                          for s in spans if s["start_ns"] < end])
    assert _read("setup_s.unspanned", ctx) + covered / 1e9 == \
        pytest.approx(ctx["setup_s"], abs=1e-9)
    # the tiny twin: four classes, each train pool over the batch
    e = cfg["engine"]
    f0, f1 = e["fanouts"]
    want = cfg["twin"]["nclass"] * e["sample_batch"] * (f0 + 1) * (f1 + 1)
    assert _read("gathered_rows_per_step", ctx) == want
