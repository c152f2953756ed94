#!/usr/bin/env python3
"""Do profiled windows on the card keep every kernel record?

Run from the root of a checkout on a machine with a card:
``python3 tools/profiler_windows.py [mode]``.  ``chip_smoke.py`` reads
device time from ``torch.profiler`` windows
(``graphslim_tpu_torch.profiling.session``) and fails a window that
recorded none, or whose trace holds fewer entries of a port kernel than
its launch counter saw.  Each mode repeats windows and counts what their
traces lack, against the launches made inside them:

* default: the flickr twin's ``random`` reduce (phase 12 of the smoke: a
  few row gathers among host work), ``--windows`` times in each of three
  kinds of window (device activity alone, host and device, and
  ``profiling.session``), then single-gather windows of each kind (five
  times as many), then the first window of three fresh processes
  (``--first`` runs that child); where each window's earliest device
  event lies against the host's clock;
* ``--positions N``: N bare device-only windows (a third as many with the
  host, a fifth as many sessions of each kind) of five gathers and five
  torch adds, which launch positions go missing;
* ``--drift MIN`` / ``--interleaved MIN``: rounds of ten windows of each
  kind between eight seconds of matmuls, for MIN minutes: the launches
  missing by kind and process age (interleaved: bare windows, windows
  that wait 0.1 s on both sides of the body, windows opened by spin
  kernels of several counts and lengths, and ``profiling.session``);
* ``--aged S``: the same windows after S seconds of matmuls and no window
  before them.

The environment variables ``TEARDOWN_CUPTI`` and
``DISABLE_CUPTI_LAZY_REINIT`` set on the command line try the profiler's
other CUPTI lifetimes; ``WINDOW_KINDS=bare,session`` (names as printed)
keeps only those kinds of the interleaved count.  The first line prints the card's name and power
limit; the numbers go to ``PERF.md`` beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("GRAPHSLIM_TORCH_CACHE",
                      os.path.join(HERE, "build", "cache"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from graphslim_tpu_torch import profiling  # noqa: E402
from graphslim_tpu_torch.kernels import smem_gather as SG  # noqa: E402

GATHER = "gather_direct_kernel"


def window(kind: str, fn) -> dict:
    """One profiled window of ``fn()``: its device events, read raw from
    the profiler's results, against the gather's counted launches."""
    torch.cuda.synchronize()
    before = SG.LAUNCHES["smem_gather"]
    if kind == "session":
        ctx = profiling.session("cuda", host=False)
    else:
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if kind == "host+device" else [])
        ctx = profile(activities=acts)
    with ctx as prof:
        t0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    res = prof.profiler.kineto_results
    dev = [e for e in res.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    gathers = [e for e in dev if GATHER in e.name()]
    out = dict(kind=kind, events=len(dev), gathers=len(gathers),
               launches=SG.LAUNCHES["smem_gather"] - before,
               busy_us=sum((e.end_ns() - e.start_ns()) for e in dev) / 1e3,
               host_ms=(t1 - t0) / 1e6)
    if dev:
        first = min(e.start_ns() for e in dev)
        out.update(first_after_host_start_us=(first - t0) / 1e3,
                   first_after_trace_start_us=(
                       first - res.trace_start_ns()) / 1e3,
                   last_before_host_end_us=(
                       t1 - max(e.end_ns() for e in dev)) / 1e3)
    return out


def summary(tag: str, rows: list) -> None:
    empty = sum(r["events"] == 0 for r in rows)
    short = sum(r["gathers"] != r["launches"] for r in rows)
    firsts = [r["first_after_host_start_us"] for r in rows if r["events"]]
    print(f"{tag}: {len(rows)} windows, {empty} with no device event, "
          f"{short} with gather events != launches; earliest device event "
          f"after the host's start (us): min "
          f"{min(firsts) if firsts else float('nan'):.1f}, max "
          f"{max(firsts) if firsts else float('nan'):.1f}", flush=True)


def one_gather():
    x = torch.randn(4096, 128, device="cuda")
    idx = torch.randint(0, 4096, (1000,), device="cuda")
    torch.cuda.synchronize()
    return lambda: SG.gather_rows(x, idx)


def _ctx(kind: str):
    if kind.startswith("session"):
        return profiling.session("cuda", host=kind == "session+host")
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if kind == "host+device" else [])
    return profile(activities=acts)


def positions(kind: str, windows: int, t_start: float) -> None:
    """``windows`` windows of five gathers and five torch adds in turn:
    which launches go missing from the trace, where each lies against
    the host's clock, and how the earliest event's offset from its launch
    moves with the process's age."""
    x = torch.randn(4096, 128, device="cuda")
    idx = torch.randint(0, 4096, (1000,), device="cuda")
    y = torch.zeros(1024, device="cuda")
    want = ["gather", "add"] * 5
    lost_windows, lost_at, skews, shown = 0, [0] * len(want), [], 0
    for w in range(windows):
        torch.cuda.synchronize()
        with _ctx(kind) as prof:
            host = []
            for name in want:
                host.append(time.time_ns())
                if name == "gather":
                    SG.gather_rows(x, idx)
                else:
                    y.add_(1)
            torch.cuda.synchronize()
            t1 = time.time_ns()
        res = prof.profiler.kineto_results
        dev = sorted((e.start_ns(), e.end_ns(),
                      "gather" if GATHER in e.name() else "add")
                     for e in res.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
        # one stream: the device runs the launches in order
        got, j = [], 0
        for name in want:
            if j < len(dev) and dev[j][2] == name:
                got.append(dev[j])
                j += 1
            else:
                got.append(None)
        missing = [i for i, g in enumerate(got) if g is None]
        if got[0] is not None:
            skews.append((time.perf_counter() - t_start,
                          (got[0][0] - host[0]) / 1e3))
        if missing:
            lost_windows += 1
            for i in missing:
                lost_at[i] += 1
            if shown < 6:
                shown += 1
                t0 = host[0]
                print(f"  {kind} window {w} (age "
                      f"{time.perf_counter() - t_start:.1f} s): trace start "
                      f"{(res.trace_start_ns() - t0) / 1e3:.1f} us, host "
                      f"end {(t1 - t0) / 1e3:.1f} us; launches (host us / "
                      f"device us): "
                      + ", ".join(
                          f"{n} {(h - t0) / 1e3:.1f}/"
                          + ("LOST" if g is None
                             else f"{(g[0] - t0) / 1e3:.1f}")
                          for n, h, g in zip(want, host, got)), flush=True)
    bins = {}
    for age, sk in skews:
        b = int(age // 30) * 30
        lo, hi = bins.get(b, (sk, sk))
        bins[b] = (min(lo, sk), max(hi, sk))
    print(f"positions {kind}: {windows} windows of 10 launches, "
          f"{lost_windows} with launches missing, missing by position "
          f"{lost_at}; first event minus its launch (us) by process age: "
          + "; ".join(f"{b}-{b + 30} s {lo:.1f} to {hi:.1f}"
                      for b, (lo, hi) in sorted(bins.items())), flush=True)


def drift(minutes: float) -> None:
    """The process's age against what settled windows keep: every few
    seconds ten ``profiling.session`` windows of five gathers and five
    torch adds each (device-only, and with the host's operators too),
    each window's first device event minus the body's start on the
    host's clock, and the launches of each kind missing from its trace;
    then seconds of matmuls to keep the card loaded."""
    x = torch.randn(4096, 128, device="cuda")
    idx = torch.randint(0, 4096, (1000,), device="cuda")
    y = torch.zeros(1024, device="cuda")
    a = torch.randn(8192, 8192, device="cuda")

    def launch_us() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5000):
            y.add_(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 5000 * 1e6

    before = launch_us()
    with profiling.session("cuda", host=False):
        y.add_(1)
    print(f"drift: TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}; "
          f"an add's launch and run {before:.2f} us before the first "
          f"window, {launch_us():.2f} us after it", flush=True)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < 60 * minutes:
        for host in (False, True):
            firsts, lost = [], {"gather": 0, "add": 0}
            for _ in range(10):
                with profiling.session("cuda", host=host) as prof:
                    t0 = time.time_ns()
                    for _ in range(5):
                        SG.gather_rows(x, idx)
                        y.add_(1)
                    torch.cuda.synchronize()
                dev = [e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA]
                n_g = sum(GATHER in e.name() for e in dev)
                lost["gather"] += 5 - n_g
                lost["add"] += 5 - (len(dev) - n_g)
                if dev:
                    firsts.append((min(e.start_ns() for e in dev) - t0)
                                  / 1e3)
            print(f"drift: age {time.perf_counter() - t_start:.0f} s, "
                  f"{'host+device' if host else 'device'} sessions: first "
                  f"event minus the body's start "
                  f"{min(firsts, default=float('nan')):.1f} to "
                  f"{max(firsts, default=float('nan')):.1f} us, missing "
                  f"of 50 each: {lost}", flush=True)
        t_load = time.perf_counter()
        while time.perf_counter() - t_load < 8:
            (a @ a).sum().item()


def settle(lead: float, trail: float):
    """A device-only window that waits ``lead`` s after the profiler
    starts and ``trail`` s before it stops."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(lead)
            yield prof
            torch.cuda.synchronize()
            time.sleep(trail)
    return ctx()


def aged(load_s: float, rounds: int) -> None:
    """After ``load_s`` seconds of matmuls (the state in which settled
    windows lose launches), ``rounds`` rounds of ten windows each of five
    gathers and five adds, for each pair of waits (after the start,
    before the stop): which launch positions go missing."""
    x = torch.randn(4096, 128, device="cuda")
    idx = torch.randint(0, 4096, (1000,), device="cuda")
    y = torch.zeros(1024, device="cuda")
    a = torch.randn(8192, 8192, device="cuda")
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < load_s:
        (a @ a).sum().item()
    want = ["gather", "add"] * 5
    waits = ((0.1, 0.1), (0.1, 1.0), (1.0, 0.1), (0.0, 0.0))
    for r in range(rounds):
        for lead, trail in waits:
            lost_at = [0] * len(want)
            lasts = []
            for _ in range(10):
                with settle(lead, trail) as prof:
                    for name in want:
                        if name == "gather":
                            SG.gather_rows(x, idx)
                        else:
                            y.add_(1)
                    torch.cuda.synchronize()
                    t1 = time.time_ns()
                dev = sorted((e.start_ns(), e.end_ns(),
                              "gather" if GATHER in e.name() else "add")
                             for e in prof.profiler.kineto_results.events()
                             if e.device_type()
                             == torch.autograd.DeviceType.CUDA)
                j = 0
                for i, name in enumerate(want):
                    if j < len(dev) and dev[j][2] == name:
                        j += 1
                    else:
                        lost_at[i] += 1
                if dev:
                    lasts.append((dev[-1][1] - t1) / 1e3)
            print(f"aged: age {time.perf_counter() - t_start:.0f} s, waits "
                  f"{lead} / {trail} s: missing by position {lost_at}; last "
                  f"end minus the host's end {min(lasts, default=0):.1f} to "
                  f"{max(lasts, default=0):.1f} us", flush=True)


def spun(spins: int, cycles: int):
    """A device-only window whose body is preceded by ``spins``
    ``torch.cuda._sleep`` kernels of ``cycles`` cycles (synchronized)
    and followed by one, so that the card is busy, not idle, at both
    edges of the body."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            yield prof
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    return ctx()


def interleaved(minutes: float) -> None:
    """Rounds of windows between seconds of matmuls (the smoke's pattern:
    profiled windows among unprofiled work): for each kind of window, the
    launches of five gathers and five adds missing from its trace."""
    x = torch.randn(4096, 128, device="cuda")
    idx = torch.randint(0, 4096, (1000,), device="cuda")
    y = torch.zeros(1024, device="cuda")
    a = torch.randn(8192, 8192, device="cuda")
    kinds = {"bare": lambda: profile(activities=[ProfilerActivity.CUDA]),
             "waits 0.1 / 0.1 s": lambda: settle(0.1, 0.1),
             "spun 1 x 40 ms": lambda: spun(1, 80_000_000),
             "spun 20 x 2 ms": lambda: spun(20, 4_000_000),
             "spun 50 x 2 ms": lambda: spun(50, 4_000_000),
             "spun 100 x 1 ms": lambda: spun(100, 2_000_000),
             "session": lambda: profiling.session("cuda", False)}
    if os.environ.get("WINDOW_KINDS"):
        kinds = {k: v for k, v in kinds.items()
                 if k in os.environ["WINDOW_KINDS"].split(",")}
    print(f"interleaved: TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}, "
          f"DISABLE_CUPTI_LAZY_REINIT="
          f"{os.environ.get('DISABLE_CUPTI_LAZY_REINIT')}",
          flush=True)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < 60 * minutes:
        for kind, make in kinds.items():
            lost = {"gather": 0, "add": 0}
            windows_lost = 0
            for _ in range(10):
                with make() as prof:
                    for _ in range(5):
                        SG.gather_rows(x, idx)
                        y.add_(1)
                    torch.cuda.synchronize()
                names = [e.name() for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and "spin_kernel" not in e.name()]
                n_g = sum(GATHER in n for n in names)
                lost["gather"] += 5 - n_g
                lost["add"] += 5 - (len(names) - n_g)
                windows_lost += len(names) < 10
            print(f"interleaved: age {time.perf_counter() - t_start:.0f} s, "
                  f"{kind}: missing of 50 each {lost}, {windows_lost} of 10 "
                  f"windows short", flush=True)
        t_load = time.perf_counter()
        while time.perf_counter() - t_load < 8:
            (a @ a).sum().item()


def first_child() -> None:
    SG.build()
    fn = one_gather()
    fn()
    print(json.dumps(window("device", fn)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--first", action="store_true")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="run only the drift count, this many minutes")
    ap.add_argument("--interleaved", type=float, default=0.0,
                    help="run only the interleaved count, this many "
                    "minutes")
    ap.add_argument("--aged", type=float, default=0.0,
                    help="run only the aged-process count after this many "
                    "seconds of matmuls")
    ap.add_argument("--positions", type=int, default=0,
                    help="run only the positions count, this many bare "
                    "windows of each kind (a fifth as many settled ones)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows: no CUDA card")
    if opts.first:
        first_child()
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    for mod in ("sklearn", "matplotlib", "networkx", "wandb"):
        try:
            __import__(mod)
            print(f"{mod}: importable")
        except ImportError:
            print(f"{mod}: not installed")
    SG.build()
    if opts.drift:
        drift(opts.drift)
        return
    if opts.interleaved:
        interleaved(opts.interleaved)
        return
    if opts.aged:
        aged(opts.aged, 3)
        return
    if opts.positions:
        t_start = time.perf_counter()
        for kind, n in (("device", opts.positions),
                        ("host+device", opts.positions // 3),
                        ("session", opts.positions // 5),
                        ("session+host", opts.positions // 5)):
            positions(kind, n, t_start)
        return

    import chip_smoke as CS
    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.reduce import create_reducer

    t0 = time.perf_counter()
    flickr = load("flickr", seed=0, device="cuda")
    print(f"flickr twin loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = CS.ind_args("flickr", "random", tmp, 1)

        def reduce():
            create_reducer("random", flickr, args).reduce(flickr)

        for kind in ("device", "host+device", "session"):
            rows[kind] = [window(kind, reduce) for _ in range(opts.windows)]
        fn = one_gather()
        for kind in ("device", "host+device", "session"):
            rows["single " + kind] = [window(kind, fn)
                                      for _ in range(5 * opts.windows)]
    for tag, rs in rows.items():
        summary(tag, rs)
        for i, r in enumerate(rs):
            if r["events"] == 0 or r["gathers"] != r["launches"] or i < 2:
                print(f"  {tag} window {i}: {json.dumps(r)}")
    firsts = []
    for _ in range(3):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--first"], capture_output=True, text=True)
        line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() \
            else res.stderr[-400:]
        print(f"first window of a fresh process: {line}", flush=True)
        firsts.append(line)


if __name__ == "__main__":
    main()
