"""Run one cell of the port's benchmark once.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the configuration names the driver that
runs its job (:mod:`gsbench.cond_job`).  With ``--trace 0`` the last line
of standard output is the cell's end-to-end metrics, with ``--trace 1``
its per-layer ones, each read by ``gsbench/metrics/<name>.py``, beside
``correct`` (the reference's check, :mod:`gsbench.check`), the steps
attempted and failed, and the device.  The numbers the check compared,
each with its limit, come last in that line (``checks``) and as the last
lines of standard error.

The run measures ``graphslim_tpu_torch``, the PyTorch port, on a CUDA
card, and nothing else: it exits with a code other than 0, printing no
result, without a card, with fewer cards than the cell asks for, or when
a module of JAX or of the JAX package has been loaded by the time the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if not __package__:
    sys.path[0] = ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "graphslim_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a
    library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def breakdown(ctx: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing (the harness's own phases of a step)
    and the operation that ended each."""
    from gsbench import window

    k = ctx.get("kernels") or []
    ops = sorted(window.by_name(k).items(), key=lambda kv: -kv[1][0])
    t0, t1 = ctx["stretch_ns"]
    gaps = sorted(window.idle_gaps(k, t0, t1), key=lambda g: g[0] - g[1])
    phases = ctx.get("phases", [])
    return {
        "device_ops": [[name[:200], s] for name, (s, _) in ops[:10]],
        "idle_gaps": [[f"{window.phase_at(phases, (a + b) // 2)} -> "
                       f"{nxt[:120] or 'end of stretch'}", (b - a) / 1e9]
                      for a, b, nxt in gaps[:10]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _env()

    import torch

    from gsbench import manifest, window

    bench = manifest.benchmark(ROOT)
    cell = manifest.cell(bench, a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(a.workload)
    trace = bool(a.trace)
    rec = manifest.driver(cfg).run(cfg, traffic, a.seed, a.seconds, trace,
                                   "cuda", T_START, limits)
    ctx = rec["ctx"]
    metrics = {}
    for m in manifest.reported(bench, a.workload, trace):
        v = manifest.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": ctx["peak_bytes"]}
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace and ctx.get("kernels"):
        t0, t1 = ctx["stretch_ns"]
        device["busy_s"] = window.busy_ns(ctx["kernels"]) / 1e9
        device["window_s"] = (t1 - t0) / 1e9
        result["breakdown"] = breakdown(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result["checks"] = rec["checks"]
    for name, c in rec["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
