"""Readings that set an MSGC cell's correctness limits, at the cell's own
size.

    python3 gsbench/calibrate_msgc.py --workload msgc_arxiv.r0.01 \\
        --seeds 11,12,13 --control 3 [--out calibrate_msgc.jsonl]

As :mod:`gsbench.calibrate` does for GCond, through
:mod:`gsbench.msgc_job`: for each seed one job of the cell runs through
the benchmark's hooks, ended once both of the check's stretches are
captured (no timed window), and the reference's numbers against the
program's are printed.  For the first ``--control`` seeds, besides: the
control (the reference in TF32, in the program's place, against the
reference in float32) and two planted faults in the reference in the
program's place: ``half_batch`` (the second half of each class's targets
left out) and ``altered`` (one skeleton entry's score changed).  A state
left unchanged reads 1 as the ``change_gap`` of its group and needs no
run.  One dataset serves every seed.  A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from gsbench import calibrate, check, manifest, msgc_job  # noqa: E402
from gsbench import spans, twins  # noqa: E402


def calibrate_msgc(cfg: dict, traffic: dict, seeds: list, n_control: int,
                   device: str, twin_root: str = twins.CACHE, emit=print):
    import torch

    dev = torch.device(device)
    data, graph = None, None
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        data, agent, _, _ = msgc_job.open_job(cfg, traffic, seed, device,
                                              twin_root, data=data)
        hooks = msgc_job.Hooks(agent, dev, dict(trace=False, seconds=0.0))
        msgc_job.cond_job.drive(agent, data, hooks, "window")
        cap, job = hooks.cap, msgc_job.job_state(agent)
        counted = msgc_job.counted_entries(spans.program_spans({}))
        hooks.unwrap()
        del agent, hooks
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = msgc_job.ReferenceSide(cfg, traffic, twin_root, device,
                                     job["triples"], job["batch"], graph)
        graph = ref.g
        nums = msgc_job.follow_captures(ref, cap, job, counted)
        rec = dict(seed=seed, kind="program", n_syn=job["n_syn"],
                   entries=ref.sk.entries,
                   seconds=time.perf_counter() - t0, **nums)
        emit(rec)
        out.append(rec)
        if i >= n_control:
            continue
        for kind, prec, fault in (("control", "tf32", None),
                                  ("half_batch", "fp32", "half_batch"),
                                  ("altered", "fp32", "altered")):
            nums = {}
            for name, epoch in sorted(msgc_job.STRETCHES.items()):
                states, samples = ref.inputs(cap, name)
                r = ref.follow(states, samples, epoch, prec, fault,
                               stepwise=False)
                base = ref.follow(r["states"], samples, epoch, "fp32")
                for k, v in check.stretch_numbers(
                        calibrate._as_program(r), base).items():
                    nums[k] = check.worst([nums.get(k, 0.0), v])
            rec = dict(seed=seed, kind=kind, n_syn=job["n_syn"], **nums)
            emit(rec)
            out.append(rec)
        del ref
        gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.benchmark(ROOT)
    cell = manifest.cell(bench, a.workload)
    cfg = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    seeds = [int(s) for s in a.seeds.split(",")]
    f = open(a.out, "a") if a.out else None

    def emit(rec):
        rec = dict(workload=a.workload, **rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if f:
            f.write(line + "\n")
            f.flush()

    calibrate_msgc(cfg, traffic, seeds, a.control, "cuda", emit=emit)
    if f:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
