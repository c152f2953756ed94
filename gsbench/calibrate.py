"""Readings that set a cell's correctness limits, at the cell's own size.

    python3 gsbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --control 3 [--out chiprun_out/calibrate_<cell>.jsonl]

For each seed, one job of the cell runs through the same hooks as a
benchmark run, ended once both of the check's stretches are captured (no
timed window), and the reference's numbers against the program's are
printed: the lower readings.  For the first ``--control`` seeds, besides:
the control (the reference computed in TF32, put in the program's place,
against the reference in float32) and two planted faults, each in the
reference put in the program's place: ``half_batch`` (the second half of
each class's targets left out, the mean taken over the rest) and
``altered`` (one pair of the generated adjacency changed where the PGE
produces it).  Each number is the worse of the two stretches.  A state
left unchanged reads 1 as the ``change_gap`` of the group it holds
still and needs no run.  One dataset serves every seed.  A benchmark run never
runs this.
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

from gsbench import check, cond_job, manifest, twins  # noqa: E402


def _as_program(r: dict) -> dict:
    """A reference run in the program's place: its losses, the gradients
    its optimizers got, each leaf's change over its own three steps and
    over the first."""
    return dict(losses=r["losses"], first=r["given"], change=r["change"],
                step=r["step"])


def calibrate(cfg: dict, traffic: dict, seeds: list, n_control: int,
              device: str, twin_root: str = twins.CACHE, emit=print):
    import torch

    dev = torch.device(device)
    data, ref = None, None
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        data, agent, _, _ = cond_job.open_job(cfg, traffic, seed, device,
                                              twin_root, data=data)
        hooks = cond_job.Hooks(agent, dev, dict(trace=False, seconds=0.0))
        cond_job.drive(agent, data, hooks, "window")
        cap, classes = hooks.cap, list(agent.classes)
        labels_syn = agent.labels_syn.detach().clone()
        n_syn = agent.n_syn
        hooks.unwrap()
        del agent, hooks
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if ref is None:
            ref = cond_job.ReferenceSide(cfg, traffic, twin_root, device)
        nums = cond_job.follow_captures(ref, cap, labels_syn, classes)
        rec = dict(seed=seed, kind="program", n_syn=n_syn,
                   seconds=time.perf_counter() - t0, **nums)
        emit(rec)
        out.append(rec)
        if i >= n_control:
            continue
        for kind, prec, fault in (("control", "tf32", None),
                                  ("half_batch", "fp32", "half_batch"),
                                  ("altered", "fp32", "altered")):
            nums = {}
            for name, epoch in sorted(cond_job.STRETCHES.items()):
                states, samples = ref.inputs(cap, name)
                r = ref.follow(states, samples, epoch, prec, fault,
                               stepwise=False)
                base = ref.follow(r["states"], samples, epoch, "fp32")
                for k, v in check.stretch_numbers(_as_program(r),
                                                  base).items():
                    nums[k] = check.worst([nums.get(k, 0.0), v])
            rec = dict(seed=seed, kind=kind, n_syn=n_syn, **nums)
            emit(rec)
            out.append(rec)
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

    calibrate(cfg, traffic, seeds, a.control, "cuda", emit=emit)
    if f:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
