"""One run of an MSGC cell: set-up, the window, the check.

MSGC runs on the GCond engine with its own generator, so the run is
:mod:`gsbench.cond_job`'s: the user's entry
``create_reducer("msgc", dataset, args).reduce(dataset)`` with every key
of the configuration, its full epoch count from epoch 0 and no
checkpoint, seen through the same wrapped methods (``generator_forward``
opening every outer step, ``match_loss_total``, ``match_classes`` and the
three optimizers' ``step``; ``opt_pge`` steps the edge scorer).  Set-up
is the twin, ``load``, ``create_reducer`` (which builds the skeletons on
the host), one warm-up epoch, the peak reset and the timed job's init
(the ``clustering`` init) up to its first outer step.  What differs:

* the sizes checked are MSGC's: the skeletons' batch and the scorer's
  widths, which the configuration states;
* a traced run records a pair of CUDA events around each generator
  forward of its unprofiled stretch (``generator_ms``);
* the reference is :mod:`gsbench.reference_msgc`, which judges the
  program's skeletons alone by MSGC's link rule (``skeleton_invalid``,
  with the entries the program's ``msgc.skeleton_entries`` counter
  counted, where the program has the counter) and then follows the
  program's two stretches on them, A in epoch 0 (the scorer steps) and
  B in epoch 10 (the features), as the GCond reference does; the
  scorer's numbers are those of the group ``pge``, the generator's.

The program's own names the run reads: the reducer's ``rows``, ``cols``,
``batches`` (the skeletons' triples), ``batch_size`` and ``pge.dims``
(the scorer's widths), besides those of :mod:`gsbench.cond_job`.
"""

from __future__ import annotations

import gc
import os
import time

from gsbench import check, cond_job, reference_msgc as RM, twins
from gsbench import spans as S
from gsbench import reference as R

STRETCHES = cond_job.STRETCHES
FEATURE_EPOCH = cond_job.FEATURE_EPOCH


class Hooks(cond_job.Hooks):
    """:class:`gsbench.cond_job.Hooks`, with CUDA events around each
    generator forward of a traced run's unprofiled stretch, recorded
    inside the step, after its boundary."""

    def __init__(self, agent, device, plan: dict):
        super().__init__(agent, device, plan)
        self.gen_inner = self.orig["generator_forward"]
        self.orig["generator_forward"] = self._timed_generator
        self.gen_events = []

    def unwrap(self) -> None:
        self.orig["generator_forward"] = self.gen_inner
        super().unwrap()

    def _timed_generator(self, pge_params, feat_syn):
        if not (self.mode == "window" and self.plan["trace"]
                and self.stretch == "events"
                and self.device.type == "cuda"):
            return self.gen_inner(pge_params, feat_syn)
        import torch

        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.gen_inner(pge_params, feat_syn)
        b.record()
        self.gen_events.append((a, b))
        return out


def _check_sizes(agent, cfg: dict) -> None:
    e, d = cfg["engine"], cfg["twin"]["n_feat"]
    got = dict(fanouts=list(agent.fanouts), sample_batch=agent.batch,
               batch_adj=agent.batch_size,
               scorer_dims=list(agent.pge.dims))
    want = {k: e[k] for k in ("fanouts", "sample_batch", "batch_adj")}
    want["scorer_dims"] = [2 * d, e["scorer_hidden"], e["scorer_hidden"], 1]
    if got != want:
        raise RuntimeError(f"the engine built {got}, the configuration "
                           f"states {want}")


def open_job(cfg: dict, traffic: dict, seed: int, device: str,
             twin_root: str = twins.CACHE, data=None) -> tuple:
    """(dataset, reducer, load seconds, synthesis seconds), as
    :func:`gsbench.cond_job.open_job` gives them for GCond."""
    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.reduce import create_reducer

    if cfg["published"]["outer_loop"] < 4:
        raise ValueError("the check follows three outer steps of one "
                         "epoch and the state at the fourth's start: "
                         "outer_loop must be 4 or more")
    data_dir, synth_s = twins.twin_file(cfg["twin"], twin_root)
    t0 = time.perf_counter()
    args = cond_job.build_args(cfg, traffic, seed, data_dir,
                               os.path.join(twin_root, "out"), device)
    args = args.replace(batch_adj=cfg["engine"]["batch_adj"])
    if data is None:
        data = load(cfg["dataset"], setting=cfg["setting"],
                    data_dir=data_dir, device=device)
    agent = create_reducer(cfg["method"], data, args)
    load_s = time.perf_counter() - t0
    _check_sizes(agent, cfg)
    return data, agent, load_s, synth_s


def counted_entries(spans):
    """The entries the program's last skeleton build counted, or None."""
    for s in reversed(spans or []):
        if s["name"] == "msgc.skeletons":
            return (s["counts"] or {}).get("msgc.skeleton_entries")
    return None


def job_state(agent) -> dict:
    """What the check reads of the reducer once its window job is done."""
    return dict(n_syn=agent.n_syn, classes=list(agent.classes),
                labels_syn=agent.labels_syn.detach().clone(),
                triples=(agent.rows, agent.cols, agent.batches),
                batch=agent.batch_size)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, limits: dict,
        twin_root: str = twins.CACHE) -> dict:
    """One run; returns the run's record (see :func:`gsbench.run.main`).
    ``limits`` are the cell's (``gsbench/limits/<cell>.json``)."""
    import torch

    dev = torch.device(device)
    data, agent, load_s, synth_s = open_job(cfg, traffic, seed, device,
                                            twin_root)
    plan = dict(trace=trace)
    hooks = Hooks(agent, dev, plan)
    cond_job.drive(agent, data, hooks, "warmup")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    plan["seconds"] = seconds
    finished = cond_job.drive(agent, data, hooks, "window")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if finished and not hooks.closed:
        hooks.steps_done = hooks.k + 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    job = job_state(agent)
    losses = torch.stack(hooks.losses)
    steps = hooks.steps_done if not trace else len(losses)
    failed = int((~torch.isfinite(losses[:steps])).sum())
    ctx = dict(setup_s=hooks.t0 - t_start, load_s=load_s, synth_s=synth_s,
               peak_bytes=peak, steps=steps, trace=trace,
               generator_shape=dict(n=job["n_syn"], d=cfg["twin"]["n_feat"],
                                    H=cfg["engine"]["scorer_hidden"],
                                    B=job["batch"]))
    spans = S.program_spans(ctx)
    if trace:
        ctx.update(_traced(hooks))
    cap = hooks.cap
    hooks.unwrap()
    del agent, hooks, data, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = ReferenceSide(cfg, traffic, twin_root, device, job["triples"],
                        job["batch"])
    numbers = follow_captures(ref, cap, job, counted_entries(spans))
    numbers["nonfinite_steps"] = failed
    correct, checks = check.judge(numbers, limits)
    return dict(correct=correct, attempted=steps, failed=failed, ctx=ctx,
                checks=checks, n_syn=job["n_syn"])


def _traced(hooks: Hooks) -> dict:
    """What the traced stretches give the per-layer readers."""
    out = {}
    ev = hooks.events
    if len(ev) >= 2:
        out["step_ms"] = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    if hooks.gen_events:
        out["generator_ms"] = [a.elapsed_time(b)
                               for a, b in hooks.gen_events]
    if hooks.win is not None and hooks.win.t1_ns is not None:
        w = hooks.win
        out["kernels"] = w.kernels()
        out["stretch_ns"] = (w.t0_ns, w.t1_ns)
        out["prof_steps"] = hooks.prof_k1 - hooks.prof_k0
        out["phases"] = hooks.phases
    return out


class ReferenceSide:
    """The reference's graph, labels, pools and skeletons for one
    configuration and traffic mix: the graph from the twin's raw file,
    the skeletons the program built, judged alone; ``graph`` reuses a
    real graph built already."""

    def __init__(self, cfg: dict, traffic: dict, twin_root: str, device,
                 triples: tuple, batch: int, graph=None):
        import torch

        if graph is None:
            arrays = twins.read_twin(cfg["twin"], twin_root)
            graph = R.RealGraph(arrays, cfg["setting"], device)
            del arrays
        self.g = graph
        nclass = cfg["twin"]["nclass"]
        self.n_syn = RM.n_syn_of(len(self.g.pool_labels),
                                 traffic["reduction_rate"], nclass)
        y = RM.proportional_labels(self.g.pool_labels, self.n_syn, nclass)
        self.y = torch.as_tensor(y, device=self.g.device)
        self.classes = sorted(int(c) for c in set(y.tolist()))
        self.budgets = {c: int((y == c).sum()) for c in self.classes}
        self.pools = R.class_pools(self.g, self.classes)
        self.batch = batch
        self.skeleton_bad = RM.judge_skeletons(*triples, y, nclass, batch)
        self.sk = RM.Skeletons(*triples, self.n_syn, batch, self.g.device)
        e, pub = cfg["engine"], cfg["published"]
        self.rcfg = dict(nlayers=e["nlayers"], batch=e["sample_batch"],
                         lr=e["lr"], lr_adj=pub["lr_adj"],
                         lr_feat=pub["lr_feat"],
                         inner_loop=pub["inner_loop"])
        self.pool_rows = [
            (c, self.g.feat[torch.as_tensor(p, device=self.g.device)])
            for c, p in zip(self.classes, self.pools)]

    def inputs(self, cap: dict, name: str) -> tuple:
        """(the program's states at the start of steps 0 to 3, with the
        generator's leaves as ``scorer``, its sampled blocks of steps 0
        to 2) of a captured stretch, on the reference's device."""
        c = cap[name]
        keys = ("start", "at1", "at2", "at3")
        if any(k not in c or "mp" not in c[k] for k in keys) \
                or len(c["samples"]) < 3:
            raise RuntimeError(f"stretch {name} was not captured")
        dev = self.g.device
        states = [{"feat": c[k]["feat"].to(dev),
                   "scorer": {n: v.to(dev) for n, v in c[k]["pge"].items()},
                   "mp": {n: v.to(dev) for n, v in c[k]["mp"].items()}}
                  for k in keys]
        samples = [{k: (tuple(x.to(dev) for x in v)
                        if isinstance(v, tuple) else v.to(dev))
                    for k, v in s.items()} for s in c["samples"]]
        return states, samples

    def follow(self, states, samples, epoch: int, precision: str,
               fault=None, stepwise: bool = True) -> dict:
        """The reference over a stretch: step by step from ``states``, or
        (``stepwise`` False) its own three steps from ``states[0]``."""
        prec = R.Precision(precision, self.g.device)
        r = RM.follow(self.g, self.pools, self.rcfg, prec, states[0],
                      samples, self.y, self.sk, self.classes, self.budgets,
                      epoch, fault, states=states if stepwise else None)
        return dict(r, **{k: _pge_named(r[k])
                          for k in ("first", "given", "change", "step")})


def _pge_named(leaves: dict) -> dict:
    """The scorer's leaves named as the harness names every generator's
    (``pge.<leaf>``: the group ``pge`` of the check's numbers)."""
    return {f"pge.{k[7:]}" if k.startswith("scorer.") else k: v
            for k, v in leaves.items()}


def follow_captures(ref: ReferenceSide, cap: dict, job: dict,
                    counted) -> dict:
    """The numbers of the correctness check: the skeletons' and the
    start's violations, and the reference's readings of both captured
    stretches against the program's, each number the worse stretch's."""
    import torch

    out = dict(sample_invalid=0, start_invalid=0,
               skeleton_invalid=ref.skeleton_bad)
    if counted is not None and counted != ref.sk.entries:
        out["skeleton_invalid"] += 1
    if job["classes"] != ref.classes or job["n_syn"] != ref.n_syn:
        out["start_invalid"] += 1
    if out["start_invalid"] or out["skeleton_invalid"]:
        # nothing to follow: the numbers left out read as failed
        return out
    feat0 = None
    for name, epoch in sorted(STRETCHES.items(), key=lambda kv: kv[1]):
        states, samples = ref.inputs(cap, name)
        start = states[0]
        # the features are the init's until the first feature epoch; the
        # scorer is at its initialization at epoch 0 only
        if feat0 is None:
            feat0 = start["feat"]
            out["start_invalid"] += RM.start_violations(
                feat0, job["labels_syn"], ref.y, ref.batch, ref.pool_rows)
        elif epoch <= FEATURE_EPOCH and not torch.equal(start["feat"],
                                                         feat0):
            out["start_invalid"] += 1
        out["start_invalid"] += check.init_violations(start["mp"])
        if epoch == 0:
            out["start_invalid"] += check.init_violations(start["scorer"])
        r = ref.follow(states, samples, epoch, "fp32")
        out["sample_invalid"] += r["bad"]
        prog = cond_job.program_side(cap[name], dict(start,
                                                     pge=start["scorer"]))
        nums = check.stretch_numbers(prog, r)
        for k, v in nums.items():
            out[k] = check.worst([out.get(k, 0.0), v])
    return out
