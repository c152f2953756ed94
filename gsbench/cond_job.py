"""One run of a condensation cell: set-up, the window, the check.

The window drives the user's entry of the port,
``graphslim_tpu_torch.reduce.create_reducer(method, dataset,
args).reduce(dataset)``, as a user's job starts it: the configuration's
arguments, its full epoch count, from epoch 0, no checkpoint
evaluations.  The harness sees the job through the engine's public
methods, wrapped on the one reducer object from these files:

* ``generator_forward`` opens every outer step: the step's start, where
  the window closes and the job is ended by :class:`StopJob`;
* ``match_loss_total`` returns the step's match loss; ``match_classes``
  receives the step's sampled blocks;
* ``opt_pge.step``, ``opt_feat.step`` and ``opt_model.step`` receive the
  gradients each optimizer gets (their state is not read).

The port keeps a step's state (the features, the PGE's and the model's
leaves, the optimizers' moments) in locals of its epoch loop and offers
no public observer of a step, so the harness reads the state where it
passes through these methods.

Set-up: the twin (written once per checkout by :mod:`gsbench.twins`),
``load`` through the port's file reader, ``create_reducer``, one epoch of
the job at the cell's own shapes, the peak memory reset, and the timed
job's own start (its synthetic init and the PGE's) up to its first outer
step, where the window opens, synchronized.  The window measures
``seconds`` of the job's steps; with ``trace`` it measures per-layer
numbers instead: a stretch with a CUDA event at each step's start, then
whole epochs under the profiler (:mod:`gsbench.window`).  The job then
runs on, untimed, until the reference's stretches are captured, and the
reference follows them once the program's state is freed.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time

from gsbench import arith, check, reference, twins, window

FEATURE_EPOCH = 10           # GCond: epoch % 50 < 10 steps the PGE
# the check's stretches (gsbench/check.py): the first three steps of epoch
# 0, where the PGE steps, and of the first epoch that steps the features;
# each starts an epoch, where the model's optimizer starts afresh, and the
# optimizer it steps has not stepped before, so every optimizer the
# reference follows starts fresh
STRETCHES = {"A": 0, "B": FEATURE_EPOCH}
PROFILED_STEPS = 40          # at least this many steps under the profiler


class StopJob(Exception):
    """Ends the job at a step's start."""


def _flat(tree, prefix="") -> dict:
    """Named leaves of a parameter tree: ``layers.0.w``, ``bns.1.scale``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _clone(flat: dict) -> dict:
    return {k: v.detach().clone() for k, v in flat.items()}


def build_args(cfg: dict, traffic: dict, seed: int, data_dir: str,
               save_path: str, device: str):
    """The port's ``Args`` as the configuration states them: every key
    explicit, so the port's own method table changes none."""
    from graphslim_tpu_torch.config import Args, finalize

    pub, eng = cfg["published"], cfg["engine"]
    keys = dict(pub)
    keys.update(hidden=eng["hidden"], nlayers=eng["nlayers"], lr=eng["lr"],
                init=eng["init"])
    args = Args(dataset=cfg["dataset"], method=cfg["method"],
                reduction_rate=traffic["reduction_rate"], seed=seed,
                device=device, load_path=data_dir, save_path=save_path,
                **keys)
    args = finalize(args, explicit=set(keys) | {"reduction_rate"})
    return args.replace(checkpoints=tuple(eng["checkpoints"]))


class Hooks:
    """The wrapped methods of one engine and what they saw."""

    def __init__(self, agent, device, plan: dict):
        self.agent, self.device, self.plan = agent, device, plan
        self.outer = agent.args.outer_loop
        self.starts = {epoch * self.outer: name
                       for name, epoch in STRETCHES.items()}
        self.done_at = max(self.starts) + 4
        self.mode = "off"
        self.orig = {}
        for name in ("generator_forward", "match_loss_total",
                     "match_classes"):
            self.orig[name] = getattr(agent, name)
            setattr(agent, name, getattr(self, "_" + name))
        for opt in ("opt_pge", "opt_feat", "opt_model"):
            o = getattr(agent, opt)
            self.orig[opt] = o.step
            o.step = self._opt_step(opt, o.step)

    def unwrap(self) -> None:
        for name in ("generator_forward", "match_loss_total",
                     "match_classes"):
            setattr(self.agent, name, self.orig[name])
        for opt in ("opt_pge", "opt_feat", "opt_model"):
            getattr(self.agent, opt).step = self.orig[opt]

    # ------------------------------------------------------------------
    def arm(self, mode: str) -> None:
        self.mode = mode
        self.k = -1
        self.losses = []
        self.cap = {name: {"samples": [], "losses": [], "first": {}}
                    for name in self.starts.values()}
        self.events, self.phases = [], []
        self.win = None
        self.closed = False
        self.steps_done = None
        self.stretch = "events"
        self.prof = None

    def _triple(self, k: int):
        """(stretch, position) of step ``k`` in a captured stretch."""
        for s, name in self.starts.items():
            if s <= k <= s + 3:
                return name, k - s
        return None, None

    def _mark(self, label: str) -> None:
        if self.prof is not None:
            self.phases.append((time.time_ns(), label))

    def _generator_forward(self, pge_params, feat_syn):
        self.k += 1
        k = self.k
        if self.mode == "warmup" and k == self.outer:
            raise StopJob
        if self.mode == "window":
            self._boundary(k)
            name, pos = self._triple(k)
            if name is not None:
                c = self.cap[name]
                state = {"feat": feat_syn.detach().clone(),
                         "pge": _clone(_flat(pge_params))}
                c["start" if pos == 0 else f"at{pos}"] = state
        self._mark("generator_forward")
        return self.orig["generator_forward"](pge_params, feat_syn)

    def _match_loss_total(self, model_params, feat_syn, adj, gen):
        self._mark("match_loss_total")
        loss = self.orig["match_loss_total"](model_params, feat_syn, adj,
                                             gen)
        if self.mode == "window":
            self.losses.append(loss.detach())
            name, pos = self._triple(self.k)
            if name is not None:
                c = self.cap[name]
                key = "start" if pos == 0 else f"at{pos}"
                c[key]["mp"] = _clone(_flat(model_params))
                if pos < 3:
                    c["losses"].append(loss.detach().clone())
        self._mark("backward, optimizers, inner loop"
                   + (", next epoch's start"
                      if (self.k + 1) % self.outer == 0 else ""))
        return loss

    def _match_classes(self, model_params, feat_syn, adj, feat_deep, ids,
                       ws, targets, valid, masks, coeffs):
        if self.mode == "window":
            name, pos = self._triple(self.k)
            if name is not None and pos < 3:
                self.cap[name]["samples"].append(dict(
                    ids=tuple(x.clone() for x in ids),
                    ws=tuple(w.clone() for w in ws),
                    targets=targets.clone(), valid=valid.clone()))
        return self.orig["match_classes"](model_params, feat_syn, adj,
                                          feat_deep, ids, ws, targets,
                                          valid, masks, coeffs)

    def _opt_step(self, opt: str, fn):
        group = {"opt_pge": "pge", "opt_feat": "feat",
                 "opt_model": "mp"}[opt]

        def step(params, grads, state, *a, **kw):
            if self.mode == "window":
                name, pos = self._triple(self.k)
                first = self.cap[name]["first"] if name else None
                if pos == 0 and not any(k.split(".")[0] == group
                                        for k in first):
                    first.update(self._named(group, params, grads))
            return fn(params, grads, state, *a, **kw)
        return step

    def _named(self, group: str, params: list, grads: list) -> dict:
        """The first gradients an optimizer got, by leaf name: the engine
        hands the PGE's and the model's leaves in tree order."""
        if group == "feat":
            return {"feat": grads[0].detach().clone()}
        if group == "mp":
            return {f"mp.{i}": g.detach().clone()
                    for i, g in enumerate(grads)}
        name, _ = self._triple(self.k)
        names = list(self.cap[name]["start"]["pge"])
        return {f"pge.{n}": g.detach().clone()
                for n, g in zip(names, grads)}

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _boundary(self, k: int) -> None:
        """At the start of step ``k`` of the window: close the window, or
        move between the traced run's stretches, or end the job."""
        import torch

        plan = self.plan
        if k == 0:
            # the window opens at the job's first outer step: what the job
            # does before it (its init) is set-up, as the warm-up is
            self._sync()
            self.t0 = time.perf_counter()
            plan.update(deadline=self.t0 + plan["seconds"],
                        half=self.t0 + plan["seconds"] / 2)
        now = time.perf_counter()
        if not plan["trace"]:
            if not self.closed and now >= plan["deadline"]:
                self.steps_done = k
                self.closed = True
        else:
            if self.stretch == "events":
                if self.device.type == "cuda":
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.events.append(ev)
                if now >= plan["half"] and k >= 20 and k % self.outer == 0:
                    self.stretch = "profiled"
                    self.prof_k0 = k
                    self.prof_steps = self.outer * math.ceil(
                        PROFILED_STEPS / self.outer)
                    self.launches0 = _pge_launches()
                    if self.device.type == "cuda":
                        self.win = window.Window(self.device)
                        self.win.open()
                        self.prof = self.win
            elif self.stretch == "profiled":
                if k >= self.prof_k0 + self.prof_steps:
                    if self.win is not None:
                        self.win.close()
                    self.launches = {k: v - self.launches0[k] for k, v in
                                     _pge_launches().items()}
                    self.prof = None
                    self.prof_k1 = k
                    self.stretch = "after"
                    self.closed = True
        if self.closed and k >= self.done_at:
            raise StopJob


def _pge_launches() -> dict:
    """The port's own counters of PGE kernel launches."""
    from graphslim_tpu_torch.kernels import pge

    return dict(pge.LAUNCHES)


def _check_sizes(agent, cfg: dict) -> None:
    e = cfg["engine"]
    got = dict(fanouts=list(agent.fanouts), sample_batch=agent.batch,
               pge_nhid=agent.pge.cfg.nhid,
               pge_nlayers=agent.pge.cfg.nlayers)
    want = {k: e[k] for k in got}
    if got != want:
        raise RuntimeError(f"the engine built {got}, the configuration "
                           f"states {want}")


def open_job(cfg: dict, traffic: dict, seed: int, device: str,
             twin_root: str = twins.CACHE, data=None) -> tuple:
    """(dataset, reducer, load seconds, synthesis seconds): the twin's
    file (written here in a checkout's first run), ``load`` through the
    port's file reader, and ``create_reducer``, timed on the host clock;
    ``data`` reuses a dataset already loaded."""
    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.reduce import create_reducer

    if cfg["published"]["outer_loop"] < 4:
        raise ValueError("the check follows three outer steps of one "
                         "epoch and the state at the fourth's start: "
                         "outer_loop must be 4 or more")
    data_dir, synth_s = twins.twin_file(cfg["twin"], twin_root)
    t0 = time.perf_counter()
    args = build_args(cfg, traffic, seed, data_dir,
                      os.path.join(twin_root, "out"), device)
    if data is None:
        data = load(cfg["dataset"], setting=cfg["setting"],
                    data_dir=data_dir, device=device)
    agent = create_reducer(cfg["method"], data, args)
    load_s = time.perf_counter() - t0
    _check_sizes(agent, cfg)
    return data, agent, load_s, synth_s


def drive(agent, data, hooks: Hooks, mode: str) -> bool:
    """One ``reduce`` under the hooks; True when the job ran to its end
    rather than being ended at a step's start."""
    hooks.arm(mode)
    try:
        agent.reduce(data)
        return True
    except StopJob:
        return False


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
    drive(agent, data, hooks, "warmup")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    plan["seconds"] = seconds
    finished = drive(agent, data, hooks, "window")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if finished and not hooks.closed:
        hooks.steps_done = hooks.k + 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    n_syn, classes = agent.n_syn, list(agent.classes)
    labels_syn = agent.labels_syn.detach().clone()
    losses = torch.stack(hooks.losses)
    steps = hooks.steps_done if not trace else len(losses)
    failed = int((~torch.isfinite(losses[:steps])).sum())
    shape = arith.shape_of(cfg, n_syn, len(classes))
    t0 = hooks.t0
    ctx = dict(setup_s=t0 - t_start, load_s=load_s, synth_s=synth_s,
               peak_bytes=peak, steps=steps, trace=trace)
    if trace:
        ctx.update(_traced(hooks, shape))
    cap = hooks.cap
    hooks.unwrap()
    del agent, hooks, data, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = ReferenceSide(cfg, traffic, twin_root, device)
    numbers = follow_captures(ref, cap, labels_syn, classes)
    numbers["nonfinite_steps"] = failed
    correct, checks = check.judge(numbers, limits)
    return dict(correct=correct, attempted=steps, failed=failed, ctx=ctx,
                checks=checks, n_syn=n_syn)


def _traced(hooks: Hooks, shape: dict) -> dict:
    """What the traced stretches give the per-layer readers."""
    out = dict(least_step_s=arith.step_least_s(shape),
               pge_fwd_least_s=arith.pge_fwd(
                   shape["n"], shape["pge_h"], shape["pge_l2"])["least_s"],
               pge_bwd_least_s=arith.pge_bwd(
                   shape["n"], shape["pge_h"], shape["pge_l2"])["least_s"])
    ev = hooks.events
    if len(ev) >= 2:
        out["step_ms"] = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    if hooks.win is not None and hooks.win.t1_ns is not None:
        w = hooks.win
        out["kernels"] = w.kernels()
        out["stretch_ns"] = (w.t0_ns, w.t1_ns)
        out["prof_steps"] = hooks.prof_k1 - hooks.prof_k0
        out["phases"] = hooks.phases
        # a window whose trace lost records reads short against the
        # port's launch counters (gsbench/window.py)
        traced = {"fwd": sum(1 for n, _, _ in out["kernels"]
                             if "pge_fwd" in n),
                  "bwd": sum(1 for n, _, _ in out["kernels"]
                             if "pge_bwd" in n)}
        counted = {"fwd": hooks.launches["pge_fwd_ws"]
                   + hooks.launches["pge_fwd_nows"],
                   "bwd": hooks.launches["pge_bwd"]}
        if traced != counted:
            print(f"profiled stretch short: the trace holds {traced} PGE "
                  f"records against {counted} launches counted",
                  file=sys.stderr)
    return out


class ReferenceSide:
    """The reference's graph, budgets and pools for one configuration and
    traffic mix, built from the twin's raw file."""

    def __init__(self, cfg: dict, traffic: dict, twin_root: str, device):
        import torch

        arrays = twins.read_twin(cfg["twin"], twin_root)
        self.g = reference.RealGraph(arrays, cfg["setting"], device)
        del arrays
        self.classes, self.budgets, labels = reference.class_budgets(
            self.g.pool_labels, traffic["reduction_rate"])
        self.labels = torch.as_tensor(labels, device=self.g.device)
        self.pools = reference.class_pools(self.g, self.classes)
        e, pub = cfg["engine"], cfg["published"]
        self.rcfg = dict(nlayers=e["nlayers"], batch=e["sample_batch"],
                         lr=e["lr"], lr_adj=pub["lr_adj"],
                         lr_feat=pub["lr_feat"],
                         inner_loop=pub["inner_loop"])
        self.pool_rows = [
            (c, self.g.feat[torch.as_tensor(p, device=self.g.device)])
            for c, p in zip(self.classes, self.pools)]

    def inputs(self, cap: dict, name: str) -> tuple:
        """(the program's states at the start of steps 0 to 3, its sampled
        blocks of steps 0 to 2) of a captured stretch, on the reference's
        device."""
        c = cap[name]
        keys = ("start", "at1", "at2", "at3")
        if any(k not in c or "mp" not in c[k] for k in keys) \
                or len(c["samples"]) < 3:
            raise RuntimeError(f"stretch {name} was not captured")
        dev = self.g.device
        states = [{"feat": c[k]["feat"].to(dev),
                   "pge": {n: v.to(dev) for n, v in c[k]["pge"].items()},
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
        prec = reference.Precision(precision, self.g.device)
        return reference.follow(self.g, self.pools, self.rcfg, prec,
                                states[0], samples, self.labels,
                                self.classes, self.budgets, epoch, fault,
                                states=states if stepwise else None)


def follow_captures(ref: ReferenceSide, cap: dict, labels_syn,
                    classes) -> dict:
    """The numbers of the correctness check: the reference's readings of
    both captured stretches against the program's, each number the worse
    stretch's."""
    import torch

    out = dict(sample_invalid=0, start_invalid=0)
    if list(classes) != ref.classes:
        out["start_invalid"] += 1
    feat0 = None
    for name, epoch in sorted(STRETCHES.items(), key=lambda kv: kv[1]):
        states, samples = ref.inputs(cap, name)
        start = states[0]
        # the features are the init's rows until the first feature epoch;
        # the generator is at its initialization at epoch 0 only
        out["start_invalid"] += check.start_violations(
            start, ref.pool_rows if feat0 is None else [], labels_syn,
            ref.labels, [start["mp"]], start["pge"] if epoch == 0 else {})
        if feat0 is None:
            feat0 = start["feat"]
        elif epoch <= FEATURE_EPOCH and not torch.equal(start["feat"],
                                                         feat0):
            out["start_invalid"] += 1
        r = ref.follow(states, samples, epoch, "fp32")
        out["sample_invalid"] += r["bad"]
        nums = check.stretch_numbers(program_side(cap[name], start), r)
        for k, v in nums.items():
            out[k] = check.worst([out.get(k, 0.0), v])
    return out


def program_side(c: dict, start: dict) -> dict:
    """The program's losses, first gradients and change of every leaf over
    the three steps and over the first, named as the reference names
    them."""
    dev = start["feat"].device

    def change(end):
        out = {"feat": end["feat"].to(dev) - start["feat"]}
        out.update({f"pge.{k}": end["pge"][k].to(dev) - v
                    for k, v in start["pge"].items()})
        out.update({f"mp.{k}": end["mp"][k].to(dev) - v
                    for k, v in start["mp"].items()})
        return out

    first = {}
    mnames = list(start["mp"])
    for k, v in c["first"].items():
        if k.startswith("mp."):
            first[f"mp.{mnames[int(k[3:])]}"] = v.to(dev)
        else:
            first[k] = v.to(dev)
    return dict(losses=[float(x) for x in c["losses"]], first=first,
                change=change(c["at3"]), step=change(c["at1"]))
