"""The numbers that decide ``correct``, and their limits.

The program's outer steps are followed by the reference
(:mod:`gsbench.reference`) from the program's own state at the start of
two stretches of three steps, as GCond's schedule has them: the first
three steps of the job (epoch 0: the PGE steps) and the first three of
epoch 10 (the features step).  The state at each start (the synthetic
features, the PGE's and the model's parameters) is the program's; the
start is judged on its own (:func:`start_violations`), as is every
sampled block the reference reads (:func:`gsbench.reference.judge_sample`).

The numbers, each the worse of the two stretches:

* ``loss_gap``: ``|L_prog − L_ref| / |L_ref|`` of each step's match
  loss, the worst step;
* ``grad_gap.<group>``: the first gradient each optimizer got (the
  stepped one's: the PGE's in epoch 0, the features' in epoch 10; and
  the inner loop's model's), per leaf ``|‖g_prog‖ − ‖g_ref‖| / max(‖g_ref‖,
  the median leaf's ‖g_ref‖)`` over the group's leaves, the worst leaf;
* ``change_gap.<group>``: each leaf's change over the three steps, the
  same gap of norms, the median leaf's over the group; ``step_gap.<group>``
  the same of the first step's change alone, which Adam's first,
  normalized step makes steady where the gradient is ill-conditioned
  (a cell compares it in the place of the three steps' there).  A leaf whose
  reference gradient is under a thousandth of the median leaf's is left
  out (the PGE's biases under BatchNorm move under Adam by round-off
  alone), and so is an element whose reference gradient is under a
  thousandth of its leaf's root mean square (Adam's first updates are
  near ``lr·sign(g)``, and rounding decides that sign).  A leaf that
  neither side moves reads 0, one that only the program moves reads
  infinity, and either counts beside the group's median.

The groups are ``feat`` (the synthetic features), ``pge`` (the
generator's leaves) and ``mp`` (the model's).  A cell's limits
(``gsbench/limits/<cell>.json``) give each number it compares a limit;
``PERF.md`` gives the readings each was set from, and those of a number
left uncompared because nothing the cell can get wrong reaches it.
"""

from __future__ import annotations

import math

import torch

NOUGHT = 1e-3        # a gradient under this share of the median leaf's
NOT_FINITE = 1e300   # printed for a number that is not finite
# an initial synthetic row is a train row of its class to this share of
# the row's norm: the port standardizes the features in float32 (column
# sums over 135 k rows), the reference in float64; distinct rows of a twin
# lie apart by a share of order one
START_TOL = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _group(name: str) -> str:
    return name.split(".")[0]


def worst(values) -> float:
    """The largest value; infinity where one is NaN, which ``max`` would
    pass over."""
    values = list(values)
    if any(v != v for v in values):
        return math.inf
    return max(values, default=0.0)


def _median(values: list) -> float:
    if any(v != v for v in values):
        return math.inf
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                     + v[len(v) // 2])


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap of norms over the leaves of ``ref`` (those in
    ``keep`` when given), each against ``max(its own reference norm, the
    median of its group's)``."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: _norm(ref[k]) for k in names}
    pn = {k: _norm(prog[k]) for k in names}
    med = {}
    for k in names:
        med.setdefault(_group(k), []).append(rn[k])
    med = {g: _median(v) for g, v in med.items()}
    gaps = {}
    for k in names:
        den = max(rn[k], med[_group(k)])
        if den == 0.0:
            gaps[k] = 0.0 if pn[k] == 0.0 else math.inf
        else:
            gaps[k] = abs(pn[k] - rn[k]) / den
    return gaps


def moved_leaves(ref_first: dict) -> set:
    """Leaves whose reference gradient is at least ``NOUGHT`` of their
    group's median leaf's."""
    rn = {k: _norm(v) for k, v in ref_first.items()}
    groups = {}
    for k, v in rn.items():
        groups.setdefault(_group(k), []).append(v)
    med = {g: _median(v) for g, v in groups.items()}
    return {k for k, v in rn.items() if v >= NOUGHT * med[_group(k)]}


def _by_group(gaps: dict, reduce) -> dict:
    groups = {}
    for k, v in gaps.items():
        groups.setdefault(_group(k), []).append(v)
    return {g: reduce(v) for g, v in groups.items()}


def stretch_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of one stretch.  ``prog`` holds ``losses``, ``first``
    (the optimizers' first gradients, named as the reference names them),
    ``change`` (every leaf's over the three steps) and ``step`` (over the
    first)."""
    loss = worst(abs(p - r) / abs(r)
                 for p, r in zip(prog["losses"], ref["losses"]))
    out = {"loss_gap": loss}
    grad = leaf_gaps(prog["first"], {k: ref["first"][k]
                                     for k in prog["first"]})
    out.update({f"grad_gap.{g}": v
                for g, v in _by_group(grad, worst).items()})
    for name, key in (("change_gap", "change"), ("step_gap", "step")):
        gaps = _change_gaps(prog[key], ref[key], ref["first"])
        out.update({f"{name}.{g}": v for g, v in gaps.items()})
    return out


def _change_gaps(prog_change: dict, ref_change: dict, ref_first: dict
                 ) -> dict:
    """Per group, the median moved leaf's gap of norms over its settled
    elements; a leaf that the reference holds still counts beside it."""
    p_set, r_set = _settled(prog_change, ref_change, ref_first)
    gaps = leaf_gaps(p_set, r_set, keep=moved_leaves(ref_first))
    moving = {k: v for k, v in gaps.items() if _norm(r_set[k]) > 0.0}
    still = {k: v for k, v in gaps.items() if _norm(r_set[k]) == 0.0}
    change = _by_group(moving, _median)
    for k, v in still.items():
        g = _group(k)
        change[g] = worst([change.get(g, 0.0), v])
    return change


def _settled(prog_change: dict, ref_change: dict, ref_first: dict) -> tuple:
    """The changes with the elements left out whose reference gradient at
    the first step is under ``NOUGHT`` of its leaf's root mean square:
    Adam moves those by about ``±lr`` on a sign that rounding decides."""
    p, r = {}, {}
    for k, v in ref_change.items():
        g = ref_first.get(k)
        if g is None:
            p[k], r[k] = prog_change[k], v
            continue
        rms = torch.sqrt((g.double() ** 2).mean())
        keep = g.double().abs() >= NOUGHT * rms
        p[k], r[k] = prog_change[k][keep], v[keep]
    return p, r


def start_violations(start: dict, pools_rows: list, labels_syn_prog,
                     labels_syn_ref, mp_starts: list, pge_start: dict
                     ) -> int:
    """Violations of the start: synthetic labels other than the class
    budgets give; a synthetic feature row that is no train row of its
    class (the ``random`` init), or two rows from one node; parameters
    outside their initialization (Glorot-uniform weights, zero biases,
    BatchNorm at scale 1 and shift 0)."""
    bad = 0
    if not torch.equal(labels_syn_prog.cpu(), labels_syn_ref.cpu()):
        bad += 1
        return bad
    feat = start["feat"]
    for c, rows in pools_rows:
        sel = labels_syn_ref == c
        x = feat[sel.to(feat.device)]
        d = torch.cdist(x.double(), rows.double())
        dmin, arg = d.min(1)
        scale = torch.linalg.vector_norm(rows.double(), dim=1)[arg]
        bad += int((dmin > START_TOL * scale.clamp(min=1.0)).sum())
        bad += int(x.shape[0] - torch.unique(arg).numel())
    for p in [pge_start] + mp_starts:
        bad += init_violations(p)
    return bad


def init_violations(flat: dict) -> int:
    bad = 0
    for name, t in flat.items():
        kind = name.split(".")[-1]
        if kind == "w":
            lim = math.sqrt(6.0 / (t.shape[0] + t.shape[-1]))
            bad += int((t.abs() > lim * (1 + 1e-6)).sum())
            if t.numel() >= 4096:
                sd = float(t.double().std())
                bad += int(not 0.95 < sd / (lim / math.sqrt(3)) < 1.05)
        elif kind in ("b", "bias"):
            bad += int((t != 0).sum())
        elif kind == "scale":
            bad += int((t != 1).sum())
    return bad


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): each number finite and at most
    its limit; one that is not finite, or that the run did not give,
    prints as ``NOT_FINITE``."""
    got = {k: numbers.get(k, math.inf) for k in limits}
    got = {k: v if math.isfinite(v) else NOT_FINITE for k, v in got.items()}
    ok = all(got[k] <= limits[k] for k in limits)
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    return ok, checks
