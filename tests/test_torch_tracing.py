"""The port's span recorder and counters (``profiling.span``/``count``)
and the spans the condensation engine opens (CPU).

* Spans nest: each records its parent, its job (the outermost open
  ``reduce``) and its outer step (the innermost open ``step``, numbered
  from 0 in its job); an exception closes a span and is marked on it.
* Step spans go in a ring of ``RING``; spans outside any step are kept.
* A counter adds into the innermost open span and the process total.
* Off, ``span`` returns one shared no-op and ``count`` records nothing.
* A GCond run on a synth twin gives every outer step the same span tree,
  and ``match.gathered_rows`` = C·B·Π(f+1) a step; its reduced graph is
  bit-equal with the recorder on and off.
* ``train_all --profile`` writes the spans as ``record_function`` ranges
  into its Chrome trace.
"""

import collections
import glob
import json

import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch import train_all as TA
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer

STEP_TREE = {
    "step": ["step.generator", "step.match", "step.backward",
             "step.optimizers", "step.inner"],
    "step.match": ["match.sample", "match.gather", "match.real",
                   "match.syn", "match.loss"],
    "step.inner": ["inner.adj", "inner.fit"],
}


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in place of the process's."""
    r = P.Recorder()
    monkeypatch.setattr(P, "RECORDER", r)
    return r


def _by_name(spans) -> dict:
    out = collections.defaultdict(list)
    for s in spans:
        out[s["name"]].append(s)
    return out


def test_spans_nest_with_parents_jobs_and_steps(rec):
    with P.span("data.load", dataset="x"):
        with P.span("data.read"):
            pass
    with P.span("reduce"):
        with P.span("job.init"):
            with P.span("reduce", method="Random"):   # nested: same job
                pass
        with P.span("epoch", epoch=0):
            for _ in range(2):
                with P.span("step"):
                    with P.span("step.match"):
                        with P.span("match.sample"):
                            pass
    with P.span("reduce"):
        with P.span("step"):
            pass
    by = _by_name(P.spans())
    load_, = by["data.load"]
    assert load_["parent"] is None and load_["job"] is None
    assert load_["attrs"] == {"dataset": "x"} and load_["step"] is None
    assert by["data.read"][0]["parent"] == load_["id"]
    outer, inner, second = by["reduce"]
    assert outer["job"] == inner["job"] != second["job"]
    assert inner["parent"] == by["job.init"][0]["id"]
    assert [s["step"] for s in by["step"]] == [0, 1, 0]
    assert [s["job"] for s in by["step"]] == [outer["job"]] * 2 \
        + [second["job"]]
    for k, s in enumerate(by["match.sample"]):
        assert s["step"] == k and s["job"] == outer["job"]
        match = next(m for m in by["step.match"] if m["id"] == s["parent"])
        assert next(t for t in by["step"]
                    if t["id"] == match["parent"])["step"] == k
    assert by["epoch"][0]["step"] is None
    ids = [s["id"] for s in P.spans()]
    assert ids == sorted(ids)
    for s in P.spans():
        assert s["start_ns"] <= s["end_ns"] and s["error"] is None


def test_an_exception_closes_and_marks_the_span(rec):
    class StopJob(Exception):
        pass

    with pytest.raises(StopJob):
        with P.span("reduce"):
            with P.span("step"):
                with P.span("step.generator"):
                    raise StopJob
    by = _by_name(P.spans())
    assert [by[n][0]["error"] for n in ("reduce", "step",
                                        "step.generator")] == ["StopJob"] * 3
    assert rec.stack == []
    with P.span("data.load"):
        pass
    assert _by_name(P.spans())["data.load"][0]["parent"] is None


def test_the_ring_is_bounded_and_set_up_spans_are_kept(rec):
    rec.ring = collections.deque(maxlen=8)
    with P.span("data.load"):
        pass
    with P.span("reduce"):
        for _ in range(10):
            with P.span("step"):
                with P.span("step.match"):
                    pass
    spans = P.spans()
    steps = [s for s in spans if s["step"] is not None]
    assert len(steps) == 8
    # the newest steps' spans stay (a span is stored as it closes)
    assert {s["step"] for s in steps} == {6, 7, 8, 9}
    assert {s["name"] for s in spans if s["step"] is None} == \
        {"data.load", "reduce"}
    assert P.RING == 65_536
    P.clear()
    assert P.spans() == [] and P.counters() == {}


def test_counters_add_into_the_innermost_span_and_the_total(rec):
    P.count("rows", 1)          # no span open: the total alone
    with P.span("step.match"):
        P.count("rows", 5)
        with P.span("match.gather"):
            P.count("rows", 7)
            P.count("bytes", 28)
            P.count("rows", 3)
    by = _by_name(P.spans())
    assert by["step.match"][0]["counts"] == {"rows": 5}
    assert by["match.gather"][0]["counts"] == {"rows": 10, "bytes": 28}
    assert P.counters() == {"rows": 16, "bytes": 28}


def test_off_the_recorder_returns_the_shared_no_op(rec):
    rec.enabled = False
    a, b = P.span("step"), P.span("reduce", method="GCond")
    assert a is b
    with a as s:
        s.set(built=True)
        P.count("rows", 5)
    assert np.isnan(s.seconds)
    assert P.spans() == [] and P.counters() == {}
    assert rec.stack == []
    rec.enabled = True
    with P.span("step") as s:
        pass
    assert isinstance(s, P.Span) and s.seconds >= 0


def _gcond(save_path, seed=0):
    data = load("synth-small", device="cpu")
    args = finalize(Args(dataset="synth-small", method="gcond", epochs=2,
                         seed=seed, device="cpu", save_path=str(save_path)),
                    explicit=set())
    args = args.replace(outer_loop=3, inner_loop=2, checkpoints=())
    return data, create_reducer("gcond", data, args)


def test_a_gcond_run_gives_each_step_the_engine_span_tree(rec, tmp_path):
    data, agent = _gcond(tmp_path)
    agent.reduce(data)
    spans = P.spans()
    by = _by_name(spans)
    ids = {s["id"]: s for s in spans}
    for name in ("data.load", "data.read", "data.graph", "data.views",
                 "engine.init", "engine.tables", "engine.pools",
                 "job.init"):
        assert len(by[name]) == 1, name
    assert [s["attrs"]["epoch"] for s in by["epoch"]] == [0, 1]
    steps = by["step"]
    assert [s["step"] for s in steps] == list(range(6))
    for st in steps:
        assert ids[st["parent"]]["name"] == "epoch"
        tree = collections.defaultdict(list)
        for s in spans:
            if s["step"] == st["step"] and s["job"] == st["job"] \
                    and s is not st:
                tree[ids[s["parent"]]["name"]].append(s["name"])
        assert dict(tree) == STEP_TREE
    C, B = len(agent.classes), agent.batch
    want = C * B * int(np.prod([f + 1 for f in agent.fanouts]))
    for g in by["match.gather"]:
        assert g["counts"]["match.gathered_rows"] == want
        assert g["counts"]["match.gathered_bytes"] == want * agent.d * 4
    for s in by["match.sample"]:
        assert s["counts"] == {"match.sampled_slots": want}
    assert P.counters()["match.gathered_rows"] == 6 * want


def test_tracing_changes_no_number(rec, tmp_path):
    out = []
    for on in (True, False):
        rec.enabled = on
        data, agent = _gcond(tmp_path, seed=3)
        red = agent.reduce(data)
        out.append((red.feat, red.adj, red.labels))
    assert P.spans()   # the first run recorded
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_train_all_profile_writes_the_spans_as_ranges(rec, tmp_path):
    args = finalize(Args(dataset="synth-small", method="gcond", epochs=1,
                         run_eval=1, eval_epochs=5, profile=True,
                         save_path=str(tmp_path), device="cpu"),
                    {"run_eval", "eval_epochs", "profile"})
    TA.run(args.replace(outer_loop=2, inner_loop=1, checkpoints=()))
    (path,) = glob.glob(str(tmp_path / "traces" / "gcond_synth-small"
                            / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"reduce", "job.init", "epoch", "step", "step.generator",
            "step.match", "match.gather", "step.backward",
            "step.optimizers", "inner.fit"} <= ranges
    # outside the trace no range is opened
    assert rec.ranges is False
