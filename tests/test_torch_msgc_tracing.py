"""The spans and counters of the port's MSGC (CPU, synth-hard at r = 0.5:
50 synthetic nodes, a batch of B = 3 skeletons).

* ``msgc.skeletons`` is a set-up span outside any job, counting
  ``msgc.skeleton_entries`` = the triples' length;
* ``msgc.init`` sits in ``job.init`` and holds the init reducer's own
  ``reduce``, which opens no job of its own: the benchmark's readers
  (``gsbench/spans.py``) find the window's steps in the last job;
* every generator call (the step's ``step.generator`` and the inner
  loop's ``inner.adj``) has ``generator.score``, counting
  ``generator.scored_entries`` = the rows scored, then
  ``generator.scatter`` and ``generator.norm``.
"""

import collections
import sys

import pytest
import torch
from torch_shared import REPO
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from gsbench import spans as S  # noqa: E402

B, OUTER, EPOCHS = 3, 2, 2
GENERATOR = ["generator.score", "generator.scatter", "generator.norm"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two jobs of one reducer (a warm-up and a window, as the benchmark
    runs them) under a fresh recorder."""
    rec = P.Recorder()
    saved, P.RECORDER = P.RECORDER, rec
    try:
        common = dict(dataset="synth-hard", method="msgc",
                      save_path=str(tmp_path_factory.mktemp("msgc_spans")),
                      hidden=16, ntrans=2, outer_loop=OUTER, inner_loop=2,
                      epochs=EPOCHS, batch_adj=B, init="clustering")
        explicit = set(common) - {"dataset", "method", "save_path"}
        data = load("synth-hard", seed=0, device="cpu")
        args = finalize(Args(**common, device="cpu"), explicit)
        agent = create_reducer("msgc", data, args.replace(checkpoints=()))
        with torch.enable_grad():
            agent.reduce(data)
            agent.reduce(data)
        return agent, P.spans(), P.counters()
    finally:
        P.RECORDER = saved


def _by_name(spans) -> dict:
    out = collections.defaultdict(list)
    for s in spans:
        out[s["name"]].append(s)
    return out


def test_the_skeleton_build_is_a_setup_span_counting_its_triples(traced):
    agent, spans, counters = traced
    (sk,) = _by_name(spans)["msgc.skeletons"]
    assert sk["parent"] is None and sk["job"] is None
    assert sk["counts"] == {"msgc.skeleton_entries": agent.rows.shape[0]}
    assert counters["msgc.skeleton_entries"] == agent.rows.shape[0]
    assert sk["attrs"] == {"batch": B}


def test_the_init_nests_its_reducer_without_opening_a_job(traced):
    _, spans, _ = traced
    by_id = {s["id"]: s for s in spans}
    by = _by_name(spans)
    inits = by["msgc.init"]
    assert len(inits) == 2
    outer = [s for s in by["reduce"] if s["parent"] is None]
    assert [s["job"] for s in outer] == [0, 1]
    for init, job in zip(inits, outer):
        assert by_id[init["parent"]]["name"] == "job.init"
        assert init["job"] == job["job"] and init["step"] is None
        (inner,) = [s for s in by["reduce"] if s["parent"] == init["id"]]
        assert inner["job"] == job["job"]
        assert inner["attrs"] == {"method": "Cluster"}
    steps = S.window_steps(spans)
    assert len(steps) == OUTER * EPOCHS
    assert {s["job"] for s in steps} == {1}
    assert [s["step"] for s in steps] == list(range(OUTER * EPOCHS))


def test_every_generator_call_scores_scatters_and_normalizes(traced):
    agent, spans, counters = traced
    by_id = {s["id"]: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        if s["name"] in GENERATOR:
            kids[s["parent"]].append(s)
    callers = collections.Counter(by_id[p]["name"] for p in kids)
    # each outer step: the generator forward and the inner loop's no-grad
    # adjacency; each job's end: the reduced graph's adjacency
    assert callers == {"step.generator": 2 * OUTER * EPOCHS,
                       "inner.adj": 2 * OUTER * EPOCHS, "reduce": 2}
    E = agent.rows.shape[0]
    for parent, ss in kids.items():
        assert [s["name"] for s in ss] == GENERATOR
        assert ss[0]["counts"] == {"generator.scored_entries": E}
        assert not ss[1]["counts"] and not ss[2]["counts"]
    assert counters["generator.scored_entries"] == E * len(kids)
    # the benchmark's reader of it: both calls of a window step
    ctx = {"spans": spans}
    assert S.per_step_count(ctx, "generator.scored_entries") == 2 * E
