"""The MSGC cell's driver on the CPU at a tiny size (``msgc_arxiv`` with
the tiny twin of :mod:`gsbench_tiny`: 10 synthetic nodes, 4 classes, 16
skeletons): the program as it is passes its check; each planted fault
and the control fail it; the new readers return numbers from a run and
None without the program's spans.

The faults, each planted in the timed path under a whole run: every
optimizer's step returning its state unchanged, or the scorer's, the
features' or the model's alone; half of each class's batch left out of
the real loss; one skeleton entry's score altered where the scorer
gives it; one link of the skeletons moved to another node.  The control
is the reference computed in TF32 in the program's place."""

import tempfile
import time

import pytest
import torch

from gsbench_tiny import tiny
from gsbench import arith_msgc, calibrate_msgc, check, manifest, msgc_job
from test_gsbench_check import _frozen, _half_batch, _unchanged

CELL = "msgc_arxiv.r0.01"
READERS = ("skeletons_s", "init_s.feat", "generator_ms",
           "generator_roofline", "scored_entries_per_step")


@pytest.fixture(scope="module")
def twin_root():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(root, seed=7):
    cfg, traffic = tiny("msgc_arxiv")
    return msgc_job.run(cfg, traffic, seed, 0.2, False, "cpu",
                        time.perf_counter(), manifest.limits(CELL),
                        twin_root=root)


def test_the_program_as_it_is_passes(twin_root):
    rec = _run(twin_root)
    assert rec["correct"], rec["checks"]
    assert rec["checks"]["skeleton_invalid"]["value"] == 0


def _altered(monkeypatch):
    from graphslim_tpu_torch.reduce.msgc import EdgeScorer
    orig = EdgeScorer.scores

    def scores(self, params, feat):
        s = orig(self, params, feat)
        flip = torch.zeros_like(s)
        flip[self.last[0]] = 1.0
        return s + flip * (1.0 - 2.0 * s.detach())
    monkeypatch.setattr(EdgeScorer, "scores", scores)


def _relinked(monkeypatch):
    from graphslim_tpu_torch.reduce import msgc
    orig = msgc.build_skeletons

    def build(*a, **k):
        rows, cols, batches = (x.copy() for x in orig(*a, **k))
        cols[2] = rows[3] = cols[0]
        return rows, cols, batches
    monkeypatch.setattr(msgc, "build_skeletons", build)


@pytest.mark.parametrize(
    "fault", [_unchanged, _frozen("opt_pge"), _frozen("opt_feat"),
              _frozen("opt_model"), _half_batch, _altered, _relinked],
    ids=["unchanged", "scorer_unchanged", "feat_unchanged",
         "model_unchanged", "half_batch", "altered", "relinked"])
def test_each_fault_fails_the_check(fault, twin_root, monkeypatch):
    fault(monkeypatch)
    rec = _run(twin_root)
    assert not rec["correct"], rec["checks"]


def test_the_control_fails_the_check(twin_root):
    cfg, traffic = tiny("msgc_arxiv")
    limits = manifest.limits(CELL)
    recs = calibrate_msgc.calibrate_msgc(cfg, traffic, [11], 1, "cpu",
                                         twin_root=twin_root,
                                         emit=lambda r: None)
    kinds = {r["kind"]: r for r in recs}
    zero = dict(sample_invalid=0, start_invalid=0, skeleton_invalid=0,
                nonfinite_steps=0)
    assert check.judge(dict(kinds["program"], nonfinite_steps=0),
                       limits)[0]
    for kind in ("control", "half_batch", "altered"):
        ok, checks = check.judge({**kinds[kind], **zero}, limits)
        assert not ok, (kind, checks)


def _read(name, ctx):
    return manifest.reader(name).read(ctx)


def test_every_new_reader_reads_a_run(twin_root):
    rec = _run(twin_root)
    ctx = dict(rec["ctx"], generator_ms=[5.0, 7.0])
    values = {m: _read(m, ctx) for m in READERS}
    assert all(isinstance(v, float) and v > 0 for v in values.values()), \
        values
    cfg, _ = tiny("msgc_arxiv")
    E = next(s["counts"]["msgc.skeleton_entries"] for s in ctx["spans"]
             if s["name"] == "msgc.skeletons")
    assert values["scored_entries_per_step"] == 2 * E
    assert values["generator_ms"] == 6.0
    least = arith_msgc.generator_fwd(E, **ctx["generator_shape"])
    assert values["generator_roofline"] == pytest.approx(
        100 * least["least_s"] / 6e-3)
    assert ctx["generator_shape"] == dict(n=rec["n_syn"],
                                          d=cfg["twin"]["n_feat"], H=256,
                                          B=16)


def test_the_new_readers_read_nothing_without_spans(twin_root,
                                                   monkeypatch):
    """A program without the spans (a fresh recorder, off, as a program
    before them): the run is judged all the same, and each reader of a
    span returns None; ``generator_ms`` is the harness's own events."""
    from graphslim_tpu_torch import profiling
    off = profiling.Recorder()
    off.enabled = False
    monkeypatch.setattr(profiling, "RECORDER", off)
    rec = _run(twin_root)
    assert rec["correct"], rec["checks"]
    ctx = dict(rec["ctx"], generator_ms=[5.0])
    for m in ("skeletons_s", "init_s.feat", "generator_roofline",
              "scored_entries_per_step"):
        assert _read(m, ctx) is None, m
    assert _read("generator_ms", ctx) == 5.0
    for m in READERS:
        assert _read(m, dict(ctx, spans=None, generator_ms=None)) is None


def test_the_arithmetic_counts_the_scorer():
    w = arith_msgc.generator_fwd(1000, 10, 4, 8, 2)
    assert w["flops"] == 2.0 * 1000 * (2 * 4 * 8 + 8 * 8 + 8)
    params = (2 * 4 * 8 + 8) + (8 * 8 + 8) + (8 + 1) + 2 * 2 * 8
    assert w["bytes"] == 4 * (10 * 4 + params + 2 * 10 * 10) + 4 * 2 * 1000
    assert arith_msgc.scorer_param_floats(4, 8) == params
