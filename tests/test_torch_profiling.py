"""The port's profiling utilities against the JAX package's (CPU).

* ``gcond_step_flops`` and ``a100_reference_ceiling_steps_per_s`` are the
  JAX package's arithmetic, equal at three shape sets (arxiv's included).
* ``Throughput``'s arithmetic and report equal the JAX meter's.  The
  departure is pinned: the JAX ``measure`` never blocks on the work it
  times (it reads the clock after dispatch), the port's synchronizes the
  card before both clock reads when its device is CUDA, and not on the
  CPU.
* ``trace`` on the CPU, and ``train_all --profile``, write a
  Chrome/TensorBoard trace (host operators alone) under the directory
  they are given; a disabled ``trace`` writes nothing.
"""

import glob
import json
import os
import time
from unittest import mock

import jax
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import profiling as JP
from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch import train_all as TA
from graphslim_tpu_torch.config import Args, finalize

SHAPES = [
    # the reference's arxiv bound (its padded and its deduplicated rows)
    dict(n_classes=40, batch=256, fanouts=(10, 5), nfeat=128, nhid=256,
         nclass=40, ntrans=2, n_syn=1354, pge_nhid=256, pge_nlayers=3),
    dict(n_classes=40, batch=256, fanouts=(10, 5), nfeat=128, nhid=256,
         nclass=40, ntrans=2, n_syn=909, pge_nhid=256, pge_nlayers=3,
         deep_rows=10_000),
    # flickr's paper config, one transformation
    dict(n_classes=7, batch=256, fanouts=(15, 8), nfeat=500, nhid=256,
         nclass=7, ntrans=1, n_syn=713, pge_nhid=256, pge_nlayers=2),
]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_gcond_step_flops_equal_jax(shape):
    kw = SHAPES[shape]
    assert P.gcond_step_flops(**kw) == JP.gcond_step_flops(**kw)


def test_a100_ceiling_equals_jax():
    assert P.a100_reference_ceiling_steps_per_s() == \
        JP.a100_reference_ceiling_steps_per_s()


@pytest.mark.parametrize("calls,elapsed", [(0, 0.0), (20, 0.0113),
                                           (3, 1.5)])
def test_throughput_arithmetic_equals_jax(calls, elapsed):
    mine, theirs = P.Throughput(4_608_619, device="cpu"), \
        JP.Throughput(4_608_619)
    for t in (mine, theirs):
        t.calls, t.elapsed = calls, elapsed
    assert mine.per_second == theirs.per_second
    assert mine.report() == theirs.report()


def test_measure_times_the_work_on_the_card_and_dispatch_in_jax():
    """The port synchronizes a CUDA device before both clock reads; the
    JAX meter never waits (it imports jax and reads the clock)."""
    with mock.patch.object(torch.cuda, "synchronize") as sync:
        t = P.Throughput(10, device="cuda")
        with t.measure():
            pass
        assert sync.call_count == 2
        cpu = P.Throughput(10, device="cpu")
        with cpu.measure():
            time.sleep(0.01)
        assert sync.call_count == 2
    assert (t.calls, cpu.calls) == (1, 1) and cpu.elapsed >= 0.01
    with mock.patch.object(jax, "block_until_ready") as block, \
            mock.patch.object(jax, "effects_barrier") as barrier:
        j = JP.Throughput(10)
        with j.measure():
            pass
    assert block.call_count == barrier.call_count == 0 and j.calls == 1


def _names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_host_trace_on_the_cpu(tmp_path):
    out = tmp_path / "traces"
    with P.trace(str(out), enabled=True, device="cpu"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    (path,) = glob.glob(str(out / "*.pt.trace.json"))
    assert "aten::mm" in _names(path)
    with P.trace(str(tmp_path / "off"), enabled=False, device="cpu"):
        pass
    with P.trace(None, device="cpu"):
        pass
    assert not os.path.exists(tmp_path / "off")


def test_train_all_profile_writes_a_trace_of_the_reduce(tmp_path):
    args = finalize(Args(dataset="synth-small", method="kcenter",
                         run_eval=1, eval_epochs=5, profile=True,
                         save_path=str(tmp_path), device="cpu"),
                    {"run_eval", "eval_epochs", "profile"})
    TA.run(args)
    (path,) = glob.glob(str(tmp_path / "traces" / "kcenter_synth-small"
                            / "*.pt.trace.json"))
    assert any(n and n.startswith("aten::") for n in _names(path))


def test_a_cpu_session_traces_the_host_and_needs_no_card():
    with mock.patch.object(torch.cuda, "synchronize",
                           side_effect=AssertionError("no card")):
        with P.session("cpu", host=False) as prof:
            torch.ones(3).add_(1)
    assert any(e.key == "aten::add_" for e in prof.key_averages())
