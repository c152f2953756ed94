"""The span recorder's clock against the card's trace, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest -s
tests/test_torch_tracing_cuda.py -m cuda`` (``-s`` shows the margins
measured between the two clocks).

* In the port's device-only window (``profiling.session(host=False)``), a
  span that synchronizes, launches a ``torch.cuda._sleep`` kernel and
  synchronizes again holds that kernel's record: the profiler maps the
  card's timestamps onto the spans' clock (``time.time_ns``), so an idle
  gap can be put down to the span open on the host.  The sleeps are
  spread over about a second, where the window's later records would
  drift.
* Such a window around GCond's outer steps, with the recorder on, holds
  as many PGE kernel records as ``kernels/pge.py::LAUNCHES`` counted.
"""

import time

import pytest
import torch
from torch.autograd import DeviceType

from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import pge as K
from graphslim_tpu_torch.reduce import create_reducer

pytestmark = pytest.mark.cuda

SLEEPS = 10
SLEEP_CYCLES = 2_000_000      # about 1 ms on an H100
HOST_GAP_S = 0.1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert P.RECORDER.enabled
    return torch.device("cuda")


def _device_records(prof) -> list:
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA),
                  key=lambda r: r[1])


def test_each_kernel_lies_inside_the_span_that_waited_on_it(card):
    opened = []
    with P.session(card, host=False) as prof:
        for i in range(SLEEPS):
            torch.cuda.synchronize()
            with P.span("sleep", i=i) as s:
                torch.cuda._sleep(SLEEP_CYCLES)
                torch.cuda.synchronize()
            opened.append(s)
            time.sleep(HOST_GAP_S)
    spins = [r for r in _device_records(prof) if P.PREAMBLE_KERNEL in r[0]]
    mine = spins[-SLEEPS:]        # the preamble's spins come first
    assert len(mine) == SLEEPS
    lead, lag = [], []
    for s, (_, a, b) in zip(opened, mine):
        lead.append(a - s.start_ns)
        lag.append(s.end_ns - b)
    print(f"\nkernel start - span start: {min(lead) / 1e3:.1f} to "
          f"{max(lead) / 1e3:.1f} us; span end - kernel end: "
          f"{min(lag) / 1e3:.1f} to {max(lag) / 1e3:.1f} us; kernels "
          f"{min(b - a for _, a, b in mine) / 1e3:.1f} us or more; "
          f"window {(opened[-1].end_ns - opened[0].start_ns) / 1e9:.3f} s")
    assert min(lead) >= 0 and min(lag) >= 0


def test_a_window_of_gcond_steps_holds_every_pge_launch(card, tmp_path):
    ds = load("synth-hard", seed=0, device="cuda")
    args = finalize(Args(dataset="synth-hard", method="gcond", epochs=1,
                         outer_loop=4, save_path=str(tmp_path),
                         device="cuda"), {"epochs", "outer_loop"})
    eng = create_reducer("gcond", ds, args.replace(checkpoints=()))
    eng.reduce(ds)                # the kernels' build and first launches
    torch.cuda.synchronize()
    K.reset_launches()
    P.clear()
    with P.session(card, host=False) as prof:
        eng.reduce(ds)
    recs = _device_records(prof)
    traced = {"fwd": sum("pge_fwd" in n for n, _, _ in recs),
              "bwd": sum("pge_bwd" in n for n, _, _ in recs)}
    counted = {"fwd": K.LAUNCHES["pge_fwd_ws"] + K.LAUNCHES["pge_fwd_nows"],
               "bwd": K.LAUNCHES["pge_bwd"]}
    assert counted["bwd"] == 4 and traced == counted
    steps = [s for s in P.spans() if s["name"] == "step"]
    assert len(steps) == 4
    # no step's PGE backward can start before its step opened
    bwd = [a for n, a, _ in recs if "pge_bwd" in n]
    for s, a in zip(steps, bwd):
        assert a >= s["start_ns"]
