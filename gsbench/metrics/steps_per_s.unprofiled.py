"""Outer steps per second over the traced run's unprofiled stretch,
between the CUDA events recorded at each step's start.  The step rate is
no end-to-end metric: the host's dispatch paces these steps on a shared
host, so the rate moves with the host from run to run.  A faster step
shortens ``setup_s`` through its warm-up epoch, which the step readers
name as what they move."""

UNIT = "steps/s"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    ms = ctx.get("step_ms")
    if not ms:
        return None
    return len(ms) / (sum(ms) / 1e3)
