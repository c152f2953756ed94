"""The 95th percentile of the outer step's time over the traced run's
unprofiled stretch, between CUDA events recorded at each step's start
(no synchronization in the stretch), in ms."""

from gsbench.arith import percentile

UNIT = "ms"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    ms = ctx.get("step_ms")
    if not ms:
        return None
    return percentile(ms, 95)
