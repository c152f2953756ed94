"""The share of the profiled stretch's wall time in which no operation
ran on the device (the preamble's spins left out), in %."""

from gsbench.window import busy_ns

UNIT = "%"
LAYER = "device"
MOVES = "setup_s"


def read(ctx):
    k = ctx.get("kernels")
    if not k:
        return None
    t0, t1 = ctx["stretch_ns"]
    return 100.0 * (1.0 - busy_ns(k) / (t1 - t0))
