"""Device idle ms a profiled step while the host was in ``step.backward``:
the autograd backward of the step's loss, the nested backward and the
PGE backward kernel. Each idle gap of the profiled stretch goes to the
step phase open on the host at its midpoint."""

from gsbench.spans import idle_ms

UNIT = "ms"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    return idle_ms(ctx, "step.backward")
