"""Device idle ms a profiled step while the host was in
``step.optimizers``: the Adam steps of the PGE or the features. Each
idle gap of the profiled stretch goes to the step phase open on the host
at its midpoint."""

from gsbench.spans import idle_ms

UNIT = "ms"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    return idle_ms(ctx, "step.optimizers")
