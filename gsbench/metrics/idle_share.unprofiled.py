"""1 − the card's busy time a step (the profiled stretch's records) over
the mean period of the program's ``step`` spans before that stretch, in
%: an idle share the profiler's per-launch cost does not inflate, since
the card's busy time a step does not move with the host."""

from gsbench.spans import idle_share_unprofiled

UNIT = "%"
LAYER = "device"
MOVES = "setup_s"


def read(ctx):
    return idle_share_unprofiled(ctx)
