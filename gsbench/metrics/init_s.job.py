"""Host seconds of the program's ``job.init`` spans in set-up, the
warm-up job's and the window's: each job's start up to its first epoch
(the synthetic features' init, the PGE's, the optimizers')."""

from gsbench.spans import setup_seconds

UNIT = "s"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "job.init")
