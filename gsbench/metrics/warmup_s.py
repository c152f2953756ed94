"""Host seconds of the program's ``epoch`` spans of the warm-up job: its
one whole epoch, and the start of the next, which the harness ends."""

from gsbench.spans import setup_seconds

UNIT = "s"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "epoch", before_job=True)
