"""Host seconds of the program's ``msgc.skeletons`` span in set-up: the
skeletons' host build in ``create_reducer`` (MSGC's constructor)."""

from gsbench.spans import setup_seconds

UNIT = "s"
LAYER = "MSGC generator: reduce/msgc.py"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "msgc.skeletons")
