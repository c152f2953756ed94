"""Skeleton entries the edge scorer scores a window step
(``generator.scored_entries``): the generator forward's and the inner
loop's no-grad forward's, every entry of every skeleton each."""

from gsbench.spans import per_step_count

UNIT = "entries"
LAYER = "MSGC generator: reduce/msgc.py"
MOVES = "setup_s"


def read(ctx):
    return per_step_count(ctx, "generator.scored_entries")
