"""Feature rows the matching engine gathers a window step
(``match.gathered_rows``): C·B·Π(f+1) from the sampled blocks' shapes."""

from gsbench.spans import per_step_count

UNIT = "rows"
LAYER = "matching engine: reduce/cond_base.py, kernels/sample.py"
MOVES = "setup_s"


def read(ctx):
    return per_step_count(ctx, "match.gathered_rows")
