"""Host seconds of the program's ``engine.init`` span in set-up: the
condensation engine's construction in ``create_reducer`` (budgets, the
sampler's tables, the class pools, the model, the PGE, the optimizers)."""

from gsbench.spans import setup_seconds

UNIT = "s"
LAYER = "matching engine: reduce/cond_base.py, kernels/sample.py"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "engine.init")
