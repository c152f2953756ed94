"""Device time a step outside the PGE's kernels over the profiled
stretch: sampling, gathers, the class-batched passes, the match loss,
Adam and the inner loop, in ms."""

from gsbench.metrics_common import is_pge

UNIT = "ms"
LAYER = "matching engine: reduce/cond_base.py, kernels/sample.py"
MOVES = "setup_s"


def read(ctx):
    k = ctx.get("kernels")
    if not k or not ctx.get("prof_steps"):
        return None
    s = sum(b - a for name, a, b in k if not is_pge(name))
    return s / 1e6 / ctx["prof_steps"]
