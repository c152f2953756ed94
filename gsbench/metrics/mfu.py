"""The outer step's share of the card's peak: the least time of the
step's counted work (``gsbench/arith.py::gcond_step``: for each
operation the larger of its operations over the peak of its precision and
its bytes over HBM bandwidth) over the mean step time of the traced run's
unprofiled stretch (CUDA events at each step's start), in %."""

UNIT = "%"
LAYER = "condensation step: reduce/gcond.py"
MOVES = "setup_s"


def read(ctx):
    ms = ctx.get("step_ms")
    if not ms:
        return None
    return 100.0 * ctx["least_step_s"] / (sum(ms) / len(ms) / 1e3)
