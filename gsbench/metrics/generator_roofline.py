"""The generator forward's least time (``gsbench/arith_msgc.py``, with
the entries a call scored from the program's ``generator.scored_entries``
counter) over its mean device time (``generator_ms``), in %."""

from gsbench.arith_msgc import generator_fwd
from gsbench.spans import program_spans, window_steps

UNIT = "%"
LAYER = "MSGC generator: reduce/msgc.py"
MOVES = "setup_s"


def entries_per_call(ctx):
    """The entries one generator call of the window job scored."""
    spans = program_spans(ctx)
    steps = window_steps(spans) if spans else []
    if not steps:
        return None
    for s in spans:
        if s["name"] == "generator.score" and s["job"] == steps[0]["job"] \
                and "generator.scored_entries" in (s["counts"] or {}):
            return s["counts"]["generator.scored_entries"]
    return None


def read(ctx):
    ms, shape = ctx.get("generator_ms"), ctx.get("generator_shape")
    E = entries_per_call(ctx)
    if not ms or not shape or not E:
        return None
    least = generator_fwd(E, **shape)["least_s"]
    return 100.0 * least / (sum(ms) / len(ms) / 1e3)
