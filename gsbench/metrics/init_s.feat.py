"""Host seconds of the window job's ``msgc.init`` span: MSGC's init of
the synthetic features (the ``clustering`` reducer's per-class k-means,
whose own ``reduce`` span nests in it and opens no job)."""

from gsbench.spans import program_spans, window_steps

UNIT = "s"
LAYER = "MSGC generator: reduce/msgc.py"
MOVES = "setup_s"


def read(ctx):
    spans = program_spans(ctx)
    steps = window_steps(spans) if spans else []
    if not steps:
        return None
    got = [s for s in spans if s["name"] == "msgc.init"
           and s["job"] == steps[0]["job"]]
    if not got:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in got) / 1e9
