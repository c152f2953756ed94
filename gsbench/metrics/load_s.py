"""Host seconds of ``load()`` (the twin's file read, its views on the
card) and ``create_reducer`` (budgets, pools, the sampler's tables)."""

UNIT = "s"
LAYER = "data: data/loader.py, data/ingest.py, graph.py"
MOVES = "setup_s"


def read(ctx):
    return ctx["load_s"]
