"""Host seconds of the program's ``data.graph`` span in set-up: the
graph's host build in ``load()`` (symmetrize, dedup, CSR, and the
inductive setting's induced subgraphs)."""

from gsbench.spans import setup_seconds

UNIT = "s"
LAYER = "data: data/loader.py, data/ingest.py, graph.py"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "data.graph")
