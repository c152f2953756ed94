"""``setup_s`` less the union of the program's spans before the window's
first step (each instant once, each span clipped there): the imports,
the twin's file, the harness's own work and whatever no span covers."""

from gsbench.spans import setup_unspanned

UNIT = "s"
LAYER = "process: imports, the twin file, the harness"
MOVES = "setup_s"


def read(ctx):
    return setup_unspanned(ctx)
