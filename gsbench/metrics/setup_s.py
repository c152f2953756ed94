"""Seconds from the process's start to the window's start: imports, the
twin (synthesized in a checkout's first run only), ``load``,
``create_reducer``, the kernels' build where there is none, one warm-up
epoch, and the timed job's start up to its first outer step."""

UNIT = "s"
LAYER = None
MOVES = None


def read(ctx):
    return ctx["setup_s"]
