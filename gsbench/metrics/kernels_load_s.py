"""Host seconds of the program's ``kernels.load`` spans in set-up: the
CUDA libraries' load, and their nvcc build where the checkout had none
(well above 0 then).  The PGE's library loads at the warm-up's first
step, so this time also sits inside ``warmup_s``."""

from gsbench.spans import setup_seconds

UNIT = "s"
LAYER = "kernels: kernels/build.py"
MOVES = "setup_s"


def read(ctx):
    return setup_seconds(ctx, "kernels.load")
