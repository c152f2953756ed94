"""The PGE backward kernel's least time (``gsbench/arith.py::pge_bwd``:
the kept workspace not counted) over its mean device time a launch in
the profiled stretch, in %."""

from gsbench.metrics_common import roofline

UNIT = "%"
LAYER = "PGE: models/pge.py, kernels/pge.py, csrc/pge_kernels.cuh"
MOVES = "setup_s"


def read(ctx):
    return roofline(ctx, ("pge_bwd_kernel",), "pge_bwd_least_s")
