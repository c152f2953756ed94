"""The PGE forward kernel's least time (``gsbench/arith.py::pge_fwd``)
over its mean device time a launch in the profiled stretch, both kinds
of launch (keeping the workspace and not), in %."""

from gsbench.metrics_common import roofline

UNIT = "%"
LAYER = "PGE: models/pge.py, kernels/pge.py, csrc/pge_kernels.cuh"
MOVES = "setup_s"


def read(ctx):
    return roofline(ctx, ("pge_fwd_kernel", "pge_fwd_simt_kernel"),
                    "pge_fwd_least_s")
