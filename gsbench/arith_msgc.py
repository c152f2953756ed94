"""The least work of MSGC's generator forward (``reduce/msgc.py``,
``EdgeScorer.apply``), at the peaks of :mod:`gsbench.arith`.

The scorer takes ``[x_r | x_c]`` of each of the ``E`` skeleton entries
(width ``2d``) through Linear(2d → H), Linear(H → H) and Linear(H → 1),
with BatchNorm and ReLU after the two hidden ones, in float32 with TF32
off: ``2·E·(2d·H + H² + H)`` operations at the float32 peak outside the
tensor cores (BatchNorm, ReLU, sigmoid and the scatter are elementwise
and not counted).  The least bytes are the inputs read once and the
output written once: the synthetic features, the scorer's parameters,
each entry's row and column index (4 bytes each), and the dense
``[B, n, n]`` batch written.  The ``[E, 2d]`` rows gathered and the
``[E, H]`` activations are intermediates of this design, which a fused
generator need not write, so they are not counted.
"""

from __future__ import annotations

from gsbench.arith import F32, least_s

INDEX = 4


def scorer_param_floats(d: int, H: int) -> int:
    """The three linears' weights and biases and both BatchNorms' scale
    and shift."""
    return 2 * d * H + H + H * H + H + H + 1 + 4 * H


def generator_fwd(E: int, n: int, d: int, H: int, B: int) -> dict:
    flops = 2.0 * E * (2 * d * H + H * H + H)
    nbytes = (F32 * (n * d + scorer_param_floats(d, H) + B * n * n)
              + INDEX * 2 * E)
    return dict(flops=flops, bytes=nbytes, precision="fp32",
                least_s=least_s(flops, nbytes, "fp32"))
