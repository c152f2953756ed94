"""Peaks of the card, and the least work of the counted operations.

Every count comes from shapes and is the least work the inputs need: each
input read once, each output written once, no operation counted twice.
A least time is the larger of two: the operations over the peak of the
precision they run in, and the bytes over the memory bandwidth.  A share
of the roofline is that least time over the measured time, so it cannot
pass 100 % unless the work is counted too high or the time leaves part of
it out.

Peaks: NVIDIA's data sheet for one H100 SXM (dense, at its 700 W limit):
989 TFLOP/s in bf16, 495 in TF32, 67 in float32 outside the tensor cores,
3.35 TB/s of HBM3.  The port keeps TF32 off, so its float32 products
count at 67 TFLOP/s.

The PGE pair MLP (``graphslim_tpu_torch/csrc/pge_kernels.cuh``) takes the
factorized first layer ``a = x·W₀ₐ`` and ``b = x·W₀ᵦ + b₀`` and scores the
n² pairs through ``L2`` hidden products of H × H in bf16.  Its forward is
``2·n²·H²·L2`` operations (the first layer is counted once per node, in
the projections, and only the later layers per pair).  Its backward is
twice that (dW and dX of each hidden product).  The backward's bytes are
its inputs, the cotangent ``dL/dA`` and its outputs.  The workspace of
pre-BatchNorm activations that this kernel design writes in the forward
and reads in the backward (1.9 GB at n = 1354) is not counted: it is a
choice of the design, which could recompute instead; counting it would
let a change of design move the yardstick.
"""

from __future__ import annotations

import math

PEAK = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_S = 3.35e12
F32 = 4


def least_s(flops: float, nbytes: float, precision: str) -> float:
    return max(flops / PEAK[precision], nbytes / HBM_BYTES_S)


def pge_param_floats(H: int, L2: int) -> int:
    """Floats of the parameters the pair kernels read: the hidden
    products' weights and biases, BatchNorm's scale and shift of every
    hidden layer, the last layer's weight."""
    return L2 * H * H + L2 * H + 2 * (L2 + 1) * H + H


def pge_fwd(n: int, H: int, L2: int) -> dict:
    flops = 2.0 * n * n * H * H * L2
    nbytes = F32 * (2 * n * H + pge_param_floats(H, L2) + n * n)
    return dict(flops=flops, bytes=nbytes, precision="bf16",
                least_s=least_s(flops, nbytes, "bf16"))


def pge_bwd(n: int, H: int, L2: int) -> dict:
    flops = 4.0 * n * n * H * H * L2
    p = pge_param_floats(H, L2)
    nbytes = F32 * ((2 * n * H + p + n * n) + (2 * n * H + p))
    return dict(flops=flops, bytes=nbytes, precision="bf16",
                least_s=least_s(flops, nbytes, "bf16"))


def trans_dims(d: int, hidden: int, ncls: int, ntrans: int) -> list:
    """Widths of the SGC's linear stack."""
    return [d] + [hidden] * (ntrans - 1) + [ncls]


def _mm(rows: int, dims: list, first: int = 0) -> float:
    """Operations of ``rows`` through the linear stack ``dims`` (its
    layers from ``first`` on)."""
    pairs = list(zip(dims[:-1], dims[1:]))[first:]
    return sum(2.0 * rows * a * b for a, b in pairs)


def level_sizes(batch: int, fanouts: list) -> list:
    """Rows of each level of a sampled block, targets first: each hop
    gives every row ``fanout`` sampled slots and its self slot."""
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * (f + 1))
    return sizes


def gcond_step(s: dict) -> list:
    """The counted operations of one GCond outer step with an SGC
    condense model: ``[(name, flops, bytes, precision)]``.

    ``s`` holds ``n`` (synthetic nodes), ``d`` (features), ``C`` (classes),
    ``batch`` (targets a class), ``fanouts`` (near to deep), ``hidden``,
    ``ncls``, ``ntrans``, ``nlayers`` (propagations), ``pge_h``, ``pge_l2``
    (hidden pair products) and ``inner_loop``.

    * The PGE: the projections (forward and backward), the forward and
      backward pair kernels, the elementwise squashing and normalization
      of the n × n adjacency (forward and backward, bytes only), and for
      the inner loop one forward without gradient.
    * The real side, per class: the sampled feature rows read once, the
      linear stack forward, its weights' gradients and the gradients of
      its inputs above the first layer, and the block aggregation on the
      class width forward and backward.
    * The synthetic side, per class: the stack and the propagations
      forward, the first backward (to the weights), and the nested
      gradient of the match loss, counted as one more first backward
      (a lower bound: it runs back through both).
    * The inner loop: per step the synthetic forward and first backward
      of one model.
    * Adam: parameter, gradient and both moments read, three written.
    """
    n, d, C = s["n"], s["d"], s["C"]
    ncls, K = s["ncls"], s["nlayers"]
    H, L2 = s["pge_h"], s["pge_l2"]
    dims = trans_dims(d, s["hidden"], ncls, s["ntrans"])
    sizes = level_sizes(s["batch"], s["fanouts"])
    R = sizes[-1]
    ops = []

    proj_f = 2.0 * 2 * n * d * H
    proj_b = F32 * (n * d + 2 * d * H + 2 * n * H)
    ops.append(("pge_proj", 3 * proj_f, 2 * proj_b, "fp32"))
    fw, bw = pge_fwd(n, H, L2), pge_bwd(n, H, L2)
    ops.append(("pge_fwd", fw["flops"], fw["bytes"], "bf16"))
    ops.append(("pge_bwd", bw["flops"], bw["bytes"], "bf16"))
    ops.append(("adj_post", 0.0, F32 * 8 * n * n, "fp32"))

    ops.append(("real_gather", 0.0, F32 * C * R * d, "fp32"))
    real = _mm(R, dims) + _mm(R, dims) + _mm(R, dims, first=1)
    ops.append(("real_trans", C * real, 0.0, "fp32"))
    agg = sum(2.0 * m * ncls for m in sizes[1:])
    ops.append(("real_agg", C * 2 * agg, 0.0, "fp32"))

    prop = K * 2.0 * n * n * ncls
    fwd = _mm(n, dims) + prop
    bwd1 = _mm(n, dims) + _mm(n, dims, first=1) + prop
    ops.append(("syn_grads", C * (fwd + 2 * bwd1), F32 * n * n, "fp32"))

    n_model = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    n_pge = 2 * d * H + H + pge_param_floats(H, L2) + 1
    adam = F32 * 7 * max(n_pge, n * d)
    if s["inner_loop"] > 0:
        ops.append(("inner_pge_proj", proj_f, proj_b, "fp32"))
        ops.append(("inner_pge_fwd", fw["flops"], fw["bytes"], "bf16"))
        ops.append(("inner_adj_post", 0.0, F32 * 4 * n * n, "fp32"))
        ops.append(("inner_steps", s["inner_loop"] * (fwd + bwd1),
                    0.0, "fp32"))
        adam += s["inner_loop"] * F32 * 7 * n_model
    ops.append(("adam", 0.0, adam, "fp32"))
    return ops


def step_least_s(s: dict) -> float:
    """Least seconds of one outer step: each counted operation's least
    time, summed."""
    return sum(least_s(f, b, p) for _, f, b, p in gcond_step(s))


def shape_of(cfg: dict, n_syn: int, n_classes: int) -> dict:
    """The step's shapes from a configuration, the synthetic size and the
    classes that have a budget."""
    e, t = cfg["engine"], cfg["twin"]
    return dict(n=n_syn, d=t["n_feat"], C=n_classes,
                batch=e["sample_batch"], fanouts=list(e["fanouts"]),
                hidden=e["hidden"], ncls=t["nclass"],
                ntrans=cfg["published"]["ntrans"], nlayers=e["nlayers"],
                pge_h=e["pge_nhid"], pge_l2=e["pge_nlayers"] - 2,
                inner_loop=cfg["published"]["inner_loop"])


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0–100) by linear interpolation between
    the closest ranks."""
    v = sorted(values)
    if not v:
        return math.nan
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
