"""MSGC's edge scorer as hand-written CUDA kernels, with its plain version.

MSGC scores each of the ``E`` skeleton entries ``(r, c)`` with a shared MLP
(``reduce/msgc.py``, ``EdgeScorer``)::

    h0 = [x_r | x_c]                      [E, 2d]
    z1 = h0 W1 + b1,  a1 = relu(BN1(z1))  [E, H]
    z2 = a1 W2 + b2,  a2 = relu(BN2(z2))  [E, H]
    s  = sigmoid(a2 w3 + b3)              [E]

with BatchNorm over all ``E`` entries (duplicates included; biased
variance, eps 1e-5).  ``csrc/edge_scorer.cu`` computes it, forward and
backward, in float32 on the CUDA cores.  It replaces no TPU kernel: the
JAX package's scorer is plain JAX.  It exists because the tensor-op
version materializes the gathered rows and about eleven [E, H]
intermediates as separate passes and keeps them for the backward
(11.2 GiB at the MSGC arxiv cell, E about 1.025 M, H 256); the kernels
write two, ``z1`` and ``z2``, and keep ``z2`` alone for the backward,
which recomputes ``z1`` (the gather product) first.  The forward's two
products,
``2·E·(2d·H + H²)`` operations, bound it by operations at the float32
peak; the source's note says how the passes fold into them.

The backward mirrors that split: BN2's sums in one pass over ``z2``,
``dz2`` formed where the products read it, BN1's sums in the epilogue of
``dz2 W2ᵀ`` (whose masked output overwrites ``z2``), and the first
layer's gradients from per-node segment sums of ``dz1`` over the entries'
rows and columns (``[2n, H]``), which give ``dW1 = [Xᵀ S_r; Xᵀ S_c]``
and ``dX = S_r W1[:d]ᵀ + S_c W1[d:]ᵀ`` exactly.  Every statistic and sum
is combined in a fixed order, so runs are bit-equal.

:func:`edge_scores` takes the kernels for a CUDA tensor and the plain
version (:class:`ScorerPlain`, an explicit backward in tensor ops with
the kernels' formulas) for a CPU one; a CUDA tensor never falls back.
The library is built with ``nvcc`` at first use.  ``LAUNCHES`` counts
the forward and backward chains launched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from graphslim_tpu_torch.kernels.build import load_library

EPS = 1e-5
H_MAX = 256   # the widest hidden layer: a block of dz2·W2ᵀ owns whole rows

LAUNCHES = {"edge_scorer_fwd": 0, "edge_scorer_bwd": 0}

_LIB = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Entries:
    """The skeleton entries' endpoints on one device: ``rows`` and
    ``cols`` (int64, the plain version's indices), and what the kernels
    read: their int32 copies and the per-node segments, ``seg_perm`` [2E]
    listing the entries of row node 0, 1, …, then of column node 0, 1, …,
    and ``seg_ptr`` [2n + 1] the offsets."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n: int, device):
        self.n, self.E = n, int(rows.shape[0])
        self.rows = torch.as_tensor(np.asarray(rows, np.int64), device=device)
        self.cols = torch.as_tensor(np.asarray(cols, np.int64), device=device)
        self.rows32, self.cols32 = (self.rows.to(torch.int32),
                                    self.cols.to(torch.int32))
        self.seg_ptr, self.seg_perm = segments(self.rows, self.cols, n)


def segments(rows: torch.Tensor, cols: torch.Tensor, n: int) -> tuple:
    """(ptr [2n + 1], perm [2E]) int32: the entries of each row node, then
    of each column node, in the entries' order within a node."""
    perm = torch.cat([torch.sort(rows, stable=True).indices,
                      torch.sort(cols, stable=True).indices])
    counts = torch.cat([torch.bincount(rows, minlength=n),
                        torch.bincount(cols, minlength=n)])
    ptr = torch.zeros(2 * n + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32), perm.to(torch.int32)


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.es_forward.argtypes = [ptr] * 18 + [i32] * 4 + [ptr]
    lib.es_forward.restype = i32
    lib.es_backward.argtypes = [ptr] * 30 + [i32] * 5 + [ptr]
    lib.es_backward.restype = i32
    lib.es_smem_bytes.argtypes = []
    lib.es_smem_bytes.restype = i32
    lib.es_fwd_scratch_bytes.argtypes = [i32, i32]
    lib.es_fwd_scratch_bytes.restype = i64
    lib.es_bwd_scratch_bytes.argtypes = [i32] * 4
    lib.es_bwd_scratch_bytes.restype = i64
    return lib


def build() -> ctypes.CDLL:
    """Compile the kernels (once per source version) and load them;
    ``BUILD_INFO`` records the library's path, build seconds and nvcc's
    ``-Xptxas -v`` report."""
    global _LIB
    if _LIB is None:
        lib, info = load_library("edge_scorer")
        BUILD_INFO.update(info)
        _LIB = bind(lib)
    return _LIB


def _smem_bytes(lib) -> int:
    """Dynamic shared memory of every product launch."""
    return lib.es_smem_bytes()


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(entries: Entries, params: tuple) -> tuple:
    feat, W1, b1, W2, b2, w3, b3, g1, be1, g2, be2 = params
    n, d = feat.shape
    H = W2.shape[0]
    shapes = dict(feat=(n, d), W1=(2 * d, H), b1=(H,), W2=(H, H), b2=(H,),
                  w3=(H, 1), b3=(1,), g1=(H,), be1=(H,), g2=(H,), be2=(H,))
    for (name, shape), t in zip(shapes.items(), params):
        if t.device != feat.device:
            raise ValueError(f"{name} is on {t.device}, feat on {feat.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n != entries.n or entries.E < 1:
        raise ValueError(f"the entries index {entries.n} nodes, the features "
                         f"{n} rows; E = {entries.E}")
    if H > H_MAX:
        raise ValueError(f"the edge scorer kernels take hidden widths up to "
                         f"{H_MAX}, got {H}")
    return entries.E, n, d, H


def forward_on(lib, stream: int, entries: Entries, params: tuple) -> tuple:
    """Launch the forward chain on ``lib`` → (scores [E], z1, z2, st)."""
    feat, W1, b1, W2, b2, w3, b3, g1, be1, g2, be2 = params
    E, n, d = entries.E, feat.shape[0], feat.shape[1]
    H = W2.shape[0]
    f32 = dict(dtype=torch.float32, device=feat.device)
    z1, z2 = torch.empty(E, H, **f32), torch.empty(E, H, **f32)
    st, scores = torch.empty(4, H, **f32), torch.empty(E, **f32)
    scratch = torch.empty(lib.es_fwd_scratch_bytes(E, H), dtype=torch.uint8,
                          device=feat.device)
    rc = lib.es_forward(_p(feat), _p(entries.rows32), _p(entries.cols32),
                        _p(W1), _p(b1),
                        _p(W2), _p(b2), _p(w3), _p(b3), _p(g1), _p(be1),
                        _p(g2), _p(be2), _p(z1), _p(z2), _p(st), _p(scores),
                        _p(scratch), E, d, H, _smem_bytes(lib), stream)
    if rc != 0:
        raise RuntimeError(f"edge scorer forward launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["edge_scorer_fwd"] += 1
    return scores, z1, z2, st


def backward_on(lib, stream: int, entries: Entries, saved: tuple,
                gs: torch.Tensor) -> tuple:
    """Launch the backward chain on ``lib`` for the score gradient ``gs``
    → (dfeat, dW1, db1, dW2, db2, dw3, db3, dg1, dbe1, dg2, dbe2).  It
    recomputes z1 into a buffer of its own; the saved ``z2`` is
    overwritten."""
    feat, W1, b1, W2, w3, g1, be1, g2, be2, z2, st, s = saved
    E, n, d = entries.E, feat.shape[0], feat.shape[1]
    H = W2.shape[0]
    f32 = dict(dtype=torch.float32, device=feat.device)
    z1 = torch.empty(E, H, **f32)
    grads = (torch.empty(n, d, **f32), torch.empty(2 * d, H, **f32),
             torch.empty(H, **f32), torch.empty(H, H, **f32),
             torch.empty(H, **f32), torch.empty(H, 1, **f32),
             torch.empty(1, **f32), torch.empty(H, **f32),
             torch.empty(H, **f32), torch.empty(H, **f32),
             torch.empty(H, **f32))
    scratch = torch.empty(lib.es_bwd_scratch_bytes(E, n, d, H),
                          dtype=torch.uint8, device=feat.device)
    rc = lib.es_backward(_p(feat), _p(entries.rows32), _p(entries.cols32),
                         _p(W1), _p(b1), _p(W2), _p(w3), _p(g1), _p(be1),
                         _p(g2), _p(be2), _p(z1), _p(z2), _p(st), _p(s),
                         _p(gs), _p(entries.seg_ptr), _p(entries.seg_perm),
                         *(_p(t) for t in grads), _p(scratch), E, n, d, H,
                         _smem_bytes(lib), stream)
    if rc != 0:
        raise RuntimeError(f"edge scorer backward launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["edge_scorer_bwd"] += 1
    return grads


def forward(entries: Entries, *params) -> tuple:
    """(scores [E], z1 [E, H], z2 [E, H], st [4, H]: BN1's mean and 1/std,
    then BN2's) from the forward kernels."""
    if not params[0].is_cuda:
        raise ValueError("the edge scorer kernels take CUDA tensors")
    _check(entries, params)
    return forward_on(build(), _stream(params[0].device), entries, params)


def backward(entries: Entries, saved: tuple, gs: torch.Tensor) -> tuple:
    """The backward kernels for ``saved`` (see :class:`ScorerKernels`)."""
    E = entries.E
    if (gs.device != saved[0].device or gs.dtype != torch.float32
            or tuple(gs.shape) != (E,) or not gs.is_contiguous()):
        raise ValueError(f"the score gradient must be a contiguous float32 "
                         f"[{E}] on {saved[0].device}")
    return backward_on(build(), _stream(gs.device), entries, saved, gs)


def _saved(params: tuple, z2, st, s) -> tuple:
    """What the backward reads: the inputs but the biases after the first
    layer, z2, the statistics and the scores (z1 is recomputed)."""
    feat, W1, b1, W2, _, w3, _, g1, be1, g2, be2 = params
    return feat, W1, b1, W2, w3, g1, be1, g2, be2, z2, st, s


class ScorerKernels(torch.autograd.Function):
    """Forward kernels in ``forward``, backward kernels in ``backward``;
    keeps one [E, H] tensor, ``z2``, with the statistics and the scores.
    The backward writes over the saved ``z2``, so it runs once a forward:
    a second backward through a retained graph raises."""

    @staticmethod
    def forward(ctx, entries, *params):
        s, _, z2, st = forward(entries, *params)
        ctx.entries, ctx.spent = entries, False
        ctx.save_for_backward(*_saved(params, z2, st, s))
        return s

    @staticmethod
    @once_differentiable
    def backward(ctx, gs):
        if ctx.spent:
            raise RuntimeError("the edge scorer kernels' backward runs once "
                               "a forward: it overwrote the saved z2")
        ctx.spent = True
        return (None, *backward(ctx.entries, ctx.saved_tensors,
                                gs.contiguous()))


# ---------------------------------------------------------------------------
# Plain version (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _bn_stats(z: torch.Tensor) -> tuple:
    """Mean and 1/std over the rows from float64 sums of z and z²."""
    zd, E = z.double(), z.shape[0]
    mean = zd.sum(0) / E
    var = (zd.square().sum(0) / E - mean.square()).clamp_min(0.0)
    return mean.to(z.dtype), (1.0 / torch.sqrt(var + EPS)).to(z.dtype)


def _colsum(t: torch.Tensor) -> torch.Tensor:
    return t.double().sum(0)


def _bn_backward(sdb, sdg, sxh, gamma, ist, E: int) -> tuple:
    """(c1, c2, dγ, dβ, d bias) from the float64 sums Σdy, Σdy·x̂, Σx̂:
    dz = p·dy − c1 − x̂·c2 with p = γ·ist, and the bias before the
    BatchNorm gets Σdz = p·Σdy − E·c1 − c2·Σx̂."""
    dt = gamma.dtype
    p = (gamma * ist).double()
    c1, c2 = (p * sdb / E).to(dt), (p * sdg / E).to(dt)
    dbias = p * sdb - E * c1.double() - c2.double() * sxh
    return c1, c2, sdg.to(dt), sdb.to(dt), dbias.to(dt)


def first_layer(entries: Entries, feat, W1, b1) -> torch.Tensor:
    """z1 = [x_r | x_c] W1 + b1 in tensor ops."""
    h0 = torch.cat([feat[entries.rows], feat[entries.cols]], dim=1)
    return h0 @ W1 + b1


def forward_plain(entries: Entries, feat, W1, b1, W2, b2, w3, b3, g1, be1,
                  g2, be2) -> tuple:
    """The kernels' forward in tensor ops → (scores, z1, z2, st)."""
    z1 = first_layer(entries, feat, W1, b1)
    mu1, ist1 = _bn_stats(z1)
    a1 = torch.relu((z1 - mu1) * ist1 * g1 + be1)
    z2 = a1 @ W2 + b2
    mu2, ist2 = _bn_stats(z2)
    a2 = torch.relu((z2 - mu2) * ist2 * g2 + be2)
    s = torch.sigmoid(a2 @ w3[:, 0] + b3)
    return s, z1, z2, torch.stack([mu1, ist1, mu2, ist2])


def backward_plain(entries: Entries, saved: tuple, gs: torch.Tensor) -> tuple:
    """The kernels' backward in tensor ops → (dfeat, dW1, db1, dW2, db2,
    dw3, db3, dg1, dbe1, dg2, dbe2); z1 is recomputed by
    :func:`first_layer`."""
    feat, W1, b1, W2, w3, g1, be1, g2, be2, z2, st, s = saved
    (E, H), (n, d) = z2.shape, feat.shape
    z1 = first_layer(entries, feat, W1, b1)
    mu1, ist1, mu2, ist2 = st
    zero = z2.new_zeros(())
    # the head and BN2: one pass over z2
    dl = gs * s * (1 - s)
    xh2 = (z2 - mu2) * ist2
    y2 = xh2 * g2 + be2
    dy2 = torch.where(y2 > 0, dl[:, None] * w3[:, 0], zero)
    dw3 = _colsum(dl[:, None] * torch.relu(y2)).to(z2.dtype)[:, None]
    db3 = dl.double().sum().to(z2.dtype).reshape(1)
    c1b, c2b, dg2, dbe2, db2 = _bn_backward(
        _colsum(dy2), _colsum(dy2 * xh2), _colsum(xh2), g2, ist2, E)
    dz2 = g2 * ist2 * dy2 - c1b - xh2 * c2b
    # dW2 and BN1
    a1 = torch.relu((z1 - mu1) * ist1 * g1 + be1)
    dW2 = a1.T @ dz2
    xh1 = (z1 - mu1) * ist1
    dy1 = torch.where(xh1 * g1 + be1 > 0, dz2 @ W2.T, zero)
    c1a, c2a, dg1, dbe1, db1 = _bn_backward(
        _colsum(dy1), _colsum(dy1 * xh1), _colsum(xh1), g1, ist1, E)
    dz1 = (g1 * ist1 * dy1 - c1a - xh1 * c2a).double()
    # the first layer through the per-node segment sums
    S = torch.zeros(2 * n, H, dtype=torch.float64, device=z1.device)
    S.index_add_(0, entries.rows, dz1)
    S.index_add_(0, entries.cols + n, dz1)
    S = S.to(z1.dtype)
    dW1 = torch.cat([feat.T @ S[:n], feat.T @ S[n:]])
    dfeat = S[:n] @ W1[:d].T + S[n:] @ W1[d:].T
    return dfeat, dW1, db1, dW2, db2, dw3, db3, dg1, dbe1, dg2, dbe2


class ScorerPlain(torch.autograd.Function):
    """:func:`forward_plain` with :func:`backward_plain` as its backward."""

    @staticmethod
    def forward(ctx, entries, *params):
        s, _, z2, st = forward_plain(entries, *params)
        ctx.entries = entries
        ctx.save_for_backward(*_saved(params, z2, st, s))
        return s

    @staticmethod
    @once_differentiable
    def backward(ctx, gs):
        return (None, *backward_plain(ctx.entries, ctx.saved_tensors, gs))


def edge_scores(entries: Entries, *params) -> torch.Tensor:
    """Scores [E] of the entries for ``params`` = (feat, W1, b1, W2, b2,
    w3, b3, γ1, β1, γ2, β2): the kernels for CUDA tensors, the plain
    version for CPU ones.  Under no gradient the forward keeps nothing."""
    device = params[0].device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no edge scorer path for device {device}")
    cuda = device.type == "cuda"
    if cuda:
        params = tuple(t.contiguous() for t in params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        return (ScorerKernels if cuda else ScorerPlain).apply(entries,
                                                              *params)
    return (forward if cuda else forward_plain)(entries, *params)[0]
