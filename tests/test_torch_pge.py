"""The port's PGE pair-MLP plain version and PGE model against the JAX
package (CPU).

``pair_scores_plain(..., mm_bf16=False)`` is held against
``pallas_pge.pair_scores_ref`` (the oracle of the TPU kernel's tile-local
BatchNorm math), forward and all seven gradients, with max|Δ| ≤
rtol·max|ref| + 1e-5 (the criterion of ``tests/test_kernels.py``).  dbmid
is analytically 0 (BatchNorm shift invariance), so its scale is that of
dbeta, the same kind of sum.

The gradient has a jump at the ReLU kink: a pre-activation within float32
rounding of 0 takes derivative 1 in one implementation and 0 in the other
(measured against a float64 run of the plain version, such flips land on
either side).  So gradients are checked in two regimes: with BatchNorm
shifts beta = 3, which keeps pre-activations away from the kink (about 0.1 %
still negative), at rtol 1e-4; and with generic inputs at rtol 1e-2, the
size of one flipped pair (a formula error is O(1)).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu.kernels import pallas_pge as pp
from graphslim_tpu.models.pge import PGE as JPGE, PGEConfig as JPGEConfig
from graphslim_tpu_torch.convert import pge_params_from_jax
from graphslim_tpu_torch.kernels import pge as K
from graphslim_tpu_torch.models.pge import PGE, PGEConfig


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


def _inputs(n, H, L2, seed, beta_shift=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return [f(n, H), f(n, H), f(L2, H, H, sc=0.1), f(L2, H, sc=0.1),
            1.0 + f(L2 + 1, H, sc=0.1), beta_shift + f(L2 + 1, H, sc=0.1),
            f(1, H, sc=0.1)], f(n, n)


def _close(x, y, scale=None, rtol=1e-4):
    scale = y if scale is None else scale
    if y.size == 0:
        return
    err = np.abs(x - y).max()
    assert err <= rtol * np.abs(scale).max() + 1e-5, err


@pytest.mark.parametrize("regime,beta_shift,rtol",
                         [("off_kink", 3.0, 1e-4), ("generic", 0.0, 1e-2)])
@pytest.mark.parametrize("n,L2", [(45, 0), (45, 1), (150, 0), (150, 1)])
def test_plain_matches_jax_ref_forward_and_grads(n, L2, regime, beta_shift,
                                                 rtol):
    H = 64
    arrs, R = _inputs(n, H, L2, seed=n + L2, beta_shift=beta_shift)
    want = np.asarray(pp.pair_scores_ref(*map(jnp.asarray, arrs), n))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    got = K.pair_scores_plain(*leaves, n, mm_bf16=False)
    _close(got.detach().numpy(), want)

    gj = jax.grad(lambda *a: jnp.sum(pp.pair_scores_ref(*a, n) * R),
                  argnums=tuple(range(7)))(*map(jnp.asarray, arrs))
    gt = torch.autograd.grad((got * torch.tensor(R)).sum(), leaves,
                             allow_unused=True)
    gt = [np.zeros_like(a) if g is None else g.numpy()
          for g, a in zip(gt, arrs)]
    gj = [np.asarray(g) for g in gj]
    for i, (x, y) in enumerate(zip(gt, gj)):
        _close(x, y, scale=gj[5] if i == 3 else None, rtol=rtol)


def _autograd_grads(arrs, R, n, dtype):
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrs]
    out = K.pair_scores_plain(*leaves, n, mm_bf16=False)
    gs = torch.autograd.grad((out * torch.tensor(R, dtype=dtype)).sum(),
                             leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("L2", [0, 1, 2])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("n", [45, 150, 300])
def test_bwd_plain_matches_autograd_of_plain(n, H, L2, dtype, rtol):
    """The backward kernel's dataflow in tensor ops (reduction pass, dz
    where it is read, closed-form da/db from row and column sums) against
    autograd of the forward's plain version, on ragged tile grids: within
    1e-10·max|ref| in float64 (the formulas are exact) and 1e-4·max|ref|
    in float32 with beta + 3, which keeps pre-activations off the kink."""
    arrs, R = _inputs(n, H, L2, seed=n + H + L2, beta_shift=3.0)
    want = _autograd_grads(arrs, R, n, dtype)
    with torch.no_grad():
        got = K.pair_scores_bwd_plain(
            *[torch.tensor(a, dtype=dtype) for a in arrs],
            torch.tensor(R, dtype=dtype), n, mm_bf16=False)
    assert len(got) == 7
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape and x.dtype == dtype
        if y.numel() == 0:
            continue
        scale = want[5] if i == 3 else y     # dbmid: analytically 0
        err = float((x - y).abs().max())
        assert err <= rtol * float(scale.abs().max()) + 1e-12, (i, err)


@pytest.mark.parametrize("regime,beta_shift,rtol",
                         [("off_kink", 3.0, 1e-4), ("generic", 0.0, 1e-2)])
@pytest.mark.parametrize("n,L2", [(45, 0), (45, 2), (150, 1), (150, 2)])
def test_bwd_plain_matches_jax_grad_of_ref(n, L2, regime, beta_shift, rtol):
    H = 64
    arrs, R = _inputs(n, H, L2, seed=n + L2, beta_shift=beta_shift)
    gj = jax.grad(lambda *a: jnp.sum(pp.pair_scores_ref(*a, n) * R),
                  argnums=tuple(range(7)))(*map(jnp.asarray, arrs))
    gj = [np.asarray(g) for g in gj]
    with torch.no_grad():
        got = K.pair_scores_bwd_plain(*[torch.tensor(a) for a in arrs],
                                      torch.tensor(R), n, mm_bf16=False)
    for i, (x, y) in enumerate(zip(got, gj)):
        _close(x.numpy(), y, scale=gj[5] if i == 3 else None, rtol=rtol)


def test_bwd_plain_bf16_stays_near_the_fp32_gradient():
    """With mm_bf16 the dataflow rounds the operands of its two products
    (x, dz, W) to bf16 and nothing else: every gradient stays within
    2e-2·max of the fp32 one and differs from it."""
    n, H, L2 = 150, 64, 2
    arrs, R = _inputs(n, H, L2, seed=11, beta_shift=3.0)
    t = [torch.tensor(a) for a in arrs] + [torch.tensor(R)]
    with torch.no_grad():
        exact = K.pair_scores_bwd_plain(*t, n, mm_bf16=False)
        rounded = K.pair_scores_bwd_plain(*t, n, mm_bf16=True)
    for i, (x, y) in enumerate(zip(rounded, exact)):
        scale = exact[5] if i == 3 else y
        assert float((x - y).abs().max()) <= 2e-2 * float(scale.abs().max())
    assert not torch.equal(rounded[2], exact[2])


def test_plain_bf16_rounds_matmul_operands_only():
    """mm_bf16 changes the scores by bf16 rounding of the matmul operands
    only (relative 2^-9 per operand): within 2e-2·max|ref|."""
    n, H, L2 = 45, 64, 1
    arrs, _ = _inputs(n, H, L2, seed=3)
    t = [torch.tensor(a) for a in arrs]
    exact = K.pair_scores_plain(*t, n, mm_bf16=False)
    rounded = K.pair_scores_plain(*t, n, mm_bf16=True)
    diff = (exact - rounded).abs().max().item()
    assert 0 < diff <= 2e-2 * exact.abs().max().item()


@pytest.mark.parametrize("n", [45, 150])
def test_pge_apply_matches_jax_tile_semantics(n):
    """PGE.apply of the port (CPU → plain version) against the JAX PGE
    with backend='pallas', its kernel call patched to the pure-JAX
    oracle of the same tile math."""
    d, nhid = 24, 64
    x = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    jpge = JPGE(JPGEConfig(nfeat=d, nnodes=n, nhid=nhid, backend="pallas"))
    jparams = jpge.init(jax.random.key(0))
    with mock.patch.object(pp, "pair_scores",
                           lambda *a, **kw: pp.pair_scores_ref(*a[:8])):
        want = np.asarray(jpge.apply(jparams, jnp.asarray(x)))
    tparams = pge_params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    tpge = PGE(PGEConfig(nfeat=d, nnodes=n, nhid=nhid, mm_bf16=False))
    got = tpge.apply(tparams, torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.diag(got) == 0)
    # symmetric up to float32 rounding (vectorized and scalar sigmoid paths)
    np.testing.assert_allclose(got, got.T, rtol=0, atol=1e-6)


def test_pair_scores_dispatch_keeps_cpu_on_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    n, H = 20, 64
    arrs, _ = _inputs(n, H, 1, seed=5)
    t = [torch.tensor(a) for a in arrs]
    before = dict(K.LAUNCHES)
    out = K.pair_scores(*t, n, mm_bf16=False)
    assert K.LAUNCHES == before
    torch.testing.assert_close(out, K.pair_scores_plain(*t, n, False))


def test_kernel_wrapper_refuses_cpu_tensors():
    arrs, _ = _inputs(20, 64, 1, seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        K.pge_fwd(*[torch.tensor(a) for a in arrs], 20, True)
