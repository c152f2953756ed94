"""The PGE CUDA kernels against their plain version, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_pge_cuda.py -m cuda`` (the suite's conftest imports JAX,
which the card's machine need not have).
``chip_smoke.py`` makes the same comparison at the slice's full shapes.
The kernels take bf16 matmul operands only, as does the plain version
they are held to here.  Tolerance: max|Δ| ≤ 2e-2·max|ref| + 1e-4 (a
rounding flip of one bf16 operand moves a product by its 2^-9).
"""

import pytest
import torch

from graphslim_tpu_torch.kernels import pge as K

pytestmark = pytest.mark.cuda

GRADS = ("da", "db", "dwmid", "dbmid", "dgamma", "dbeta", "dwlast")
RTOL, ATOL = 2e-2, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with torch.enable_grad():
        yield torch.device("cuda")


def _inputs(n, H, L2, dev):
    g = torch.Generator(device=dev).manual_seed(n + L2)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    return [r(n, H), r(n, H), r(L2, H, H, sc=H ** -0.5), r(L2, H, sc=0.1),
            1.0 + r(L2 + 1, H, sc=0.1), 3.0 + r(L2 + 1, H, sc=0.1),
            r(1, H, sc=H ** -0.5)]


@pytest.mark.parametrize("n,H,L2", [(45, 64, 0), (150, 128, 1),
                                    (200, 256, 2), (150, 320, 1)])
def test_kernels_match_plain_version(card, n, H, L2):
    args = _inputs(n, H, L2, card)
    leaves = [a.clone().requires_grad_(True) for a in args]
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(7))
    out = K.pair_scores(*leaves, n)
    ref = K.pair_scores_plain(*leaves, n)
    assert (out - ref).abs().max() <= RTOL * ref.abs().max() + ATOL
    got = torch.autograd.grad((out * R).sum(), leaves, allow_unused=True)
    want = torch.autograd.grad((ref * R).sum(), leaves, allow_unused=True)
    for i, (x, y) in enumerate(zip(got, want)):
        if y is None:
            continue
        scale = want[5] if i == 3 else y    # dbmid: analytically 0
        gap, top = float((x - y).abs().max()), float(scale.abs().max())
        assert gap <= RTOL * top + ATOL, \
            f"{GRADS[i]}: max|Δ| / max|ref| = {gap / top:.3e}"


@pytest.mark.parametrize("seed", range(8))
def test_bf16_backward_is_as_near_float64_as_the_plain_version(card, seed):
    """Any cotangent, not only the one seeded above: with bf16 operands
    the kernel rounds dz before its matmuls and autograd of the plain
    version rounds the matmul results, so the two can differ by more than
    2e-2 of max|grad| in a gradient that sums over all pairs.  Neither is
    the reference there: the exact gradient (fp32 operands, float64
    arithmetic) is, and the kernel may be at most twice as far from it as
    the plain bf16 version (+ 1e-4·max), the bound ``chip_smoke.py`` uses.
    Prints each gradient's readings (``-s`` shows them)."""
    n, H, L2 = 200, 256, 2
    args = _inputs(n, H, L2, card)
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(seed))

    def grads(fn, dtype, bf16):
        leaves = [a.to(dtype).clone().requires_grad_(True) for a in args]
        loss = (fn(*leaves, n, bf16) * R.to(dtype)).sum()
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    got = grads(K.pair_scores, torch.float32, True)
    want = grads(K.pair_scores_plain, torch.float32, True)
    exact = grads(K.pair_scores_plain, torch.float64, False)
    for i, name in enumerate(GRADS):
        if exact[i] is None:
            continue
        top = float((exact[5] if i == 3 else exact[i]).abs().max())
        e_k = float((got[i].double() - exact[i]).abs().max())
        e_p = float((want[i].double() - exact[i]).abs().max())
        gap = float((got[i] - want[i]).abs().max())
        print(f"seed {seed} {name}: |kernel - plain| {gap / top:.3e}, "
              f"|kernel - f64| {e_k / top:.3e}, |plain - f64| "
              f"{e_p / top:.3e} (of max|f64| {top:.3e})")
        assert e_k <= 2 * e_p + 1e-4 * top, name


@pytest.mark.parametrize("n,H,L2", [(45, 64, 0), (150, 128, 1),
                                    (200, 256, 2), (300, 64, 3),
                                    (150, 320, 1)])
def test_backward_repeats_bit_for_bit(card, n, H, L2):
    """Every sum of the backward has a fixed order (no atomics): two
    launches on the same inputs give the same bits, and a launch
    allocates a [P, H] gradient buffer only for two or more hidden
    layers."""
    args = _inputs(n, H, L2, card)
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(1))
    _, ws, stat = K.pge_fwd(*args, n)
    first = K.pge_bwd(*args, R, ws, stat, n)
    grid = K.LAST_BWD["grid"]
    shapes = K.bwd_scratch_shapes(n, H, L2, grid)
    assert ("dbuf" in shapes) == (L2 >= 2)
    assert K.LAST_BWD["scratch_bytes"] == 4 * sum(
        torch.Size(s).numel() for s in shapes.values())
    second = K.pge_bwd(*args, R, ws, stat, n)
    torch.cuda.synchronize()
    for name, x, y in zip(GRADS, first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("n,H,L2", [(45, 64, 0), (150, 128, 1),
                                    (200, 256, 2), (300, 64, 3),
                                    (150, 320, 1)])
def test_backward_kernel_matches_its_plain_dataflow(card, n, H, L2):
    """The kernel against ``pair_scores_bwd_plain``, the same dataflow in
    tensor ops (which the CPU tests hold to autograd): the tolerance of
    the comparison with the plain forward's autograd above."""
    args = _inputs(n, H, L2, card)
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(7))
    _, ws, stat = K.pge_fwd(*args, n)
    got = K.pge_bwd(*args, R, ws, stat, n)
    with torch.no_grad():
        want = K.pair_scores_bwd_plain(*args, R, n)
    for i, (x, y) in enumerate(zip(got, want)):
        if not y.numel():
            continue
        scale = want[5] if i == 3 else y    # dbmid: analytically 0
        gap, top = float((x - y).abs().max()), float(scale.abs().max())
        assert gap <= RTOL * top + ATOL, \
            f"{GRADS[i]}: max|Δ| / max|ref| = {gap / top:.3e}"


@pytest.mark.parametrize("L2", [0, 1, 2])
@pytest.mark.parametrize("H", [64, 128, 256, 320])
@pytest.mark.parametrize("n", [1, 17, 129, 500, 1354])
def test_forward_matches_plain_version(card, n, H, L2):
    """Both launch kinds against the plain version (chip_smoke.py's
    TOL_FWD), and against each other bit for bit."""
    args = _inputs(n, H, L2, card)
    kept, _, _ = K.pge_fwd(*args, n, keep=True)
    bare, _, _ = K.pge_fwd(*args, n, keep=False)
    with torch.no_grad():
        ref = K.pair_scores_plain(*args, n)
    torch.cuda.synchronize()
    assert torch.equal(kept, bare)
    gap = float((kept - ref).abs().max())
    assert gap <= RTOL * float(ref.abs().max()) + ATOL, gap


@pytest.mark.parametrize("n,H,L2", [(1354, 256, 1), (300, 128, 2),
                                    (45, 64, 0), (150, 320, 1)])
def test_nograd_launch_keeps_no_workspace(card, n, H, L2):
    """pair_scores under no_grad launches the kind that keeps no per-tile
    workspace (only middle layers' z in a per-block buffer, none at all
    at L2 ≤ 1), with grad the kind the backward reads; their scores are
    equal bit for bit, and each kind is counted apart."""
    args = _inputs(n, H, L2, card)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = dict(K.LAUNCHES)
    with torch.no_grad():
        bare = K.pair_scores(*leaves, n)
    bare_bytes = K.LAST_FWD["workspace_bytes"]
    assert not K.LAST_FWD["keep"]
    kept = K.pair_scores(*leaves, n)
    assert K.LAST_FWD["keep"] and kept.requires_grad
    torch.cuda.synchronize()
    assert torch.equal(kept.detach(), bare)
    assert K.LAUNCHES["pge_fwd_nows"] == before["pge_fwd_nows"] + 1
    assert K.LAUNCHES["pge_fwd_ws"] == before["pge_fwd_ws"] + 1
    ws, stat = K._workspace_sizes(n, H, L2)
    assert K.LAST_FWD["workspace_bytes"] == 4 * (ws + stat)
    assert bare_bytes == 4 * K.LAST_FWD["grid"] * max(L2 - 1, 0) * K.P * H


def test_float32_operands_are_refused_on_the_card(card):
    """The kernels take bf16 matmul operands only: ``mm_bf16=False`` on
    CUDA tensors raises, with gradients recorded or not, and launches
    nothing (no fallback to the plain version)."""
    n, H, L2 = 150, 128, 1
    leaves = [a.clone().requires_grad_(True)
              for a in _inputs(n, H, L2, card)]
    before = dict(K.LAUNCHES)
    for grad in (True, False):
        with torch.set_grad_enabled(grad), \
                pytest.raises(ValueError, match="bf16 matmul operands only"):
            K.pair_scores(*leaves, n, mm_bf16=False)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("n,H,L2", [(300, 128, 2), (1354, 256, 1)])
def test_forward_statistics_hold_to_float64_under_a_large_mean(card, n, H,
                                                               L2):
    """A hidden layer's mean and invstd as the forward wrote them, against
    float64 statistics (two passes) of the z it wrote beside them, with a
    bias that puts each channel's mean about 30 of its standard deviations
    from 0.  var = E[z²] − mean² would then lose mean²/var (about 900) times
    any fp32 rounding of the sums; every sum runs in float64, so the
    kernel's values stay within float32 rounding of the exact ones."""
    args = _inputs(n, H, L2, card)
    args[3] = args[3] + 30.0
    _, ws, stat = K.pge_fwd(*args, n, keep=True)
    torch.cuda.synchronize()
    ni, nj = -(-n // K.TI), -(-n // K.TJ)
    z = ws.view(ni * nj, L2, K.TI, K.TJ, H).double()
    rows = (torch.arange(ni * K.TI, device=card) < n).view(ni, 1, K.TI, 1)
    cols = (torch.arange(nj * K.TJ, device=card) < n).view(1, nj, 1, K.TJ)
    mask = (rows & cols).view(ni * nj, 1, K.TI, K.TJ, 1).double()
    count = mask.sum((2, 3))
    mean = (z * mask).sum((2, 3)) / count                  # [T, L2, H]
    var = (((z - mean[:, :, None, None]) * mask) ** 2).sum((2, 3)) / count
    assert float((var.sqrt() / mean.abs()).median()) < 0.1
    L = L2 + 1
    st = stat.view(ni * nj, K._stat_rows(L2), H).double()
    got_mean, got_inv = st[:, 1:L], st[:, L + 1:2 * L]
    inv = torch.rsqrt(var + K.EPS)
    assert float(((got_mean - mean).abs() / mean.abs()).max()) < 2e-7
    assert float(((got_inv - inv).abs() / inv).max()) < 1e-6
