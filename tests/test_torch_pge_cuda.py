"""The PGE CUDA kernels against their plain version, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_pge_cuda.py -m cuda`` (the suite's conftest imports JAX,
which the card's machine need not have).
``chip_smoke.py`` makes the same comparison at the slice's full shapes.
Tolerance: max|Δ| ≤ 1e-4·max|ref| + 1e-5 in fp32 (the BatchNorm shifts
keep pre-activations away from the ReLU kink, see test_torch_pge.py), and
2e-2·max|ref| + 1e-4 with bf16 matmul operands.
"""

import pytest
import torch

from graphslim_tpu_torch.kernels import pge as K

pytestmark = pytest.mark.cuda

GRADS = ("da", "db", "dwmid", "dbmid", "dgamma", "dbeta", "dwlast")


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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,H,L2", [(45, 64, 0), (150, 128, 1),
                                    (200, 256, 2), (150, 320, 1)])
def test_kernels_match_plain_version(card, n, H, L2, bf16):
    rtol, atol = (2e-2, 1e-4) if bf16 else (1e-4, 1e-5)
    args = _inputs(n, H, L2, card)
    leaves = [a.clone().requires_grad_(True) for a in args]
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(7))
    out = K.pair_scores(*leaves, n, bf16)
    ref = K.pair_scores_plain(*leaves, n, bf16)
    assert (out - ref).abs().max() <= rtol * ref.abs().max() + atol
    got = torch.autograd.grad((out * R).sum(), leaves, allow_unused=True)
    want = torch.autograd.grad((ref * R).sum(), leaves, allow_unused=True)
    for i, (x, y) in enumerate(zip(got, want)):
        if y is None:
            continue
        scale = want[5] if i == 3 else y    # dbmid: analytically 0
        gap, top = float((x - y).abs().max()), float(scale.abs().max())
        assert gap <= rtol * top + atol, \
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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,H,L2", [(45, 64, 0), (150, 128, 1),
                                    (200, 256, 2), (300, 64, 3),
                                    (150, 320, 1)])
def test_backward_repeats_bit_for_bit(card, n, H, L2, bf16):
    """Every sum of the backward has a fixed order (no atomics): two
    launches on the same inputs give the same bits, and a launch
    allocates a [P, H] gradient buffer only for two or more hidden
    layers."""
    args = _inputs(n, H, L2, card)
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(1))
    _, ws, stat = K.pge_fwd(*args, n, bf16)
    first = K.pge_bwd(*args, R, ws, stat, n, bf16)
    grid = K.LAST_BWD["grid"]
    shapes = K.bwd_scratch_shapes(n, H, L2, grid)
    assert ("dbuf" in shapes) == (L2 >= 2)
    assert K.LAST_BWD["scratch_bytes"] == 4 * sum(
        torch.Size(s).numel() for s in shapes.values())
    second = K.pge_bwd(*args, R, ws, stat, n, bf16)
    torch.cuda.synchronize()
    for name, x, y in zip(GRADS, first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,H,L2", [(45, 64, 0), (150, 128, 1),
                                    (200, 256, 2), (300, 64, 3),
                                    (150, 320, 1)])
def test_backward_kernel_matches_its_plain_dataflow(card, n, H, L2, bf16):
    """The kernel against ``pair_scores_bwd_plain``, the same dataflow in
    tensor ops (which the CPU tests hold to autograd): the tolerance of
    the comparison with the plain forward's autograd above."""
    rtol, atol = (2e-2, 1e-4) if bf16 else (1e-4, 1e-5)
    args = _inputs(n, H, L2, card)
    R = torch.randn(n, n, device=card,
                    generator=torch.Generator(card).manual_seed(7))
    _, ws, stat = K.pge_fwd(*args, n, bf16)
    got = K.pge_bwd(*args, R, ws, stat, n, bf16)
    with torch.no_grad():
        want = K.pair_scores_bwd_plain(*args, R, n, bf16)
    for i, (x, y) in enumerate(zip(got, want)):
        if not y.numel():
            continue
        scale = want[5] if i == 3 else y    # dbmid: analytically 0
        gap, top = float((x - y).abs().max()), float(scale.abs().max())
        assert gap <= rtol * top + atol, \
            f"{GRADS[i]}: max|Δ| / max|ref| = {gap / top:.3e}"
