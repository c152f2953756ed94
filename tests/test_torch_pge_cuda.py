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
                                    (200, 256, 2)])
def test_kernels_match_plain_version(card, n, H, L2, bf16):
    rtol, atol = (2e-2, 1e-4) if bf16 else (1e-4, 1e-5)
    args = _inputs(n, H, L2, card)
    leaves = [a.clone().requires_grad_(True) for a in args]
    R = torch.randn(n, n, device=card)
    out = K.pair_scores(*leaves, n, bf16)
    ref = K.pair_scores_plain(*leaves, n, bf16)
    assert (out - ref).abs().max() <= rtol * ref.abs().max() + atol
    got = torch.autograd.grad((out * R).sum(), leaves, allow_unused=True)
    want = torch.autograd.grad((ref * R).sum(), leaves, allow_unused=True)
    for i, (x, y) in enumerate(zip(got, want)):
        if y is None:
            continue
        scale = want[5] if i == 3 else y    # dbmid: analytically 0
        assert (x - y).abs().max() <= rtol * scale.abs().max() + atol, i
