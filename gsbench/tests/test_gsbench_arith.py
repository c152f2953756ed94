"""The counts of gsbench/arith.py against counts by hand at the cells'
synthetic sizes."""

import pytest

from gsbench_tiny import ROOT
from gsbench import arith, manifest

H = 256


@pytest.mark.parametrize("n", [1354, 186, 135])
def test_pge_counts_by_hand(n):
    params = H * H + H + 4 * H + H
    fwd = arith.pge_fwd(n, H, 1)
    assert fwd["flops"] == 2 * n * n * H * H
    assert fwd["bytes"] == 4 * (2 * n * H + params + n * n)
    bwd = arith.pge_bwd(n, H, 1)
    assert bwd["flops"] == 4 * n * n * H * H
    # inputs (a, b, parameters, dL/dA) and outputs (da, db, parameter
    # gradients): no workspace
    assert bwd["bytes"] == 4 * (4 * n * H + 2 * params + n * n)
    assert fwd["least_s"] == max(fwd["flops"] / 989e12,
                                 fwd["bytes"] / 3.35e12)


def test_pge_at_1354_is_bound_by_operations():
    assert arith.pge_fwd(1354, H, 1)["least_s"] == pytest.approx(
        2 * 1354 ** 2 * H ** 2 / 989e12)
    assert arith.pge_bwd(1354, H, 1)["least_s"] * 1e3 == pytest.approx(
        0.4859, abs=1e-4)


@pytest.mark.parametrize("config,n,C", [("gcond_arxiv", 1354, 40),
                                        ("gcond_reddit", 186, 41),
                                        ("gcond_arxiv", 135, 40)])
def test_step_counts_by_hand(config, n, C):
    bench = manifest.benchmark(ROOT)
    cfg = manifest.config(bench, config)
    s = arith.shape_of(cfg, n, C)
    ops = {name: (f, b) for name, f, b, _ in arith.gcond_step(s)}
    d, ncls = cfg["twin"]["n_feat"], cfg["twin"]["nclass"]
    f1, f2 = cfg["engine"]["fanouts"]
    rows = 256 * (f1 + 1) * (f2 + 1)
    assert ops["real_gather"][1] == 4 * C * rows * d
    if cfg["published"]["ntrans"] == 2:
        layers = 2 * rows * (d * H + H * ncls)
        real = 2 * layers + 2 * rows * H * ncls
    else:
        real = 2 * (2 * rows * d * ncls)
    assert ops["real_trans"][0] == pytest.approx(C * real)
    assert ops["pge_fwd"][0] == 2 * n * n * H * H
    assert ops["inner_pge_fwd"][0] == 2 * n * n * H * H
    prop = 2 * 2 * n * n * ncls
    assert ops["syn_grads"][0] > C * 3 * prop
    assert arith.step_least_s(s) == pytest.approx(sum(
        arith.least_s(f, b, p) for _, f, b, p in arith.gcond_step(s)))


def test_percentile():
    assert arith.percentile([1, 2, 3, 4, 5], 50) == 3
    assert arith.percentile(list(range(101)), 95) == 95
