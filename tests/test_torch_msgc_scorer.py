"""MSGC's edge scorer: the plain version with its explicit backward
(``kernels/edge_scorer.py``, :class:`ScorerPlain`, the formulas the CUDA
kernels use) against autograd through the tensor-op scorer it replaced,
in float64 on the CPU.

The tensor-op scorer is kept here as :func:`_scores_autograd`:
``[x_r | x_c]`` → Linear / BatchNorm / ReLU twice → Linear → sigmoid,
with ``nn.linear_apply`` and ``nn.bn_apply``.  Every case compares the
scores, the BatchNorm statistics, and the gradient of each leaf and of
the features for a loss that weights the scattered (last) entries only, so
the duplicated entries get a zero score gradient and still enter the
statistics.  In float64 the two differ by rounding alone (1e-12); the
biases in front of a BatchNorm have gradient 0 analytically, so theirs
are held to 1e-12 of the largest gradient entry.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch.kernels import edge_scorer as ES
from graphslim_tpu_torch.models import nn
from graphslim_tpu_torch.reduce import msgc


@pytest.fixture(autouse=True)
def _grad_on():
    # another module of the suite switches gradients off process-wide
    with torch.enable_grad():
        yield


LEAVES = ["layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b",
          "layers.2.w", "layers.2.b", "bns.0.scale", "bns.0.bias",
          "bns.1.scale", "bns.1.bias"]


def _scores_autograd(scorer, params, feat):
    """The tensor-op scorer (autograd through every op) → (scores, z1,
    z2), the pre-BatchNorm activations."""
    h = torch.cat([feat[scorer.rows], feat[scorer.cols]], dim=1)
    layers, zs = params["layers"], []
    for i, p in enumerate(layers):
        h = nn.linear_apply(p, h)
        if i != len(layers) - 1:
            zs.append(h)
            h = torch.relu(nn.bn_apply(params["bns"][i], h))
    return torch.sigmoid(h.reshape(-1)), *zs


def _leaves(params):
    return [params["layers"][i][k] for i in range(3) for k in ("w", "b")] + \
        [params["bns"][i][k] for i in range(2) for k in ("scale", "bias")]


def _skeleton_scorer(n, d, nclass, batch, seed):
    rng = np.random.default_rng(seed)
    y = np.sort(rng.integers(0, nclass, n)).astype(np.int32)
    rows, cols, batches = msgc.build_skeletons(y, nclass, batch, seed)
    return msgc.EdgeScorer(d, n, batch, rows, cols, batches, "cpu")


def _random_scorer(n, d, E, seed):
    """Random entries, many of them repeated (batch 1)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, E).astype(np.int32)
    cols = rng.integers(0, n, E).astype(np.int32)
    rows[E // 2:E // 2 + E // 8] = rows[:E // 8]
    cols[E // 2:E // 2 + E // 8] = cols[:E // 8]
    return msgc.EdgeScorer(d, n, 1, rows, cols, np.zeros(E, np.int32), "cpu")


def _params(scorer, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    params = scorer.init(g)
    # non-trivial BatchNorm affines and biases, so every term shows
    for p in params["layers"]:
        p["b"] = 0.1 * torch.randn(p["b"].shape, generator=g)
    for p in params["bns"]:
        p["scale"] = 1 + 0.2 * torch.randn(p["scale"].shape, generator=g)
        p["bias"] = 0.2 * torch.randn(p["bias"].shape, generator=g)
    params = {k: [{kk: vv.to(dtype).requires_grad_(True)
                   for kk, vv in p.items()} for p in v]
              for k, v in params.items()}
    feat = torch.randn(scorer.n, scorer.dims[0] // 2, generator=g)
    return params, feat.to(dtype).requires_grad_(True)


def _loss_weights(scorer, seed, dtype):
    """Weights of the scattered (last) entries, zero elsewhere."""
    w = torch.zeros(scorer.rows.shape[0], dtype=dtype)
    g = torch.Generator().manual_seed(seed + 1)
    w[scorer.last] = torch.randn(scorer.last.shape[0], generator=g,
                                 dtype=dtype)
    return w


CASES = {
    # duplicated skeleton entries, only `last` scattered; 2d = 10
    "skeletons": lambda: _skeleton_scorer(40, 5, 4, 3, seed=3),
    # E a multiple of no tile (1001), 2d = 256
    "ragged_2d256": lambda: _random_scorer(30, 128, 1001, seed=4),
    # an odd feature width (2d = 2 × 1433, cora's)
    "odd_width": lambda: _random_scorer(9, 1433, 77, seed=5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_backward_equals_autograd(case):
    scorer = CASES[case]()
    dt = torch.float64
    params, feat = _params(scorer, 7, dt)
    w = _loss_weights(scorer, 7, dt)
    s_ref, z1, z2 = _scores_autograd(scorer, params, feat)
    g_ref = torch.autograd.grad((s_ref * w).sum(), _leaves(params) + [feat])
    s = scorer.scores(params, feat)
    assert s.grad_fn is not None and "ScorerPlain" in type(s.grad_fn).__name__
    g = torch.autograd.grad((s * w).sum(), _leaves(params) + [feat])
    assert (w[scorer.last] != 0).all() and int((w == 0).sum()) == \
        scorer.rows.shape[0] - scorer.last.shape[0]
    torch.testing.assert_close(s, s_ref, rtol=1e-12, atol=1e-14)
    scale = max(float(t.abs().max()) for t in g_ref)
    for name, a, b in zip(LEAVES + ["feat"], g, g_ref):
        if name in ("layers.0.b", "layers.1.b"):
            assert float((a - b).abs().max()) <= 1e-12 * scale, name
            continue
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12 * scale,
                                   msg=name)
    # BatchNorm statistics over every entry, duplicates included
    *_, st = ES.forward_plain(scorer.entries, feat, *_flat(params))
    for z, mu, ist in ((z1, st[0], st[1]), (z2, st[2], st[3])):
        torch.testing.assert_close(mu, z.mean(0), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(
            ist, torch.rsqrt(z.var(0, unbiased=False) + ES.EPS), rtol=1e-12,
            atol=0)


def _flat(params):
    (l1, l2, l3), (n1, n2) = params["layers"], params["bns"]
    return (l1["w"], l1["b"], l2["w"], l2["b"], l3["w"], l3["b"],
            n1["scale"], n1["bias"], n2["scale"], n2["bias"])


def test_apply_on_the_cpu_scores_without_the_kernels():
    """``apply`` keeps its batch and spans on the CPU: the plain version
    scores (in float32, as the reducer runs) and no launch is counted;
    under no gradient nothing is kept for a backward."""
    scorer = CASES["skeletons"]()
    params, feat = _params(scorer, 11, torch.float32)
    ES.reset_launches()
    rec = P.Recorder()
    saved, P.RECORDER = P.RECORDER, rec
    try:
        adj = scorer.apply(params, feat)
        with torch.no_grad():
            adj_ng = scorer.apply(params, feat)
        counters = P.counters()
    finally:
        P.RECORDER = saved
    assert adj.shape == (3, 40, 40) and adj.grad_fn is not None
    assert adj_ng.grad_fn is None
    torch.testing.assert_close(adj_ng, adj.detach(), rtol=0, atol=0)
    assert counters["generator.scored_entries"] == 2 * scorer.rows.shape[0]
    assert ES.LAUNCHES == {"edge_scorer_fwd": 0, "edge_scorer_bwd": 0}
    s_ref = _scores_autograd(scorer, params, feat)[0]
    torch.testing.assert_close(scorer.scores(params, feat), s_ref,
                               rtol=1e-5, atol=1e-6)


def test_the_segments_list_each_nodes_entries_in_order():
    scorer = CASES["skeletons"]()
    rows, cols, n = scorer.rows, scorer.cols, scorer.n
    ptr, perm = ES.segments(rows, cols, n)
    E = rows.shape[0]
    assert ptr.dtype == perm.dtype == torch.int32
    assert ptr.shape == (2 * n + 1,) and perm.shape == (2 * E,)
    assert int(ptr[0]) == 0 and int(ptr[n]) == E and int(ptr[-1]) == 2 * E
    ptr, perm = ptr.long(), perm.long()
    for i in range(n):
        mine = perm[ptr[i]:ptr[i + 1]]
        assert torch.equal(mine, torch.nonzero(rows == i)[:, 0])
        mine = perm[ptr[n + i]:ptr[n + i + 1]]
        assert torch.equal(mine, torch.nonzero(cols == i)[:, 0])


def test_the_kernel_wrappers_refuse_what_they_do_not_take():
    scorer = CASES["skeletons"]()
    params, feat = _params(scorer, 13, torch.float32)
    flat = [t.detach() for t in (feat, *_flat(params))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ES.forward(scorer.entries, *flat)
    wide = list(flat)
    wide[1], wide[3] = torch.zeros(10, 512), torch.zeros(512, 512)
    for i in (2, 4, 7, 8, 9, 10):
        wide[i] = torch.zeros(512)
    wide[5] = torch.zeros(512, 1)
    with pytest.raises(ValueError, match="hidden widths up to 256"):
        ES._check(scorer.entries, tuple(wide))
    half = list(flat)
    half[0] = half[0].half()
    with pytest.raises(ValueError, match="float32"):
        ES._check(scorer.entries, tuple(half))


class _FakeLib:
    """Stands in for the built library: ``es_forward`` returns ``rc``."""

    def __init__(self, rc):
        self.rc = rc

    def es_fwd_scratch_bytes(self, E, H):
        return 0

    def es_smem_bytes(self):
        return 0

    def es_forward(self, *args):
        return self.rc


@pytest.mark.parametrize("rc", [0, 700])
def test_a_forward_launch_counts_its_entries_only_when_it_ran(rc):
    """``LAUNCHES`` advances where the forward chain was launched, and
    not for a launch that failed."""
    scorer = CASES["skeletons"]()
    params, feat = _params(scorer, 17, torch.float32)
    flat = tuple(t.detach() for t in (feat, *_flat(params)))
    ES.reset_launches()
    if rc:
        with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
            ES.forward_on(_FakeLib(rc), 0, scorer.entries, flat)
    else:
        ES.forward_on(_FakeLib(rc), 0, scorer.entries, flat)
    ran = 0 if rc else 1
    assert ES.LAUNCHES == {"edge_scorer_fwd": ran, "edge_scorer_bwd": 0}


def test_the_kernels_backward_runs_once_a_forward(monkeypatch):
    """The backward kernels write over the saved z2, so a second backward
    through a retained graph raises instead of reading it (the plain
    forward and backward stand in for the kernels here)."""
    monkeypatch.setattr(ES, "forward", ES.forward_plain)
    monkeypatch.setattr(ES, "backward", ES.backward_plain)
    scorer = CASES["skeletons"]()
    params, feat = _params(scorer, 19, torch.float64)
    leaves = [feat, *_flat(params)]
    loss = (ES.ScorerKernels.apply(scorer.entries, *leaves)
            * _loss_weights(scorer, 19, torch.float64)).sum()
    g = torch.autograd.grad(loss, leaves, retain_graph=True)
    assert all(torch.isfinite(t).all() for t in g)
    with pytest.raises(RuntimeError, match="runs once a forward"):
        torch.autograd.grad(loss, leaves)
