"""MSGC's edge scorer kernels on the card (``kernels/edge_scorer.py``,
``csrc/edge_scorer.cu``).

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest -s
tests/test_torch_msgc_scorer_cuda.py -m cuda`` (``-s`` shows the peak
memory and the largest gaps).

* The kernels against the plain version on the card, float32 with TF32
  off, at a small ragged E, at an odd feature width and at the MSGC arxiv
  cell's size (n = 909, d = 128, 16 skeletons from ``build_skeletons``,
  about 1.07 M entries): the forward's scores, statistics and
  activations; the backward kernels against the plain backward on the
  kernels' own saved tensors (the plain one handed the kernels' z1, which
  the backward kernels recompute bit for bit), leaf by leaf and for the
  features;
  and, end to end through autograd, each side's gradients against the
  plain version in float64.
* Two runs are bit-equal; the launch counters advance a chain a call
  and ``generator.scored_entries`` the scorer's E; at the cell's size the
  forward keeps one [E, 256] tensor for the backward, and a forward and
  backward stay under 3.5 GiB above their inputs; a launch
  refused for its shared memory raises.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import profiling as P
from graphslim_tpu_torch.kernels import edge_scorer as ES
from graphslim_tpu_torch.reduce import msgc

pytestmark = pytest.mark.cuda

LEAVES = ["layers.0.w", "layers.0.b", "layers.1.w", "layers.1.b",
          "layers.2.w", "layers.2.b", "bns.0.scale", "bns.0.bias",
          "bns.1.scale", "bns.1.bias", "feat"]
# Tolerances, float32 on both sides.  The forward: the products sum 2d
# and H terms in another order than cuBLAS, and the statistics come from
# float64 partial sums on both sides: a few ulp of z and of the logits,
# 1e-5 after the sigmoid.  The backward on one forward's saved tensors
# sums about 1e6 entries' float32 terms in another order (tiles and
# float64 partials against PyTorch's reductions and cuBLAS's split-K):
# 1e-4 relative, plus 1e-6 of the largest gradient entry, which covers
# the biases in front of a BatchNorm (0 analytically, rounding noise on
# both sides); the kernels round BatchNorm's elementwise steps as the
# plain version's ops do, so from the same z1 and z2 every ReLU mask is the
# same.  End to end the two forwards' products round differently, so
# a few of the ~3e8 masks flip where a pre-activation is within rounding
# of 0, and one flip moves a first-layer gradient entry by more than the
# sums' rounding; there each side is held to float64 by the norm of its
# error, and the kernels' may be at most three times the plain version's
# in float32, plus 1e-5 of the leaf's norm and 1e-6 of the largest leaf
# norm (the biases in front of a BatchNorm).
SCORE_ATOL, FWD_RTOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
E2E_RATIO, E2E_FLOOR = 3.0, 1e-5
GIB = 1 << 30


@pytest.fixture(autouse=True)
def _grad_on():
    # another module of the suite switches gradients off process-wide
    with torch.enable_grad():
        yield


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _skeletons(n, nclass, batch, seed):
    rng = np.random.default_rng(seed)
    # a skewed class mix, as a real graph's
    pool = rng.choice(nclass, 50 * n, p=rng.dirichlet(np.ones(nclass)))
    y = msgc.proportional_labels(pool, n, nclass)
    return msgc.build_skeletons(y, nclass, batch, seed)


def _random(n, E, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, E).astype(np.int32)
    cols = rng.integers(0, n, E).astype(np.int32)
    rows[E // 2:E // 2 + E // 8] = rows[:E // 8]
    cols[E // 2:E // 2 + E // 8] = cols[:E // 8]
    return rows, cols, np.zeros(E, np.int32)


_CELL = {}


def _cell_triples():
    """The cell's skeletons (n = 909, 40 classes, 16 skeletons), built
    once on the host."""
    if not _CELL:
        _CELL["t"] = _skeletons(909, 40, 16, seed=2)
    return _CELL["t"]


CASES = {"ragged": lambda: (30, 128, 1, _random(30, 1001, 4)),
         "odd_width": lambda: (9, 1433, 1, _random(9, 77, 5)),
         "cell": lambda: (909, 128, 16, _cell_triples())}


def _setup(case, device, seed=7):
    n, d, batch, (rows, cols, batches) = CASES[case]()
    scorer = msgc.EdgeScorer(d, n, batch, rows, cols, batches, device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = scorer.init(g)
    for p in params["layers"]:
        p["b"] = 0.1 * torch.randn(p["b"].shape, generator=g, device=device)
    for p in params["bns"]:
        p["scale"] = 1 + 0.2 * torch.randn(p["scale"].shape, generator=g,
                                           device=device)
        p["bias"] = 0.2 * torch.randn(p["bias"].shape, generator=g,
                                      device=device)
    for v in params.values():
        for p in v:
            for t in p.values():
                t.requires_grad_(True)
    feat = torch.randn(n, d, generator=g, device=device).requires_grad_(True)
    w = torch.zeros(scorer.rows.shape[0], device=device)
    w[scorer.last] = torch.randn(scorer.last.shape[0], generator=g,
                                 device=device)
    return scorer, params, feat, w


def _flat(params):
    (l1, l2, l3), (n1, n2) = params["layers"], params["bns"]
    return [l1["w"], l1["b"], l2["w"], l2["b"], l3["w"], l3["b"],
            n1["scale"], n1["bias"], n2["scale"], n2["bias"]]


def _run(fn, scorer, params, feat, w):
    s = fn(scorer.entries, feat, *_flat(params))
    g = torch.autograd.grad((s * w).sum(), _flat(params) + [feat])
    return s.detach(), g


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("case", ["ragged", "odd_width", "cell"])
def test_the_kernels_equal_the_plain_version(card, case, monkeypatch):
    scorer, params, feat, w = _setup(case, card)
    ent = scorer.entries
    flat = [t.detach() for t in [feat] + _flat(params)]
    ES.reset_launches()
    s, z1, z2, st = ES.forward(ent, *flat)
    sp, z1p, z2p, stp = ES.forward_plain(ent, *flat)
    gap = float((s - sp).abs().max())
    assert gap <= SCORE_ATOL, gap
    for name, a, b in (("z1", z1, z1p), ("z2", z2, z2p), ("st", st, stp)):
        assert _rel(a, b) <= FWD_RTOL, (name, _rel(a, b))
    # both backwards on the kernels' saved tensors and z1
    with monkeypatch.context() as m:
        m.setattr(ES, "first_layer", lambda *_: z1)
        gp = ES.backward_plain(ent, ES._saved(flat, z2, st, s), w)
    gk = ES.backward(ent, ES._saved(flat, z2.clone(), st, s), w)
    torch.cuda.synchronize()
    assert ES.LAUNCHES == {"edge_scorer_fwd": 1, "edge_scorer_bwd": 1}
    order = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 0]   # LEAVES from the grads
    gk, gp = [gk[i] for i in order], [gp[i] for i in order]
    scale = max(float(t.abs().max()) for t in gp)
    worst = {}
    for name, a, b in zip(LEAVES, gk, gp):
        err = float((a - b).abs().max())
        worst[name] = err / (GRAD_RTOL * float(b.abs().max())
                             + GRAD_FLOOR * scale)
    # end to end through autograd, each side against float64
    _, g = _run(ES.ScorerKernels.apply, scorer, params, feat, w)
    _, g32 = _run(ES.ScorerPlain.apply, scorer, params, feat, w)
    p64 = {k: [{kk: vv.detach().double().requires_grad_(True)
                for kk, vv in q.items()} for q in v]
           for k, v in params.items()}
    f64 = feat.detach().double().requires_grad_(True)
    _, g64 = _run(ES.ScorerPlain.apply, scorer, p64, f64, w.double())
    norm64 = max(float(t.norm()) for t in g64)
    ratios = {}
    for name, a, b, c in zip(LEAVES, g, g32, g64):
        err_k = float((a.double() - c).norm())
        err_p = float((b.double() - c).norm())
        floor = E2E_FLOOR * float(c.norm()) + GRAD_FLOOR * norm64
        ratios[name] = (err_k, err_p, floor)
    print(f"\n{case}: E = {ent.E}, score gap {gap:.2e}; backward gaps / "
          f"tolerance " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + "; end to end ||kernels - f64||, ||plain - f64|| "
          + ", ".join(f"{k} {a:.2e} {b:.2e}" for k, (a, b, _) in
                      ratios.items()))
    for name, r in worst.items():
        assert r <= 1.0, (name, r)
    for name, (err_k, err_p, floor) in ratios.items():
        assert err_k <= E2E_RATIO * err_p + floor, (name, err_k, err_p)


def test_two_runs_are_bit_equal(card):
    scorer, params, feat, w = _setup("cell", card)
    s1, g1 = _run(ES.ScorerKernels.apply, scorer, params, feat, w)
    s2, g2 = _run(ES.ScorerKernels.apply, scorer, params, feat, w)
    assert torch.equal(s1, s2)
    for name, a, b in zip(LEAVES, g1, g2):
        assert torch.equal(a, b), name
    with torch.no_grad():
        s3 = ES.edge_scores(scorer.entries, feat, *_flat(params))
    assert torch.equal(s1, s3)


def test_launches_and_scored_entries_advance(card):
    scorer, params, feat, w = _setup("ragged", card)
    ES.reset_launches()
    rec = P.Recorder()
    saved, P.RECORDER = P.RECORDER, rec
    try:
        adj = scorer.apply(params, feat)
        torch.autograd.grad(adj.sum(), [feat])
        with torch.no_grad():
            scorer.apply(params, feat)
        counters = P.counters()
    finally:
        P.RECORDER = saved
    E = scorer.rows.shape[0]
    assert ES.LAUNCHES == {"edge_scorer_fwd": 2, "edge_scorer_bwd": 1}
    assert counters["generator.scored_entries"] == 2 * E


def test_peak_memory_at_the_cells_size(card):
    """Between the forward and the backward the kernels keep z2 alone
    ([E, 256] float32, about 1 GB at the cell's E) with small vectors; a
    forward and backward writes z1 and z2 and small scratch.  The tensor-op
    scorer kept about eleven such tensors."""
    scorer, params, feat, w = _setup("cell", card)
    E = scorer.rows.shape[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s = ES.ScorerKernels.apply(scorer.entries, feat, *_flat(params))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    g = torch.autograd.grad((s * w).sum(), _flat(params) + [feat])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    one = E * 256 * 4
    print(f"\nheld for the backward {held / GIB:.4f} GiB, peak above the "
          f"inputs {peak / GIB:.4f} GiB at E = {E} ({held / one:.3f} and "
          f"{peak / one:.3f} [E, 256] float32 tensors)")
    assert held < one + (64 << 20)
    assert peak < 3.5 * GIB
    del s, g


def test_a_launch_refused_for_its_shared_memory_raises(card, monkeypatch):
    scorer, params, feat, w = _setup("ragged", card)
    monkeypatch.setattr(ES, "_smem_bytes", lambda lib: 300_000)
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(ES.ScorerKernels.apply, scorer, params, feat, w)
    monkeypatch.undo()
    torch.cuda.synchronize()
    s, _ = _run(ES.ScorerKernels.apply, scorer, params, feat, w)
    assert torch.isfinite(s).all()
