"""The port's MSGC against the plain reference ``reference/msgc.py`` (CPU,
a twin of 600 nodes and 3 classes at r = 0.05: 16 synthetic nodes,
B = 3 skeletons of the full 256-wide scorer, 2 propagations).

Seeded random weights (the features, the scorer with BatchNorm's scale
and shift and the biases moved off their init, the model) and the port's
own sampled blocks and skeletons, each judged alone by the reference
(``judge_sample``, ``judge_skeletons``), go into both.

Tolerances, each with its reason:

* each outer step's match loss to ``LOSS_TOL`` = 1e-6 relative: both
  compute it in float32 with TF32 off and differ only in the order of
  their sums (the port batches the classes and the skeletons, the
  reference loops over both); read at most 7e-8 here, the reference in
  TF32 4e-7 to 1e-5, so the gradients below tell the two apart;
* gradients (the features', every scorer leaf's, the model's at the
  inner loop's first step) to ``GRAD_TOL`` = 1e-5 of their group's
  largest entry: a group's scale, since the biases in front of a
  BatchNorm have gradient 0 analytically and read rounding alone; read
  under 6e-7 here, the reference in TF32 reads 3e-4 (the model) to 0.09
  (the scorer);
* each group's change over three outer steps (the port's own epoch loop
  against the reference's own three steps, Adam on both) to
  ``CHANGE_TOL`` = 1e-4 relative in norm, leaving out the leaves whose
  first gradient is under ``NOUGHT`` = 1e-3 of their group's largest
  (the two biases in front of the scorer's BatchNorms: gradient 0
  analytically, so Adam moves them by ``±lr`` on the signs rounding
  draws); read at most 2e-5 here (a leaf, 5.7e-5: Adam's per-element
  normalization magnifies rounding where a gradient entry is small), the
  reference in TF32 reads 1.7e-2 to 0.16 on the scorer's leaves.
"""

import ast
import contextlib
import copy
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch_shared import REPO
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from gsbench import manifest, twins  # noqa: E402
from gsbench.cond_job import _flat  # noqa: E402
from gsbench import reference as R  # noqa: E402
from reference import msgc as RM  # noqa: E402

LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
CHANGE_TOL = 1e-4
NOUGHT = 1e-3
B, RATE, NCLASS, D = 3, 0.05, 3, 12


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("msgc_ref"))
    cfg = manifest.config(manifest.benchmark(str(REPO)), "msgc_arxiv")
    twin = dict(copy.deepcopy(cfg["twin"]), n_nodes=600, n_feat=D,
                nclass=NCLASS, avg_degree=6.0,
                split=dict(train=320, val=100, test=180))
    data_dir, _ = twins.twin_file(twin, root)
    data = load("ogbn-arxiv", setting="trans", data_dir=data_dir,
                device="cpu")
    keys = dict(condense_model="SGC", dis_metric="ours", epochs=1,
                init="clustering", inner_loop=2, lr_adj=0.01, lr_feat=0.01,
                ntrans=2, outer_loop=3, hidden=16, nlayers=2, lr=0.01,
                batch_adj=B)
    args = finalize(Args(dataset="ogbn-arxiv", method="msgc",
                         reduction_rate=RATE, seed=3, device="cpu",
                         load_path=data_dir, save_path=root, **keys),
                    explicit=set(keys) | {"reduction_rate"})
    agent = create_reducer("msgc", data, args)
    g = R.RealGraph(twins.read_twin(twin, root), "trans", "cpu")
    n_syn = RM.n_syn_of(len(g.pool_labels), RATE, NCLASS)
    y = torch.as_tensor(RM.proportional_labels(g.pool_labels, n_syn,
                                               NCLASS))
    classes = sorted(set(y.tolist()))
    gen = torch.Generator().manual_seed(11)
    feat = torch.randn(agent.n_syn, D, generator=gen)
    scorer = agent.pge.init(gen)
    for bn in scorer["bns"]:
        bn["scale"] = 1 + 0.2 * torch.randn(bn["scale"].shape, generator=gen)
        bn["bias"] = 0.2 * torch.randn(bn["bias"].shape, generator=gen)
    mp = agent.model.init(gen)
    for layer in scorer["layers"] + mp["layers"]:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen)
    blocks = [agent._sample_all_class_blocks(agent.gen) for _ in range(3)]
    return dict(
        agent=agent, g=g, y=y, classes=classes,
        budgets={c: int((y == c).sum()) for c in classes},
        pools=R.class_pools(g, classes),
        sk=RM.Skeletons(agent.rows, agent.cols, agent.batches, n_syn, B,
                        "cpu"),
        rcfg=dict(nlayers=2, batch=agent.batch, lr=0.01, lr_adj=0.01,
                  lr_feat=0.01, inner_loop=2),
        feat=feat, scorer=scorer, mp=mp, blocks=blocks,
        samples=[dict(ids=i, ws=w, targets=t, valid=v)
                 for i, w, t, v in blocks])


def _state(w):
    return {"feat": w["feat"].clone(), "scorer": _flat(w["scorer"]),
            "mp": _flat(w["mp"])}


def _port_one_step(w):
    agent = w["agent"]
    with mock.patch.object(agent, "_sample_all_class_blocks",
                           lambda gen: w["blocks"][0]):
        fs = w["feat"].clone().requires_grad_(True)
        sc = utils.trainable(w["scorer"])
        adj, aux = agent.generator_forward(sc, fs)
        loss = agent.match_loss_total(w["mp"], fs, adj, agent.gen) + aux
        grads = torch.autograd.grad(loss, [fs] + utils.tree_leaves(sc))
    mp = utils.trainable(w["mp"])
    fs = w["feat"]
    out = agent.model.apply(mp, fs, agent.inner_adj(sc, fs))
    gm = torch.autograd.grad(utils.nll_loss(out, agent.labels_syn),
                             utils.tree_leaves(mp))
    names = sorted(_flat(w["scorer"])), sorted(_flat(w["mp"]))
    out = {"feat": grads[0]}
    out.update({f"scorer.{n}": x for n, x in zip(names[0], grads[1:])})
    out.update({f"mp.{n}": x for n, x in zip(names[1], gm)})
    return float(loss.detach()), out


def _ref_one_step(w, precision):
    prec = R.Precision(precision, "cpu")
    state = _state(w)
    with prec.active():
        loss, g_feat, g_sc, bad = RM.outer_step(
            w["g"], w["pools"], w["rcfg"], prec, state, w["samples"][0],
            w["y"], w["sk"], w["classes"], w["budgets"])
        with torch.no_grad():
            adjs = RM.generate(state["scorer"], state["feat"], w["sk"], prec)
        mp = {n: v.clone() for n, v in state["mp"].items()}
        first = RM.inner_fit(w["rcfg"], prec, mp, state["feat"], adjs,
                             w["y"], R.Adam(0.01, list(mp.values())))
    assert bad == 0
    out = {"feat": g_feat}
    out.update({f"scorer.{n}": v for n, v in g_sc.items()})
    out.update({f"mp.{n}": v for n, v in first.items()})
    return float(loss.detach()), out


def _grad_gaps(port, ref):
    groups = {}
    for k in ref:
        groups.setdefault(k.split(".")[0], []).append(k)
    out = {}
    for grp, keys in groups.items():
        scale = max(float(ref[k].abs().max()) for k in keys)
        out[grp] = max(float((port[k] - ref[k]).abs().max())
                       for k in keys) / scale
    return out


def _one_step_gaps(w, precision):
    lp, gp = _port_one_step(w)
    lr, gr = _ref_one_step(w, precision)
    return abs(lp - lr) / abs(lr), _grad_gaps(gp, gr)


def test_the_triples_and_labels_are_the_references(world):
    w = world
    a = w["agent"]
    assert torch.equal(a.labels_syn, w["y"].repeat(B))
    assert RM.judge_skeletons(a.rows, a.cols, a.batches, w["y"].numpy(),
                              NCLASS, B) == 0
    assert w["sk"].entries == a.rows.shape[0]


def test_one_outer_step_matches_the_reference(world):
    loss_gap, grad = _one_step_gaps(world, "fp32")
    assert loss_gap <= LOSS_TOL
    assert set(grad) == {"feat", "scorer", "mp"}
    for grp, gap in grad.items():
        assert gap <= GRAD_TOL, (grp, gap)


def _port_epoch(w, step_scorer: bool, frozen: bool = False):
    """The port's own epoch loop (three outer steps) from the seeded
    state on the pre-drawn blocks: each step's loss and every leaf's
    change."""
    agent = w["agent"]
    feat = w["feat"].clone().requires_grad_(True)
    sc = utils.trainable(w["scorer"])
    opt_f = agent.opt_feat.init([feat])
    opt_p = agent.opt_pge.init(utils.tree_leaves(sc))
    blocks, losses, seen = list(w["blocks"]), [], {}
    orig_loss, orig_step = agent.match_loss_total, agent.opt_model.step

    def loss_total(*a):
        out = orig_loss(*a)
        losses.append(float(out.detach()))
        return out

    def model_step(params, grads, state, *a, **k):
        seen["mp"] = params
        return orig_step(params, grads, state, *a, **k)

    with mock.patch.object(agent, "_sample_all_class_blocks",
                           lambda gen: blocks.pop(0)), \
            mock.patch.object(agent, "match_loss_total", loss_total), \
            mock.patch.object(agent.opt_model, "step", model_step), \
            mock.patch.object(agent.model, "init", lambda gen: w["mp"]), \
            (mock.patch.object(agent.opt_pge, "step", lambda *a, **k: None)
             if frozen else contextlib.nullcontext()):
        agent._epoch(feat, sc, opt_f, opt_p, update_pge=step_scorer)
    start = _state(w)
    change = {"feat": feat.detach() - start["feat"]}
    change.update({f"scorer.{n}": v.detach() - start["scorer"][n]
                   for n, v in _flat(sc).items()})
    change.update({f"mp.{n}": v.detach() - start["mp"][n]
                   for n, v in zip(sorted(start["mp"]), seen["mp"])})
    return losses, change


def _ref_epoch(w, step_scorer: bool, precision: str):
    r = RM.follow(w["g"], w["pools"], w["rcfg"],
                  R.Precision(precision, "cpu"), _state(w), w["samples"],
                  w["y"], w["sk"], w["classes"], w["budgets"],
                  epoch=0 if step_scorer else 10)
    assert r["bad"] == 0
    return r["losses"], r["change"], r["first"]


def _still(first) -> set:
    """Leaves whose first gradient is under ``NOUGHT`` of their group's
    largest leaf's: the biases in front of a BatchNorm, whose gradient is
    0 analytically, so that Adam moves them by ``±lr`` on signs rounding
    draws, on each side its own."""
    norms = {k: float(v.norm()) for k, v in first.items()}
    top = {}
    for k, v in norms.items():
        g = k.split(".")[0]
        top[g] = max(top.get(g, 0.0), v)
    return {k for k, v in norms.items() if v < NOUGHT * top[k.split(".")[0]]}


def _change_gaps(port, ref, first):
    """Per group, ``‖Δ_port − Δ_ref‖ / ‖Δ_ref‖`` over the leaves that
    move by their gradient."""
    still = _still(first)
    num, den = {}, {}
    for k in ref:
        if k in still:
            continue
        g = k.split(".")[0]
        num[g] = num.get(g, 0.0) + float(((port[k] - ref[k]) ** 2).sum())
        den[g] = den.get(g, 0.0) + float((ref[k] ** 2).sum())
    return {g: (num[g] / den[g]) ** 0.5 if den[g] else
            (0.0 if num[g] == 0 else float("inf")) for g in num}


@pytest.mark.parametrize("step_scorer", [True, False],
                         ids=["scorer_epoch", "feature_epoch"])
def test_three_outer_steps_match_the_reference(world, step_scorer):
    lp, cp = _port_epoch(world, step_scorer)
    lr, cr, first = _ref_epoch(world, step_scorer, "fp32")
    assert len(lp) == len(lr) == 3
    for a, b in zip(lp, lr):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    assert _still(first) == {"scorer.layers.0.b", "scorer.layers.1.b"}
    gaps = _change_gaps(cp, cr, first)
    assert {"scorer" if step_scorer else "feat", "mp"} <= set(gaps)
    for grp, gap in gaps.items():
        assert gap <= CHANGE_TOL, (grp, gap)


def test_the_reference_in_tf32_fails_a_tolerance(world):
    """The tolerances tell the card's TF32 from float32: the reference
    with TF32 products (rounded operands on the CPU) in the port's place
    fails every group's gradient and the scorer's change."""
    _, grad = _one_step_gaps(world, "tf32")
    assert all(gap > GRAD_TOL for gap in grad.values()), grad
    _, c32, first = _ref_epoch(world, True, "fp32")
    _, ctf, _ = _ref_epoch(world, True, "tf32")
    assert _change_gaps(ctf, c32, first)["scorer"] > CHANGE_TOL


def test_a_frozen_scorer_is_caught(world):
    _, cp = _port_epoch(world, True, frozen=True)
    _, cr, first = _ref_epoch(world, True, "fp32")
    assert _change_gaps(cp, cr, first)["scorer"] > CHANGE_TOL


# ---------------------------------------------------------------------------
# The skeletons' judge
# ---------------------------------------------------------------------------

def _triples(seed, n_syn=40, nclass=4, batch=3):
    from graphslim_tpu_torch.reduce.msgc import (build_skeletons,
                                                 proportional_labels)

    labels = np.random.default_rng(seed).integers(0, nclass, size=500)
    y = proportional_labels(labels, n_syn, nclass)
    return y, build_skeletons(y, nclass, batch, seed)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_the_judge_passes_the_ports_skeletons(seed):
    y, (rows, cols, batches) = _triples(seed)
    assert RM.judge_skeletons(rows, cols, batches, y, 4, 3) == 0


def _moved(rows, cols, batches, y):
    """Node 0's second link moved, both ways, to its first link's
    target: two links into one class."""
    assert rows[0] == rows[2]
    rows, cols = rows.copy(), cols.copy()
    cols[2] = rows[3] = cols[0]
    return rows, cols, batches


def _half_pair(rows, cols, batches, y):
    cols = cols.copy()
    cols[1] = (cols[1] + 1) % len(y)
    return rows, cols, batches


def _dropped(rows, cols, batches, y):
    keep = np.r_[0:10, 12:len(rows)]
    return rows[keep], cols[keep], batches[keep]


def _self_link(rows, cols, batches, y):
    rows, cols = rows.copy(), cols.copy()
    cols[0] = rows[0]
    rows[1] = rows[0]
    return rows, cols, batches


def _one_skeleton_short(rows, cols, batches, y):
    keep = batches != batches.max()
    return rows[keep], cols[keep], batches[keep]


@pytest.mark.parametrize("alter", [_moved, _half_pair, _dropped,
                                   _self_link, _one_skeleton_short])
def test_the_judge_fails_an_altered_skeleton(alter):
    y, triples = _triples(5)
    assert RM.judge_skeletons(*alter(*triples, y), y, 4, 3) > 0


# ---------------------------------------------------------------------------
# The two copies, and what they import
# ---------------------------------------------------------------------------

def test_the_benchmarks_copy_is_byte_equal():
    a = (REPO / "reference" / "msgc.py").read_bytes()
    b = (REPO / "gsbench" / "reference_msgc.py").read_bytes()
    assert a == b


def test_the_reference_imports_no_jax_and_no_port():
    code = ("import sys\nimport reference.msgc, gsbench.reference_msgc\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "graphslim_tpu",
                       "graphslim_tpu_torch"}
