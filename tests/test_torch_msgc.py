"""MSGC in the port against the JAX package (CPU, synth-hard at r = 0.5:
50 synthetic nodes, a batch of B = 3 skeletons).

``proportional_labels`` and ``build_skeletons`` are host NumPy on both
sides and must be identical for every seed.  The edge scorer's weights are
carried across (``convert.pge_params_from_jax``: the scorer has the
PGE's parameter layout) and the [B, n, n] normalized batch agrees to 1e-5
relative.  One outer step, set up as in
``tests/test_torch_gcond.py`` (the same sampled blocks, drawn by the JAX
sampler, and the same model init injected into both engines): the match
loss agrees to 1e-4 relative, the gradient with respect to the features to
1e-4 of its largest entry and the scorer's gradients to 1e-4 of the
largest scorer gradient entry (the biases in front of a BatchNorm have
gradient 0 analytically, rounding noise on both sides).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu.reduce import msgc as jmsgc
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import (model_params_from_jax,
                                         pge_params_from_jax)
from graphslim_tpu_torch.data import load, load_reduced, save_reduced
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.models import hoist
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce import msgc as tmsgc

B = 3


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("msgc"))
    common = dict(dataset="synth-hard", method="msgc", save_path=save,
                  hidden=16, ntrans=2, outer_loop=2, inner_loop=2,
                  epochs=2, batch_adj=B, eval_epochs=20, run_eval=1)
    explicit = set(common) - {"dataset", "method", "save_path"}
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("msgc", jds, jfinalize(JArgs(**common), explicit))
    targs = finalize(Args(**common, device="cpu"), explicit)
    teng = create_reducer("msgc", tds, targs)
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    sc_j = jeng.pge_init(jax.random.key(2))
    ids, ws, targets, valid = jeng._sample_all_class_blocks(
        jax.random.key(3))
    blocks_t = (tuple(torch.tensor(np.asarray(i), dtype=torch.int64)
                      for i in ids),
                tuple(torch.tensor(np.asarray(w)) for w in ws),
                torch.tensor(np.asarray(targets), dtype=torch.int64),
                torch.tensor(np.asarray(valid)))
    return dict(jeng=jeng, teng=teng, tds=tds, targs=targs, feat=feat,
                mp_j=mp_j, sc_j=sc_j, blocks_j=(ids, ws, targets, valid),
                blocks_t=blocks_t)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_labels_and_skeletons_identical(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 5, size=120)
    y_j = jmsgc.proportional_labels(labels, 37, 5)
    y_t = tmsgc.proportional_labels(labels, 37, 5)
    np.testing.assert_array_equal(y_t, y_j)
    for got, want in zip(tmsgc.build_skeletons(y_t, 5, B, seed),
                         jmsgc.build_skeletons(y_j, 5, B, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_engines_agree_on_budgets(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    assert teng.n_syn == jeng.n_syn == 50 and teng.batch_size == B
    np.testing.assert_array_equal(teng.labels_syn.numpy(),
                                  np.asarray(jeng.labels_syn))
    np.testing.assert_array_equal(teng.class_masks.numpy(),
                                  np.asarray(jeng.class_masks))
    np.testing.assert_allclose(teng.coeffs.numpy(), np.asarray(jeng.coeffs))
    for a, b in zip((teng.rows, teng.cols, teng.batches),
                    (jeng.rows, jeng.cols, jeng.batches)):
        np.testing.assert_array_equal(a, b)


def test_init_feat_syn_runs_the_init_on_the_untiled_labels(engines):
    """synth-hard's msgc config (cora's) starts from ``averaging``: the
    per-class means, identical on both sides to float32 rounding."""
    teng = engines["teng"]
    assert teng.args.init == "averaging"
    feat = teng.init_feat_syn().numpy()
    np.testing.assert_allclose(feat, engines["feat"], rtol=1e-6,
                               atol=1e-7)


def test_adj_batch_matches_jax(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    feat = engines["feat"]
    # the skeletons hold duplicate entries, whose later score wins
    keys = (teng.batches.astype(np.int64) * teng.n_syn
            + teng.rows) * teng.n_syn + teng.cols
    assert np.unique(keys).shape[0] < keys.shape[0]
    want = np.asarray(jeng.get_adj_batch(engines["sc_j"], jnp.asarray(feat)))
    got = teng.get_adj_batch(pge_params_from_jax(
        _np(engines["sc_j"]), device="cpu"), torch.tensor(feat))
    assert got.shape == (B, 50, 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_outer_step_loss_and_gradients_match_jax(engines):
    e = engines
    jeng, teng = e["jeng"], e["teng"]
    mp_t = model_params_from_jax("SGC", _np(e["mp_j"]), device="cpu")
    with mock.patch.object(jeng, "_sample_all_class_blocks",
                           lambda key, real=None: e["blocks_j"]), \
            mock.patch.object(teng, "_sample_all_class_blocks",
                              lambda gen: e["blocks_t"]):
        def objective(fs, sc):
            adj, aux = jeng.generator_forward(sc, fs)
            return jeng.match_loss_total(e["mp_j"], fs, adj,
                                         jax.random.key(0)) + aux

        loss_j, (gf_j, gs_j) = jax.value_and_grad(
            objective, argnums=(0, 1))(jnp.asarray(e["feat"]), e["sc_j"])
        fs = torch.tensor(e["feat"], requires_grad=True)
        sc = utils.trainable(pge_params_from_jax(_np(e["sc_j"]),
                                                 device="cpu"))
        adj, aux = teng.generator_forward(sc, fs)
        loss_t = teng.match_loss_total(mp_t, fs, adj, teng.gen) + aux
        grads = torch.autograd.grad(loss_t, [fs] + utils.tree_leaves(sc))
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    want = [np.asarray(gf_j)] + [np.asarray(g)
                                 for g in jax.tree.leaves(gs_j)]
    assert len(want) == len(grads)
    scorer_scale = max(np.abs(g).max() for g in want[1:])
    for i, (got, ref) in enumerate(zip(grads, want)):
        assert got.shape == ref.shape
        err = np.abs(got.numpy() - ref).max()
        scale = np.abs(ref).max() if i == 0 else scorer_scale
        assert err <= 1e-4 * scale, (i, err, scale)


def test_batched_reduced_evaluates_and_round_trips(engines, tmp_path):
    """A Reduced with a [B, n, n] adjacency and B·n labels: the evaluator
    trains on it without hoisting, and save/load gives it back."""
    e = engines
    teng, tds, targs = e["teng"], e["tds"], e["targs"]
    sc = pge_params_from_jax(_np(e["sc_j"]), device="cpu")
    feat = torch.tensor(e["feat"])
    red = G.Reduced(feat=feat, adj=teng.inference_adj(sc, feat),
                    labels=teng.labels_syn)
    with mock.patch("graphslim_tpu_torch.eval.evaluator.hoist_plan",
                    side_effect=AssertionError("hoisted")):
        (acc, std), (accs, _) = Evaluator(tds, targs).evaluate(red, "GCN")
    assert np.isfinite(acc) and accs.shape == (1,) and 0 < acc <= 1
    # a skeleton batch is left to the models; the flattening lines the
    # output up with the tiled labels
    model = Evaluator(tds, targs)._eval_model("GCN", tds.n_feat)
    out = model.apply(model.init(torch.Generator().manual_seed(0)), feat,
                      red.adj)
    assert out.shape == (B * 50, tds.nclass)
    assert hoist.hoist_plan(model) is not None
    save_reduced(red, str(tmp_path), "msgc", tds.name, 0.5, 1)
    back = load_reduced(str(tmp_path), "msgc", tds.name, 0.5, 1,
                        device="cpu")
    assert torch.equal(back.feat, red.feat)
    assert torch.equal(back.adj, red.adj) and back.adj.shape == (B, 50, 50)
    assert torch.equal(back.labels, red.labels)


@pytest.mark.parametrize("init", ["averaging", "clustering"])
def test_whole_run(engines, init):
    """Two epochs through the GCond engine with a checkpoint at epoch 1,
    from either init of MSGC's paper configs: the window average is
    evaluated and the result is the batched triple."""
    tds, targs = engines["tds"], engines["targs"]
    eng = create_reducer("msgc", tds, targs.replace(checkpoints=(1,),
                                                    init=init))
    red = eng.reduce(tds)
    assert len(eng._window) == 1 and len(eng.epoch_loss_sums) == 2
    assert red.feat.shape == (50, tds.n_feat)
    assert red.adj.shape == (B, 50, 50) and red.labels.shape == (B * 50,)
    assert torch.isfinite(red.feat).all() and torch.isfinite(red.adj).all()
    assert all(torch.isfinite(x) for x in eng.epoch_loss_sums)
