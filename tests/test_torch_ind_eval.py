"""Metrics, the trainer, the evaluator and the pipeline of the port in the
inductive setting, against the JAX package (CPU, synth-ind-small: the
train, val and test subgraphs of 100, 150 and 550 nodes).

Tolerances: ``f1_macro`` and ``roc_auc`` to 1e-6; the evaluator's val and
test scores with the same converted parameters to 1e-6; the trainer's
loss curve on the train subgraph to 1e-4 relative (float32 Adam).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import models as JM
from graphslim_tpu import utils as JU
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.eval import Evaluator as JEvaluator
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import run_eval
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.graph import Reduced
from graphslim_tpu_torch.train_all import run


@pytest.fixture(scope="module")
def twins():
    return jload("synth-ind-small", seed=0), load("synth-ind-small", seed=0,
                                                  device="cpu")


def _logits(n, c, seed, skip_class=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    if skip_class is not None:      # no row predicts this class
        x[:, skip_class] = -1e3
    return x


@pytest.mark.parametrize("n,c,seed,skip", [(200, 5, 0, None),
                                           (57, 7, 1, 3),
                                           (300, 2, 2, None),
                                           (40, 4, 3, 0)])
def test_f1_macro_matches_jax(n, c, seed, skip):
    x = _logits(n, c, seed, skip)
    y = np.random.default_rng(seed + 10).integers(0, c, n)
    want = float(JU.f1_macro(jnp.asarray(x), jnp.asarray(y), c))
    got = utils.f1_macro(torch.tensor(x), torch.tensor(y), c)
    assert abs(got.item() - want) <= 1e-6
    # metric_fn picks it, and a leading batch axis is a batch of scores
    fn = utils.metric_fn("f1_macro", c)
    assert abs(fn(torch.tensor(x), torch.tensor(y)).item() - want) <= 1e-6
    both = fn(torch.tensor(np.stack([x, x])), torch.tensor(np.stack([y, y])))
    np.testing.assert_allclose(both.numpy(), [want, want], atol=1e-6)


@pytest.mark.parametrize("n,seed,ties", [(200, 0, False), (57, 1, True),
                                         (9, 2, False)])
def test_roc_auc_matches_jax(n, seed, ties):
    x = _logits(n, 2, seed)
    if ties:
        x[::3, 1] = 0.25
    y = np.random.default_rng(seed + 5).integers(0, 2, n)
    want = float(JU.metric_fn("roc_auc", 2)(jnp.asarray(x), jnp.asarray(y)))
    got = utils.metric_fn("roc_auc", 2)(torch.tensor(x), torch.tensor(y))
    assert abs(got.item() - want) <= 1e-6


def test_accuracy_is_the_default_metric():
    assert utils.metric_fn("accuracy", 3) is utils.accuracy


@pytest.mark.parametrize("name", ["GCN", "SGC"])
def test_fit_on_the_train_subgraph_matches_jax(twins, name):
    """Train on the train subgraph, validate on the val subgraph, both
    whole (``idx=None``): the loss curves agree to 1e-4 relative."""
    jds, tds = twins
    cfg = dict(nfeat=jds.n_feat, nhid=16, nclass=jds.nclass, nlayers=2,
               dropout=0.0, ntrans=1)
    jmodel = JM.get_model(name, JM.ModelConfig(**cfg))
    jp0 = jmodel.init(jax.random.key(0))
    tp0 = model_params_from_jax(name, jax.tree.map(np.asarray, jp0),
                                device="cpu")
    from graphslim_tpu import graph as JG

    jtrain = (jds.feat_train, JG.gcn_norm(jds.adj_train), jds.labels_train,
              None)
    jval = (jds.feat_val, JG.gcn_norm(jds.adj_val), jds.labels_val, None)
    _, bv_j, loss_j = JM.fit_with_val(
        jmodel, jax.random.key(1), train=jtrain, val=jval,
        cfg=JM.TrainConfig(epochs=60), params0=jp0)
    _, bv_t, loss_t = M.fit_with_val(
        M.get_model(name, M.ModelConfig(**cfg)),
        torch.Generator().manual_seed(1), train=tds.split_batch("train"),
        val=tds.split_batch("val"), cfg=M.TrainConfig(epochs=60),
        params0=tp0)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4)
    assert abs(float(bv_t) - float(bv_j)) <= 1.0 / len(tds.idx_val) + 1e-6


@pytest.mark.parametrize("model_type", ["GCN", "SGC"])
@pytest.mark.parametrize("metric", ["accuracy", "f1_macro"])
def test_evaluator_scores_equal_jax(twins, tmp_path, model_type, metric):
    """The same parameters score the same on the val and test subgraphs
    (1e-6), and ``evaluate`` (hoisted, the subgraphs whole) reports the
    JAX package's test score of those parameters."""
    jds, tds = twins
    base = dict(dataset="synth-ind-small", method="random",
                save_path=str(tmp_path), run_eval=2, eval_epochs=5)
    jargs = jfinalize(JArgs(**base), set(base)).replace(metric=metric)
    targs = finalize(Args(**base, device="cpu"), set(base)).replace(
        metric=metric)
    assert targs.setting == "ind"
    jev, tev = JEvaluator(jds, jargs), Evaluator(tds, targs)
    jmodel = jev._eval_model(model_type, jds.n_feat)
    tmodel = tev._eval_model(model_type, tds.n_feat)
    jp = jmodel.init(jax.random.key(3))
    tp = model_params_from_jax(model_type, jax.tree.map(np.asarray, jp),
                               device="cpu")
    scores = {}
    for split, jt in (("val", jev._val_tuple(model_type)),
                      ("test", jev._test_tuple(model_type))):
        tt = tds.split_batch(split)
        assert tt[3] is None and jt[3] is None
        want = float(JM.evaluate(jmodel, jp, *jt, metric=metric))
        got = M.evaluate(tmodel, tp, *tt, metric=metric).item()
        assert abs(got - want) <= 1e-6, (split, got, want)
        scores[split] = want
    idx = torch.as_tensor(tds.idx_train[:40])
    red = Reduced(feat=tds.feat[idx], adj=None, labels=tds.labels[idx])
    with mock.patch.object(M, "fit_with_val", lambda model, gen, **kw: (
            tp, torch.tensor(0.5), None)):
        (mean, std), (accs, _) = tev.evaluate(red, model_type)
    np.testing.assert_allclose(accs, [scores["test"]] * 2, atol=1e-6)


def test_subgraph_norms_are_built_once_per_dataset(twins, tmp_path):
    """Every evaluation reuses the dataset's cached normalized val and
    test subgraphs."""
    _, tds = twins
    args = finalize(Args(dataset="synth-ind-small", method="random",
                         run_eval=2, eval_epochs=5, device="cpu",
                         save_path=str(tmp_path)),
                    explicit={"run_eval", "eval_epochs"})
    idx = torch.as_tensor(tds.idx_train[:40])
    red = Reduced(feat=tds.feat[idx], adj=None, labels=tds.labels[idx])
    norms = (tds.view_norm("val"), tds.view_norm("test"))
    for _ in range(2):
        Evaluator(tds, args).evaluate(red, "GCN")
    assert tds.view_norm("val") is norms[0]
    assert tds.view_norm("test") is norms[1]


@pytest.mark.parametrize("method", ["gcond", "kcenter"])
def test_pipeline_and_run_eval_on_the_inductive_twin(tmp_path, method):
    """``train_all.run`` on synth-ind-small, then ``run_eval`` reads the
    saved artifact back and scores it."""
    args = finalize(Args(dataset="synth-ind-small", method=method,
                         epochs=2, outer_loop=2, inner_loop=1, run_eval=1,
                         run_inter_eval=1, eval_epochs=20, device="cpu",
                         save_path=str(tmp_path)),
                    explicit={"outer_loop", "inner_loop", "run_inter_eval",
                              "eval_epochs", "run_eval"})
    assert args.setting == "ind" and args.reduction_rate == 0.25
    mean, _ = run(args)
    assert 0.4 < mean <= 1.0
    mean2, std2 = run_eval.main(
        ["-D", "synth-ind-small", "-M", method, "--device", "cpu",
         "--save_path", str(tmp_path), "--run_eval", "1",
         "--eval_epochs", "20"])
    assert 0.4 < mean2 <= 1.0 and np.isfinite(std2)


def test_yelp_style_metric_runs_end_to_end(twins, tmp_path):
    """A run scored by macro F1 (the metric yelp and amazon force)."""
    _, tds = twins
    args = finalize(Args(dataset="synth-ind-small", method="averaging",
                         run_eval=1, eval_epochs=20, device="cpu",
                         save_path=str(tmp_path)),
                    explicit={"run_eval", "eval_epochs"}).replace(
                        metric="f1_macro")
    assert finalize(Args(dataset="yelp")).metric == "f1_macro"
    idx = torch.as_tensor(tds.idx_train)
    red = Reduced(feat=tds.feat[idx], adj=None, labels=tds.labels[idx])
    (mean, _), _ = Evaluator(tds, args).evaluate(red, "GCN")
    assert 0.3 < mean <= 1.0
