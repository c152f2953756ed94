"""The port's NAS evaluation against the JAX package's (CPU).

``pearson`` is the same NumPy arithmetic and must agree exactly.
``NasEvaluator`` runs a space of four APPNP architectures (K 2 and 4,
relu and tanh) at 30 epochs on a transductive and an inductive twin, on
the original graph and on a reduced one, with the JAX package's initial
draws handed in through ``NasEvaluator.init_params``.  The JAX package
validates a transductive graph through its ELL layout, the port through
the ``SparseAdj``: the sums differ in order only, so each architecture's
validation accuracy is held within two validation nodes of the JAX one;
the architectures keep their order, and the best architecture on each
graph is the JAX package's wherever the JAX accuracies separate it from
the runner-up by more than twice that.  ``Evaluator.nas_evaluate`` alone
is held the same way at ``runs=2``.
"""

import jax
import numpy as np
import pytest
from torch_shared import dataset_pair, reduced_pair
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import models as JM
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.eval import Evaluator as JEvaluator
from graphslim_tpu.eval import NasEvaluator as JNas
from graphslim_tpu.eval import nas as jnas_mod
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.eval import Evaluator, NasEvaluator
from graphslim_tpu_torch.eval import nas as nas_mod

SPACE = {"ks": [2, 4], "nhids": [16], "alphas": [0.1],
         "activations": ["relu", "tanh"]}
DATASETS = {"trans": "synth-hard", "ind": "synth-ind-small"}
SEED = 3


@pytest.fixture(scope="module")
def twins():
    out = {}
    for setting, name in DATASETS.items():
        jds, tds = dataset_pair(name)
        out[setting] = (jds, tds) + reduced_pair(jds, "dense", n=50)
    return out


def _args(name, tmp, **kw):
    base = dict(dataset=name, method="random", save_path=str(tmp),
                eval_epochs=30, seed=SEED)
    base.update(kw)
    return (jfinalize(JArgs(**base), set(base)),
            finalize(Args(**base, device="cpu"), set(base)))


def _jax_model(nfeat, nclass, arch):
    k, nhid, alpha, act = arch
    return JM.APPNP(JM.ModelConfig(nfeat=nfeat, nhid=nhid, nclass=nclass,
                                   nlayers=k, dropout=0.0, alpha=alpha,
                                   ntrans=2, activation=act))


def _carried(jmodel, key) -> dict:
    return model_params_from_jax(
        "APPNP", jax.tree.map(np.asarray, jmodel.init(key)), device="cpu")


def _n_val(tds) -> int:
    return tds.labels_val.shape[0] if tds.setting == "ind" \
        else len(tds.idx_val)


@pytest.mark.parametrize("seed", range(4))
def test_pearson_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.random(17), rng.random(17)
    if seed == 3:
        b = np.full(17, 0.5)            # zero variance: the 1e-12 floor
    assert nas_mod.pearson(a, b) == jnas_mod.pearson(a, b)


def test_spaces_equal_jax():
    assert nas_mod.FULL_SPACE == jnas_mod.FULL_SPACE
    assert nas_mod.QUICK_SPACE == jnas_mod.QUICK_SPACE
    assert len(NasEvaluator(None, None).combos) == 480


@pytest.mark.parametrize("setting", sorted(DATASETS))
def test_nas_correlation_matches_jax(twins, setting, tmp_path):
    jds, tds, jred, tred = twins[setting]
    jargs, targs = _args(tds.name, tmp_path)
    jnas = JNas(jds, jargs, space=SPACE)
    want = {"ori": jnas.evaluate_ori(), "syn": jnas.evaluate_syn(jred)}

    tnas = NasEvaluator(tds, targs, space=SPACE)
    assert tnas.combos == jnas.combos

    def init(arch, side, model, gen):
        # the JAX draws: fit_with_val's on the original graph, one run of
        # nas_evaluate's on the reduced one
        nfeat = model.cfg.nfeat
        key = jax.random.split(jax.random.key(SEED))[0] if side == "ori" \
            else jax.random.split(jax.random.split(
                jax.random.key(SEED), 1)[0])[0]
        return _carried(_jax_model(nfeat, tds.nclass, arch), key)
    tnas.init_params = init
    got = {}
    for side in ("ori", "syn"):
        fn = getattr(tnas, f"evaluate_{side}")

        def keep(*a, _fn=fn, _side=side):
            got[_side] = _fn(*a)
            return got[_side]
        setattr(tnas, f"evaluate_{side}", keep)
    res = tnas.correlation(tred)
    tol = 2.0 / _n_val(tds) + 1e-6
    for side, best in (("ori", "best_ori"), ("syn", "best_syn")):
        assert np.abs(got[side] - want[side]).max() <= tol
        top = np.sort(want[side])
        if top[-1] - top[-2] > 2 * tol:
            assert res[best] == jnas.combos[int(np.argmax(want[side]))]
    assert np.isfinite([res["pearson_acc"], res["pearson_rank"]]).all()


@pytest.mark.parametrize("setting", sorted(DATASETS))
def test_nas_evaluate_with_two_runs_matches_jax(twins, setting, tmp_path):
    jds, tds, jred, tred = twins[setting]
    jargs, targs = _args(tds.name, tmp_path)
    arch = (2, 16, 0.1, "relu")
    jmodel = _jax_model(tred.feat.shape[1], tds.nclass, arch)
    want = JEvaluator(jds, jargs).nas_evaluate(jred, jmodel, runs=2,
                                               seed=SEED)
    keys = jax.random.split(jax.random.key(SEED), 2)
    draws = [_carried(jmodel, jax.random.split(k)[0]) for k in keys]
    ev = Evaluator(tds, targs)
    ev.init_params = lambda mt, model, run, gen: draws[run]
    k, nhid, alpha, act = arch
    model = M.APPNP(M.ModelConfig(nfeat=tred.feat.shape[1], nhid=nhid,
                                  nclass=tds.nclass, nlayers=k, dropout=0.0,
                                  alpha=alpha, ntrans=2, activation=act))
    got = ev.nas_evaluate(tred, model, runs=2, seed=SEED)
    assert abs(got - want) <= 2.0 / _n_val(tds) + 1e-6
