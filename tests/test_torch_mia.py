"""The port's membership-inference attack against the JAX package's (CPU).

``inference_via_confidence`` is a float64 NumPy copy and must give the JAX
function's result exactly, ties included.  ``mia_attack`` runs the same
GCN parameters (the JAX package's draw, carried across by ``convert``) on
a transductive and an inductive twin.  The JAX package takes the full
graph's ELL layout, the port its ``SparseAdj`` (the blocked SpMM on the
card), so the log-probabilities differ in summation order only: the
attack's accuracy is held within 1 / min(n_train, n_test), one member's
or non-member's side of a threshold.
"""

import jax
import numpy as np
import pytest
from torch_shared import dataset_pair
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import models as JM
from graphslim_tpu.eval import inference_via_confidence as j_ivc
from graphslim_tpu.eval import mia_attack as j_mia
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.eval import inference_via_confidence, mia_attack


@pytest.mark.parametrize("seed", range(6))
def test_inference_via_confidence_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n_tr, n_te, c = rng.integers(1, 60, size=2).tolist() + [5]
    # rounded confidences: many ties within and across the two sides
    conf_tr = np.round(rng.random((n_tr, c)), 1 + seed % 3).astype(
        np.float32)
    conf_te = np.round(rng.random((n_te, c)), 1 + seed % 3).astype(
        np.float32)
    y_tr = rng.integers(0, c, n_tr)
    y_te = rng.integers(0, c, n_te)
    want = j_ivc(conf_tr, conf_te, y_tr, y_te)
    assert inference_via_confidence(conf_tr, conf_te, y_tr, y_te) == want


def test_inference_via_confidence_floor_and_separation():
    conf = np.eye(3, dtype=np.float32)
    # members certain, non-members not: perfect separation
    assert inference_via_confidence(conf, 1 - conf, np.arange(3),
                                    np.arange(3)) == 1.0
    # identical distributions: no better than chance
    assert inference_via_confidence(conf, conf, np.arange(3),
                                    np.arange(3)) == 0.5


@pytest.mark.parametrize("name", ["synth-hard", "synth-ind-small"])
def test_mia_attack_matches_jax(name):
    jds, tds = dataset_pair(name)
    cfg = dict(nfeat=tds.n_feat, nhid=32, nclass=tds.nclass, dropout=0.0)
    jmodel = JM.GCN(JM.ModelConfig(**cfg))
    jparams = jmodel.init(jax.random.key(7))
    want = j_mia(jmodel, jparams, jds)
    model = M.GCN(M.ModelConfig(**cfg))
    params = model_params_from_jax(
        "GCN", jax.tree.map(np.asarray, jparams), device="cpu")
    got = mia_attack(model, params, tds)
    if tds.setting == "ind":
        n = min(tds.labels_train.shape[0], tds.labels_test.shape[0])
    else:
        n = min(len(tds.idx_train), len(tds.idx_test))
    assert 0.5 <= got <= 1.0
    assert abs(got - want) <= 1.0 / n + 1e-9
