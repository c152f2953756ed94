"""Soft labels through the port's trainer and artifact store, the
``ravel_pytree`` flat layout, and the five distillation methods end to end
(CPU, synth-hard).

* ``fit_with_val`` on 2-D labels against the JAX trainer with
  ``loss="soft"``, from the same weights: loss curves within 1e-4
  (relative), best validation accuracy within one validation node.
* Artifacts: float labels come back float32 and equal, hard labels int64
  and equal; a soft-label artifact written by either package reads the
  same in the other.
* ``convert.unflatten_params`` of a JAX-flattened vector gives leaves
  equal to ``ravel_pytree``'s unravel, and ``flatten_params`` the same
  vector.
* ``train_all.run`` for gcsntk, simgc, sfgc, geom and gdem at a tiny
  depth, and ``run_eval`` on the soft-label artifacts (GCSNTK's, GEOM's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import graph as JG
from graphslim_tpu import models as JM
from graphslim_tpu.data import load as jload
from graphslim_tpu.data import load_reduced as jload_reduced
from graphslim_tpu.data import save_reduced as jsave_reduced
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import run_eval
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import (flatten_params,
                                         model_params_from_jax,
                                         unflatten_params)
from graphslim_tpu_torch.data import load, load_reduced, save_reduced
from graphslim_tpu_torch.graph import Reduced
from graphslim_tpu_torch.train_all import run


@pytest.fixture(scope="module")
def twins():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


@pytest.mark.parametrize("name", ["GCN", "SGC"])
def test_fit_with_val_on_soft_labels_matches_jax(twins, name):
    jds, tds = twins
    cfg = dict(nfeat=jds.n_feat, nhid=16, nclass=jds.nclass, nlayers=2,
               dropout=0.0, ntrans=1)
    jmodel = JM.get_model(name, JM.ModelConfig(**cfg))
    jp0 = jmodel.init(jax.random.key(0))
    tmodel = M.get_model(name, M.ModelConfig(**cfg))
    tp0 = model_params_from_jax(name, jax.tree.map(np.asarray, jp0),
                                device="cpu")
    idx = np.asarray(jds.idx_train)
    soft = np.random.default_rng(0).dirichlet(
        np.ones(jds.nclass), size=idx.shape[0]).astype(np.float32)
    jn, tn = jds.adj_norm(), tds.adj_norm()
    vj, vt = jnp.asarray(jds.idx_val), torch.as_tensor(tds.idx_val)
    _, bv_j, loss_j = JM.fit_with_val(
        jmodel, jax.random.key(1),
        train=(jds.feat, jn, jnp.asarray(soft), jnp.asarray(idx)),
        val=(jds.feat, jn, jds.labels[vj], vj),
        cfg=JM.TrainConfig(epochs=40, lr=0.01, weight_decay=5e-4,
                           loss="soft"), params0=jp0)
    _, bv_t, loss_t = M.fit_with_val(
        tmodel, torch.Generator().manual_seed(1),
        train=(tds.feat, tn, torch.tensor(soft), torch.as_tensor(idx)),
        val=(tds.feat, tn, tds.labels[vt], vt),
        cfg=M.TrainConfig(epochs=40, lr=0.01, weight_decay=5e-4),
        params0=tp0)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4)
    assert abs(float(bv_t) - float(bv_j)) <= 1.0 / len(tds.idx_val) + 1e-6


@pytest.mark.parametrize("loss", ["mse", "bce"])
def test_losses_of_the_rest_of_the_zoo_are_refused(twins, loss):
    """No longer refused: the ``mse`` and ``bce`` losses train as the JAX
    trainer does, from the same weights (loss curves within 1e-4
    relative).  The reference's MSE subtracts the label vector from the
    log-probabilities with broadcasting, so it is taken on as many train
    rows as there are classes."""
    jds, tds = twins
    cfg = dict(nfeat=jds.n_feat, nhid=8, nclass=jds.nclass, dropout=0.0)
    jmodel = JM.get_model("SGC", JM.ModelConfig(**cfg))
    jp0 = jmodel.init(jax.random.key(0))
    tp0 = model_params_from_jax("SGC", jax.tree.map(np.asarray, jp0),
                                device="cpu")
    idx = np.asarray(tds.idx_train)[:jds.nclass if loss == "mse" else None]
    jn, tn = jds.adj_norm(), tds.adj_norm()
    _, _, loss_j = JM.fit_with_val(
        jmodel, jax.random.key(1),
        train=(jds.feat, jn, jds.labels[jnp.asarray(idx)], jnp.asarray(idx)),
        val=(jds.feat, jn, jds.labels[jnp.asarray(idx)], jnp.asarray(idx)),
        cfg=JM.TrainConfig(epochs=5, loss=loss), params0=jp0)
    ti = torch.as_tensor(idx)
    batch = (tds.feat, tn, tds.labels[ti], ti)
    _, _, loss_t = M.fit_with_val(
        M.get_model("SGC", M.ModelConfig(**cfg)),
        torch.Generator().manual_seed(0), train=batch, val=batch,
        cfg=M.TrainConfig(epochs=5, loss=loss), params0=tp0)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4)


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_artifact_labels_keep_their_type(tmp_path, kind):
    rng = np.random.default_rng(0)
    feat = torch.tensor(rng.normal(size=(6, 4)).astype(np.float32))
    labels = torch.softmax(torch.tensor(rng.normal(size=(6, 3))), 1).float() \
        if kind == "soft" else torch.tensor([0, 2, 1, 1, 0, 2])
    save_reduced(Reduced(feat=feat, adj=None, labels=labels),
                 str(tmp_path), "geom", "synth-hard", 0.5, 1)
    back = load_reduced(str(tmp_path), "geom", "synth-hard", 0.5, 1,
                        device="cpu")
    assert back.labels.dtype == (torch.float32 if kind == "soft"
                                 else torch.int64)
    assert torch.equal(back.labels, labels) and back.adj is None
    # the JAX package reads it as written
    jback = jload_reduced(str(tmp_path), "geom", "synth-hard", 0.5, 1)
    np.testing.assert_array_equal(np.asarray(jback.labels), labels.numpy())


def test_jax_soft_label_artifact_reads_in_the_port(tmp_path):
    soft = np.random.default_rng(1).dirichlet(np.ones(5), 7).astype(
        np.float32)
    jsave_reduced(JG.Reduced(feat=jnp.ones((7, 3)), adj=None,
                             labels=jnp.asarray(soft)),
                  str(tmp_path), "gcsntk", "synth-hard", 0.5, 1)
    back = load_reduced(str(tmp_path), "gcsntk", "synth-hard", 0.5, 1,
                        device="cpu")
    assert back.labels.dtype == torch.float32
    np.testing.assert_array_equal(back.labels.numpy(), soft)


@pytest.mark.parametrize("name,bn", [("GCN", False), ("SGC", True)])
def test_flat_layout_is_ravel_pytrees(name, bn):
    cfg = dict(nfeat=6, nhid=5, nclass=3, nlayers=2, ntrans=2, with_bn=bn)
    jp = JM.get_model(name, JM.ModelConfig(**cfg)).init(jax.random.key(3))
    jp = jax.tree.map(lambda a: a + jnp.arange(a.size).reshape(a.shape)
                      * 1e-3, jp)         # BatchNorm leaves not constant
    flat, unravel = ravel_pytree(jp)
    like = model_params_from_jax(name, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    got = unflatten_params(torch.tensor(np.asarray(flat)), like)
    ref = jax.tree.map(np.asarray, unravel(flat))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, ref))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(g.numpy(), r)
    np.testing.assert_array_equal(flatten_params(like).numpy(),
                                  np.asarray(flat))
    with pytest.raises(ValueError, match="tree"):
        unflatten_params(torch.zeros(flat.shape[0] + 1), like)


DEPTH = {"gcsntk": {}, "simgc": {}, "gdem": {},
         "sfgc": dict(teacher_epochs=20, num_experts=2, syn_steps=3),
         "geom": dict(teacher_epochs=20, num_experts=2, syn_steps=3)}


@pytest.mark.parametrize("method", sorted(DEPTH))
def test_train_all_and_run_eval_run_each_method(tmp_path, method):
    kw = dict(epochs=2, hidden=16, run_eval=1, run_inter_eval=1,
              eval_epochs=20, **DEPTH[method])
    args = finalize(Args(dataset="synth-hard", method=method, device="cpu",
                         save_path=str(tmp_path), **kw), set(kw))
    mean, std = run(args)
    assert 0.0 <= mean <= 1.0 and np.isfinite(std)
    red = load_reduced(str(tmp_path), method, "synth-hard",
                       args.reduction_rate, args.seed, device="cpu")
    assert torch.isfinite(red.feat).all()
    if method in ("gcsntk", "geom"):
        assert red.labels.dtype == torch.float32 and red.labels.ndim == 2
        mean2, _ = run_eval.main(["-D", "synth-hard", "-M", method,
                                  "--device", "cpu", "--save_path",
                                  str(tmp_path), "--run_eval", "1",
                                  "--eval_epochs", "20", "--hidden", "16"])
        assert 0.0 <= mean2 <= 1.0
