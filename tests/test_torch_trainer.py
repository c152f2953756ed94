"""The port's trainer against the JAX package's (CPU, synth-hard): the
``mse`` and ``bce`` losses, ``fit_with_val`` for every model of the zoo,
``fit_multi_seed`` and ``prepare_adj``.

* ``_loss`` against ``_loss_fn`` on the same log-probabilities: 1e-6
  (the reference's MSE subtracts the label vector with broadcasting; its
  BCE takes the first output column as a logit).
* ``fit_with_val``, 12 epochs at dropout 0 from the same (carried)
  weights, for each of the eight models: loss curves within 1e-4
  relative (float32 Adam trajectories), best validation accuracy within
  one validation node, and the returned parameters' outputs within 1e-3
  of the largest.  Parameters are compared through their outputs, not
  leaf by leaf: Adam turns a gradient at rounding level into a step of
  up to lr on either side (ROADMAP §3).
* ``fit_multi_seed`` stacks exactly what ``fit_with_val`` gives seed by
  seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import models as JM
from graphslim_tpu.data import load as jload
from graphslim_tpu.models.trainer import TrainConfig as JTC, _loss_fn
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.models.trainer import _loss
from graphslim_tpu_torch.utils import tree_leaves

MODELS = ["MLP", "GCN", "SGC", "APPNP", "Cheby", "GraphSage", "GAT",
          "SGFormer"]


@pytest.fixture(scope="module")
def twins():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


@pytest.mark.parametrize("loss,shape,yshape", [
    ("mse", (5, 5), (5,)), ("mse", (7, 3), (3,)), ("bce", (8, 1), (8,)),
    ("bce", (8, 3), (8,)), ("bce", (8,), (8,))])
def test_losses_match_jax(loss, shape, yshape):
    rng = np.random.default_rng(0)
    lp = rng.normal(size=shape).astype(np.float32) * 3
    y = rng.integers(0, 2 if loss == "bce" else 3, size=yshape)
    want = float(_loss_fn(JTC(loss=loss), jnp.asarray(lp), jnp.asarray(y),
                          None))
    got = float(_loss(M.TrainConfig(loss=loss), torch.tensor(lp),
                      torch.tensor(y)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def _batches(ds, norm, arr):
    ti, vi = arr(ds.idx_train), arr(ds.idx_val)
    return ((ds.feat, norm, ds.labels[ti], ti),
            (ds.feat, norm, ds.labels[vi], vi))


@pytest.mark.parametrize("name", MODELS)
def test_fit_with_val_matches_jax(twins, name):
    jds, tds = twins
    cfg = dict(nfeat=jds.n_feat, nhid=16, nclass=jds.nclass, nlayers=2,
               dropout=0.0, nheads=4, trans_layers=1)
    jmodel = JM.get_model(name, JM.ModelConfig(**cfg))
    jp0 = jmodel.init(jax.random.key(0))
    tmodel = M.get_model(name, M.ModelConfig(**cfg))
    tp0 = model_params_from_jax(name, jax.tree.map(np.asarray, jp0),
                                device="cpu")
    jtrain, jval = _batches(jds, jds.adj_norm(), jnp.asarray)
    ttrain, tval = _batches(tds, tds.adj_norm(), torch.as_tensor)
    jbest, bv_j, loss_j = JM.fit_with_val(
        jmodel, jax.random.key(1), train=jtrain, val=jval,
        cfg=JM.TrainConfig(epochs=12), params0=jp0)
    tbest, bv_t, loss_t = M.fit_with_val(
        tmodel, torch.Generator().manual_seed(1), train=ttrain, val=tval,
        cfg=M.TrainConfig(epochs=12), params0=tp0)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4)
    assert abs(float(bv_t) - float(bv_j)) <= 1.0 / len(tds.idx_val) + 1e-6
    want = np.asarray(jax.jit(lambda p: jmodel.apply(
        p, jds.feat, jds.adj_norm()))(jbest))
    got = tmodel.apply(tbest, tds.feat, tds.adj_norm()).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_fit_multi_seed_stacks_its_per_seed_fits(twins):
    _, tds = twins
    model = M.get_model("APPNP", M.ModelConfig(nfeat=tds.n_feat, nhid=16,
                                               nclass=tds.nclass))
    train, val = _batches(tds, tds.adj_norm(), torch.as_tensor)
    cfg = M.TrainConfig(epochs=6)
    params, best, losses = M.fit_multi_seed(
        model, [torch.Generator().manual_seed(s) for s in (3, 4)],
        train=train, val=val, cfg=cfg)
    assert best.shape == (2,) and losses.shape == (2, 6)
    for i, s in enumerate((3, 4)):
        p, b, l_ = M.fit_with_val(model, torch.Generator().manual_seed(s),
                                  train=train, val=val, cfg=cfg)
        assert torch.equal(best[i], b) and torch.equal(losses[i], l_)
        for stacked, leaf in zip(tree_leaves(params), tree_leaves(p)):
            assert torch.equal(stacked[i], leaf)


def test_prepare_adj_matches_jax(twins):
    from graphslim_tpu.models.trainer import prepare_adj as jprep

    jds, tds = twins
    sp_j, sp_t = jprep(jds.adj), M.prepare_adj(tds.adj)
    np.testing.assert_array_equal(sp_t.col.numpy(), np.asarray(sp_j.col))
    np.testing.assert_allclose(sp_t.val.numpy(), np.asarray(sp_j.val),
                               rtol=1e-6)
    dense = np.asarray(jds.adj.to_dense())[:50, :50]
    np.testing.assert_allclose(
        M.prepare_adj(torch.tensor(dense)).numpy(),
        np.asarray(jprep(jnp.asarray(dense))), rtol=1e-6, atol=1e-7)
    assert M.prepare_adj(None) is None
