"""The port's trainer, evaluator and pipeline against the JAX package
(CPU, synth-hard)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import models as JM
from graphslim_tpu.data import load as jload
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.graph import Reduced
from graphslim_tpu_torch.models.hoist import hoist_batch, hoist_plan
from graphslim_tpu_torch.train_all import run


@pytest.fixture(scope="module")
def twins():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


@pytest.mark.parametrize("name", ["GCN", "SGC"])
def test_fit_with_val_matches_jax(twins, name):
    """Same initial weights, same data: the loss curves agree to 1e-4
    relative (float32 Adam trajectories) and the best validation accuracy
    to within one validation node."""
    jds, tds = twins
    cfg = dict(nfeat=jds.n_feat, nhid=16, nclass=jds.nclass, nlayers=2,
               dropout=0.0, ntrans=1)
    jmodel = JM.get_model(name, JM.ModelConfig(**cfg))
    jp0 = jmodel.init(jax.random.key(0))
    tmodel = M.get_model(name, M.ModelConfig(**cfg))
    tp0 = model_params_from_jax(name, jax.tree.map(np.asarray, jp0),
                                device="cpu")

    def batch(ds, norm, idx, arr):
        i = arr(idx)
        return (ds.feat, norm, ds.labels[i], i)

    jn, tn = jds.adj_norm(), tds.adj_norm()
    jcfg = JM.TrainConfig(epochs=60, lr=0.01, weight_decay=5e-4)
    tcfg = M.TrainConfig(epochs=60, lr=0.01, weight_decay=5e-4)
    _, bv_j, loss_j = JM.fit_with_val(
        jmodel, jax.random.key(1),
        train=batch(jds, jn, jds.idx_train, jnp.asarray),
        val=batch(jds, jn, jds.idx_val, jnp.asarray), cfg=jcfg,
        params0=jp0)
    _, bv_t, loss_t = M.fit_with_val(
        tmodel, torch.Generator().manual_seed(1),
        train=batch(tds, tn, tds.idx_train, torch.as_tensor),
        val=batch(tds, tn, tds.idx_val, torch.as_tensor), cfg=tcfg,
        params0=tp0)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=1e-4)
    assert abs(float(bv_t) - float(bv_j)) <= 1.0 / len(tds.idx_val) + 1e-6


def test_hoisted_evaluation_equals_unhoisted(twins):
    """A^k [X|1] precomputed once gives the same SGC forward (1e-5)."""
    _, tds = twins
    model = M.get_model("SGC", M.ModelConfig(nfeat=tds.n_feat, nhid=16,
                                             nclass=tds.nclass))
    params = model.init(torch.Generator().manual_seed(0))
    adj = tds.adj_norm()
    idx = torch.as_tensor(tds.idx_test)
    full = model.apply(params, tds.feat, adj)[idx]
    hm, hops, keep = hoist_plan(model)
    x_pre, a_pre, _, i_pre = hoist_batch((tds.feat, adj, None, idx), hops,
                                         keep)
    torch.testing.assert_close(hm.apply(params, x_pre, a_pre), full,
                               rtol=1e-5, atol=1e-5)
    assert i_pre is None and x_pre.shape[0] == idx.shape[0]


def test_evaluator_scores_full_graph_coreset(twins):
    """Training SGC on the train nodes with their induced graph gives a
    test accuracy well above chance (5 classes) in both packages' range."""
    _, tds = twins
    args = finalize(Args(dataset="synth-hard", method="random",
                         run_eval=2, eval_epochs=60, device="cpu"),
                    explicit={"run_eval", "eval_epochs"})
    idx = torch.as_tensor(tds.idx_train)
    red = Reduced(feat=tds.feat[idx], adj=None, labels=tds.labels[idx])
    (mean, std), (accs, vals) = Evaluator(tds, args).evaluate(red, "SGC")
    assert accs.shape == (2,) and vals.shape == (2,)
    assert 0.4 < mean <= 1.0 and np.isfinite(std)


def test_train_all_run_completes_on_cpu(tmp_path):
    args = finalize(Args(dataset="synth-hard", method="gcond", epochs=1,
                         outer_loop=2, inner_loop=2, run_eval=1,
                         run_inter_eval=1, eval_epochs=20, device="cpu",
                         save_path=str(tmp_path)),
                    explicit={"outer_loop", "inner_loop", "run_inter_eval",
                              "eval_epochs"})
    mean, std = run(args)
    assert 0.0 <= mean <= 1.0 and np.isfinite(std)
    assert (tmp_path / "reduced_graph" / "random").is_dir()
