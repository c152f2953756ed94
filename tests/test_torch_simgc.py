"""The port's SimGC against the JAX package on synth-hard (CPU).

n_syn = 50, PGE nhid 32 in float32: the port on the plain version of the
PGE kernels, the JAX package with ``pallas_pge.pair_scores`` patched to
its pure-JAX tile oracle (as ``tests/test_torch_gcond.py`` does).  The
teacher is trained by the JAX package and carried across, with the
synthetic features, the PGE parameters and the hop statistics.

Tolerances: the hop statistics (per-class mean and std of ``[X, ÂX,
Â²X]``) 1e-5 of max; the step's loss 1e-4 relative; the updated leaves
1e-2 · lr + 1e-6 (Adam moves a leaf by at most about lr, and float32
rounding of the nested PGE gradient may flip a near-zero gradient's
step).  The PGE biases in front of a BatchNorm have gradient 0
analytically, so Adam turns their rounding noise into steps of either
sign on either side; they are left out of the leaf-wise comparison and
the updated PGE's output is compared instead (1e-4 relative).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.kernels import pallas_pge as pp
from graphslim_tpu.models.pge import PGE as JPGE, PGEConfig as JPGEConfig
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import (model_params_from_jax,
                                         pge_params_from_jax)
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.models.pge import PGE, PGEConfig
from graphslim_tpu_torch.reduce import create_reducer


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _oracle():
    return mock.patch.object(pp, "pair_scores",
                             lambda *a, **kw: pp.pair_scores_ref(*a[:8]))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("simgc"))
    common = dict(dataset="synth-hard", method="simgc", save_path=save,
                  hidden=16, epochs=1, eval_epochs=20)
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("simgc", jds, jfinalize(JArgs(**common), set(common)))
    teng = create_reducer("simgc", tds, finalize(
        Args(**common, device="cpu"), set(common)))
    n_syn, d = teng.n_syn, teng.d
    jeng.pge = JPGE(JPGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                               backend="pallas"))
    teng.pge = PGE(PGEConfig(nfeat=d, nnodes=n_syn, nhid=32, mm_bf16=False))
    teacher_j, tp_j = jeng._train_teacher(jds, False)
    teacher_t = M.get_model("SGC", M.ModelConfig(
        nfeat=d, nhid=16, nclass=tds.nclass, nlayers=2, dropout=0.0,
        ntrans=2))
    feat = (0.1 * np.random.default_rng(4).normal(size=(n_syn, d))
            ).astype(np.float32)
    return dict(jds=jds, tds=tds, jeng=jeng, teng=teng, teacher_j=teacher_j,
                tp_j=tp_j, teacher_t=teacher_t,
                tp_t=model_params_from_jax("SGC", _np(tp_j), device="cpu"),
                stats_j=jeng._concat_stats(jds), feat=feat,
                pge_j=jeng.pge.init(jax.random.key(2)))


def test_hop_statistics_match_jax(engines):
    e = engines
    got = e["teng"].concat_stats(e["tds"])
    for g, r in zip(got, e["stats_j"]):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_teacher_is_the_shallow_sgc_on_a_small_twin(engines):
    teacher = engines["teacher_j"]
    assert (teacher.cfg.ntrans, teacher.cfg.dropout) == (2, 0.0)
    assert engines["teng"].labels_syn.shape[0] == 50


@pytest.mark.parametrize("update_pge", [True, False])
def test_one_step_matches_jax(engines, update_pge):
    e = engines
    jeng, teng = e["jeng"], e["teng"]
    with _oracle():
        step = jeng._build_step(e["teacher_j"], e["tp_j"], e["stats_j"],
                                update_pge)
        fs_j = jnp.asarray(e["feat"])
        fs1, pg1, _, _, loss_j = step(fs_j, e["pge_j"],
                                      jeng.opt_feat.init(fs_j),
                                      jeng.opt_pge.init(e["pge_j"]))
    stats_t = tuple(torch.tensor(np.asarray(s)) for s in e["stats_j"])
    fs = torch.tensor(e["feat"], requires_grad=True)
    pg = utils.trainable(pge_params_from_jax(_np(e["pge_j"]), device="cpu"))
    loss_t = teng.step(e["teacher_t"], e["tp_t"], stats_t, fs, pg,
                       teng.opt_feat.init([fs]),
                       teng.opt_pge.init(utils.tree_leaves(pg)), update_pge)
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    lr = teng.args.lr_adj if update_pge else teng.args.lr_feat
    tol = 1e-2 * lr + 1e-6
    assert np.abs(fs.detach().numpy() - np.asarray(fs1)).max() <= tol
    n_layers = len(pg["layers"])
    for i in range(n_layers):
        for k in ("w",) + (("b",) if i == n_layers - 1 else ()):
            got = pg["layers"][i][k].detach().numpy()
            assert np.abs(got - np.asarray(pg1["layers"][i][k])).max() <= tol
    for i, bn in enumerate(pg["bns"]):
        for k in ("scale", "bias"):
            got = bn[k].detach().numpy()
            assert np.abs(got - np.asarray(pg1["bns"][i][k])).max() <= tol
    with _oracle():
        adj_j = np.asarray(jeng.pge.apply(pg1, fs1))
    adj_t = teng.pge.apply(pg, fs).detach().numpy()
    np.testing.assert_allclose(adj_t, adj_j, rtol=1e-4, atol=1e-5)
    moved = pg["layers"][0]["w"].detach().numpy() - np.asarray(
        e["pge_j"]["layers"][0]["w"]) if update_pge \
        else fs.detach().numpy() - e["feat"]
    assert np.abs(moved).max() > 0.5 * lr
