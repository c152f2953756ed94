"""GCSNTK, SimGC, SFGC, GEOM and GDEM of the port in the inductive
setting, against the JAX package (CPU, synth-ind-small at r = 0.25: a
train subgraph of 100 nodes).

Each reads the train subgraph where its transductive form reads the full
graph's train rows; the comparisons and tolerances are those of its
transductive test, through the same seams (GCSNTK's ``init_syn``, the
experts' inits of SFGC and GEOM, GDEM's initial eigenvectors and its
eigen cache, SimGC's teacher weights): GCSNTK's batches exactly and its
epoch to 1 % of lr; SimGC's hop statistics to 1e-5 and one step to 1e-4;
the expert buffers to 1e-4 of their largest entry; GEOM's curriculum
order exactly; GDEM's eigenbasis to 1e-6 and its epoch to 1 % of lr.
"""

import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import models as JM
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

NAME = "synth-ind-small"


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def twins():
    return jload(NAME, seed=0), load(NAME, seed=0, device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(method, twins, tmp_path, **kw):
    jds, tds = twins
    common = dict(dataset=NAME, method=method, epochs=1, eval_epochs=20,
                  **kw)
    jeng = jcreate(method, jds, jfinalize(JArgs(
        **common, save_path=str(tmp_path / "j")), set(common))
        .replace(checkpoints=()))
    teng = create_reducer(method, tds, finalize(Args(
        **common, save_path=str(tmp_path / "t"), device="cpu"),
        set(common)).replace(checkpoints=()))
    return jeng, teng


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


def test_gcsntk_one_epoch_matches_jax(twins, tmp_path):
    jds, tds = twins
    jeng, teng = _pair("gcsntk", twins, tmp_path)
    assert teng.n_syn == jeng.n_syn == 25
    k1, k2 = jax.random.split(jax.random.key(jeng.args.seed))
    x0 = np.asarray(jax.random.uniform(k1, (jeng.n_syn, jeng.d)))
    y0 = np.asarray(jax.random.uniform(k2, (jeng.n_syn, tds.nclass)))
    jb, tb = jeng._train_batches(jds), teng.train_batches(tds)
    assert len(tb) == len(jb) == 1
    for (jx, jy, jE), (tx, ty, tE) in zip(jb, tb):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))
    jred = jeng._reduce(jds, False)
    with mock.patch.object(teng, "init_syn", lambda: (
            torch.tensor(x0), torch.tensor(y0))):
        tred = teng._reduce(tds, False)
    tol = 1e-2 * 0.01 + 1e-6
    for got, ref in ((tred.feat, jred.feat), (tred.labels, jred.labels)):
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= tol
    assert np.abs(tred.feat.numpy() - x0).max() > 1e-3


@pytest.fixture(scope="module")
def simgc(twins, tmp_path_factory):
    jds, tds = twins
    jeng, teng = _pair("simgc", twins, tmp_path_factory.mktemp("simgc"),
                       hidden=16)
    n_syn, d = teng.n_syn, teng.d
    jeng.pge = JPGE(JPGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                               backend="pallas"))
    teng.pge = PGE(PGEConfig(nfeat=d, nnodes=n_syn, nhid=32, mm_bf16=False))
    seen = []
    fit = JM.fit_with_val

    def spy(*a, **kw):
        seen.append((kw["train"], kw["val"]))
        return fit(*a, **kw)

    with mock.patch.object(JM, "fit_with_val", spy):
        teacher_j, tp_j = jeng._train_teacher(jds, False)
    return dict(jds=jds, tds=tds, jeng=jeng, teng=teng, tp_j=tp_j,
                jbatches=seen[0], stats_j=jeng._concat_stats(jds),
                feat=(0.1 * np.random.default_rng(4).normal(
                    size=(n_syn, d))).astype(np.float32),
                pge_j=jeng.pge.init(jax.random.key(2)),
                teacher_j=teacher_j)


def test_simgc_teacher_trains_on_the_train_subgraph(simgc):
    """The teacher's train and val batches: the train subgraph and the
    val subgraph, whole."""
    e = simgc
    tseen = []
    with mock.patch.object(M, "fit_with_val", lambda *a, **kw: (
            tseen.append((kw["train"], kw["val"])) or (None, torch.zeros(()),
                                                       None))):
        e["teng"].train_teacher(e["tds"], False)
    for t, j in zip(tseen[0], e["jbatches"]):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
        assert t[3] is None and j[3] is None
    # the JAX train batch holds the ELL layout of the same normalization
    (tx, tadj, _, _), (vx, vadj, _, _) = tseen[0]
    assert tx is e["tds"].feat_train and tadj is e["tds"].view_norm("train")
    assert vx is e["tds"].feat_val
    np.testing.assert_array_equal(vadj.val.numpy(),
                                  np.asarray(e["jbatches"][1][1].val))


def test_simgc_hop_statistics_match_jax(simgc):
    e = simgc
    for g, r in zip(e["teng"].concat_stats(e["tds"]), e["stats_j"]):
        _close(g, r, 1e-5)


def test_simgc_one_step_matches_jax(simgc):
    e = simgc
    jeng, teng = e["jeng"], e["teng"]
    teacher_t = M.get_model("SGC", M.ModelConfig(
        nfeat=teng.d, nhid=16, nclass=e["tds"].nclass, nlayers=2,
        dropout=0.0, ntrans=2))
    tp_t = model_params_from_jax("SGC", _np(e["tp_j"]), device="cpu")
    with mock.patch.object(pp, "pair_scores",
                           lambda *a, **kw: pp.pair_scores_ref(*a[:8])):
        step = jeng._build_step(e["teacher_j"], e["tp_j"], e["stats_j"],
                                False)
        fs_j = jnp.asarray(e["feat"])
        fs1, _, _, _, loss_j = step(fs_j, e["pge_j"],
                                    jeng.opt_feat.init(fs_j),
                                    jeng.opt_pge.init(e["pge_j"]))
    stats_t = tuple(torch.tensor(np.asarray(s)) for s in e["stats_j"])
    fs = torch.tensor(e["feat"], requires_grad=True)
    pg = utils.trainable(pge_params_from_jax(_np(e["pge_j"]), device="cpu"))
    loss_t = teng.step(teacher_t, tp_t, stats_t, fs, pg,
                       teng.opt_feat.init([fs]),
                       teng.opt_pge.init(utils.tree_leaves(pg)), False)
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    lr = teng.args.lr_feat
    assert np.abs(fs.detach().numpy() - np.asarray(fs1)).max() \
        <= 1e-2 * lr + 1e-6
    assert np.abs(fs.detach().numpy() - e["feat"]).max() > 0.5 * lr


def _buffers(method, twins, tmp_path):
    jds, tds = twins
    # SGD, as in the cora tables the transductive tests run: under Adam
    # at lr 0.4 the rounding noise of near-zero gradient entries becomes
    # lr-sized steps on either side (ROADMAP.md, section 3)
    jeng, teng = _pair(method, twins, tmp_path, hidden=16,
                       teacher_epochs=20, num_experts=2, syn_steps=5,
                       optim="SGD")
    keys = jax.random.split(jax.random.key(jeng.args.seed), 2)
    inits = [model_params_from_jax(
        "GCN", _np(jeng.expert_model.init(k)), device="cpu") for k in keys]
    traj_j = jeng.build_buffer(jds, False)
    with mock.patch.object(teng, "expert_inits", lambda: inits):
        traj_t = teng.build_buffer(tds, False)
    return jeng, teng, traj_j, traj_t


@pytest.mark.parametrize("method", ["sfgc", "geom"])
def test_expert_buffers_from_the_same_inits_match_jax(twins, tmp_path,
                                                      method):
    jeng, teng, tj, tt = _buffers(method, twins, tmp_path)
    assert tt.shape == tj.shape == (2, 3, teng.n_params)
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    _close(tt, tj, 1e-4)
    assert np.abs(tj[:, -1] - tj[:, 0]).max() > 1e-2
    if method == "geom":
        order_j = jeng._sorted_train(twins[0])
        order_t = teng.sorted_train(twins[1])
        np.testing.assert_array_equal(order_t, order_j)
        assert sorted(order_t) == list(range(len(twins[1].idx_train)))


def test_gdem_one_epoch_matches_jax(twins, tmp_path):
    jds, tds = twins
    jeng, teng = _pair("gdem", twins, tmp_path)
    assert teng.eigen_k == jeng.eigen_k
    ref = jeng._lcc_eigen(jds)
    own = teng.lcc_eigen(tds)
    assert own[0].max() < len(tds.idx_train)
    for a, b in zip(own, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # the eigen cache under the JAX package's key; its basis goes to the
    # port
    src = os.path.join(jeng.args.save_path, "eigen", jds.name)
    dst = os.path.join(teng.args.save_path, "eigen", tds.name)
    assert os.path.isdir(dst)
    shutil.rmtree(dst)
    shutil.copytree(src, dst)
    u0 = np.asarray(jeng._init_eigenvecs(jax.random.key(jeng.args.seed)))
    outs = []

    def eager_jit(f, *a, **kw):
        def run(*args, **kwargs):
            out = f(*args, **kwargs)
            if f.__name__ == "step":
                outs.append(out)
            return out
        return run

    with mock.patch.object(jax, "jit", eager_jit):
        jred = jeng._reduce(jds, False)
    with mock.patch.object(teng, "init_eigenvecs",
                           lambda: torch.tensor(u0)):
        tred = teng._reduce(tds, False)
    loss_j = float(outs[0][-1])
    assert abs(teng.losses[0].item() - loss_j) <= 1e-4 * abs(loss_j)
    tol = 1e-2 * teng.args.lr_eigenvec + 1e-6
    np.testing.assert_allclose(tred.feat.numpy(), np.asarray(jred.feat),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tred.adj.numpy(), np.asarray(jred.adj),
                               rtol=0, atol=tol)
