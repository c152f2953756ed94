"""The gradient-matching condensers of the port in the inductive setting,
against the JAX package (CPU, synth-ind-small at r = 0.25: a train
subgraph of 100 nodes, n_syn = 25).

In the inductive setting the engine reads the train subgraph: its
features and labels, pools of local ids and the sampler tables of its
normalized adjacency.  Every engine's inputs are compared first (exactly,
the normalized values bit for bit).  Then, as in the transductive tests,
with the same sampled blocks (drawn by the JAX sampler on the train
subgraph) and the same weights injected: one epoch of GCond, DosCond,
GCondX and DosCondX (the loss to 1e-4 relative, parameters to 1 % of lr
plus 1e-6, the updated PGE's output to 1e-4), GCDM's objective and
gradient (1e-5 / 1e-4), MSGC's outer-step loss and gradients (1e-4),
SGDD's corner of the train subgraph (exactly) and SGDD's outer step: the
loss to 1e-4 relative, the gradient of ``P`` to 5e-3 of its largest entry
and every other gradient to 1e-4 of its group's largest (the tolerances
of ``test_torch_sgdd.py``).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.kernels import pallas_pge as pp
from graphslim_tpu.models.pge import PGE as JPGE, PGEConfig as JPGEConfig
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu.reduce.cond_base import match_loss as jmatch_loss
from graphslim_tpu.reduce.gcdm import dist as jdist
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu.models import ignr as JI
from graphslim_tpu_torch.convert import (ignr_params_from_jax,
                                         model_params_from_jax,
                                         pge_params_from_jax)
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.models.ignr import mx_inv
from graphslim_tpu_torch.models.pge import PGE, PGEConfig
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.cond_base import match_loss
from graphslim_tpu_torch.reduce.sgdd import adj_corner

NAME = "synth-ind-small"
ENGINES = ["gcond", "doscond", "gcondx", "doscondx", "gcdm", "gcdmx",
           "sgdd", "msgc", "simgc", "gcsntk", "sfgc", "geom", "gdem"]


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def twins():
    return jload(NAME, seed=0), load(NAME, seed=0, device="cpu")


def _engines(method, twins, save, **kw):
    jds, tds = twins
    common = dict(dataset=NAME, method=method, save_path=save, hidden=16,
                  epochs=1, eval_epochs=20, **kw)
    explicit = set(common) - {"dataset", "method", "save_path"}
    jeng = jcreate(method, jds, jfinalize(JArgs(**common), explicit))
    teng = create_reducer(method, tds, finalize(
        Args(**common, device="cpu"), explicit))
    return jeng, teng


def _blocks(jeng):
    """A JAX sample of every class's block, for both engines."""
    ids, ws, targets, valid = jeng._sample_all_class_blocks(
        jax.random.key(3))
    blocks_t = (tuple(torch.tensor(np.asarray(i), dtype=torch.int64)
                      for i in ids),
                tuple(torch.tensor(np.asarray(w)) for w in ws),
                torch.tensor(np.asarray(targets), dtype=torch.int64),
                torch.tensor(np.asarray(valid)))
    return (ids, ws, targets, valid), blocks_t


@pytest.mark.parametrize("method", ENGINES)
def test_engine_reads_the_train_subgraph(twins, tmp_path, method):
    jds, tds = twins
    jeng, teng = _engines(method, twins, str(tmp_path))
    assert teng.n_syn == jeng.n_syn and teng.fanouts == jeng.fanouts
    assert teng.batch == jeng.batch
    np.testing.assert_array_equal(teng.labels_syn.numpy(),
                                  np.asarray(jeng.labels_syn))
    real, jreal = teng.real, jeng.real
    assert real.features is tds.feat_train
    np.testing.assert_array_equal(real.features.numpy(),
                                  np.asarray(jreal.features))
    np.testing.assert_array_equal(real.labels_real.numpy(),
                                  np.asarray(jreal.labels_real))
    np.testing.assert_array_equal(real.pools.numpy(),
                                  np.asarray(jreal.pools))
    np.testing.assert_array_equal(real.pool_counts.numpy(),
                                  np.asarray(jreal.pool_counts))
    assert real.pools.max() < len(tds.idx_train)
    np.testing.assert_array_equal(real.self_vals.numpy(),
                                  np.asarray(jreal.self_vals))
    norm, jnorm = teng.adj_norm_full, jeng.adj_norm_full
    assert norm is tds.view_norm("train")
    for field in ("indptr", "col", "val"):
        np.testing.assert_array_equal(getattr(norm, field).numpy(),
                                      np.asarray(getattr(jnorm, field)))
    # the sampler's off-diagonal CSR, in the port's packed tables
    off = jreal.adj_off
    node = real.tables.node.numpy()
    edge = real.tables.edge.numpy()
    np.testing.assert_array_equal(node[:, 0].view(np.int32),
                                  np.asarray(off.indptr)[:-1])
    np.testing.assert_array_equal(node[:, 1].view(np.int32),
                                  np.asarray(off.indptr)[1:])
    np.testing.assert_array_equal(edge[:, 0].view(np.int32),
                                  np.asarray(off.col))
    np.testing.assert_array_equal(edge[:, 1], np.asarray(off.val))


@pytest.mark.parametrize("method", ["gcond", "doscond", "gcondx",
                                    "doscondx"])
def test_one_epoch_agrees_with_jax(twins, tmp_path, method):
    # the metric of each method's cora table, which the transductive
    # tests run under synth-hard (see test_ours_gradient_at_a_zero_row)
    metric = "ours" if method == "gcond" else "mse"
    jeng, teng = _engines(method, twins, str(tmp_path), ntrans=2,
                          outer_loop=2, inner_loop=2, condense_model="SGC",
                          lr_feat=0.01, lr_adj=0.02, dis_metric=metric)
    struct = teng.with_structure
    n_syn, d = teng.n_syn, teng.d
    if struct:
        jeng.pge = JPGE(JPGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                                   backend="pallas"))
        teng.pge = PGE(PGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                                 mm_bf16=False))
    feat = np.asarray(jeng.init_feat_syn())
    np.testing.assert_array_equal(teng.init_feat_syn().numpy(), feat)
    mp_j = jeng.model.init(jax.random.key(1))
    pge_j = jeng.pge.init(jax.random.key(2)) if struct else {}
    blocks_j, blocks_t = _blocks(jeng)
    mp_t = model_params_from_jax("SGC", _np(mp_j), device="cpu")
    patches = [
        mock.patch.object(pp, "pair_scores",
                          lambda *a, **kw: pp.pair_scores_ref(*a[:8])),
        mock.patch.object(jeng, "_sample_all_class_blocks",
                          lambda key, real=None: blocks_j),
        mock.patch.object(teng, "_sample_all_class_blocks",
                          lambda gen: blocks_t),
        mock.patch.object(jeng.model, "init", lambda key: mp_j),
        mock.patch.object(teng.model, "init",
                          lambda gen: utils.tree_map(torch.clone, mp_t)),
    ]
    for p in patches:
        p.start()
    try:
        fs_j = jnp.asarray(feat)
        fn = jeng._build_epoch_fn(True)
        opt_p_j = jeng.opt_pge.init(pge_j) if struct else None
        fs1, pg1, _, _, loss_j = fn(jax.random.key(5), fs_j, pge_j,
                                    jeng.opt_feat.init(fs_j), opt_p_j,
                                    jeng.real)
        fs = torch.tensor(feat, requires_grad=True)
        pg = utils.trainable(pge_params_from_jax(_np(pge_j), device="cpu")) \
            if struct else {}
        opt_p = teng.opt_pge.init(utils.tree_leaves(pg)) if struct else None
        loss_t = teng._epoch(fs, pg, teng.opt_feat.init([fs]), opt_p, True)
    finally:
        for p in patches:
            p.stop()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    lr_f, lr_p = teng.args.lr_feat, teng.args.lr_adj
    feat_t = fs.detach().numpy()
    assert np.abs(feat_t - np.asarray(fs1)).max() <= 1e-2 * lr_f + 1e-6
    # GCond's epoch with update_pge steps the PGE alone; the others step
    # the features at least once in two outer steps
    if method != "gcond":
        assert np.abs(feat_t - feat).max() > 0.5 * lr_f
    if not struct:
        return
    # the biases in front of a BatchNorm have gradient 0 analytically and
    # are compared through the PGE's output (see test_torch_gcond.py)
    n_layers = len(pg["layers"])
    for i in range(n_layers):
        for k in ("w",) + (("b",) if i == n_layers - 1 else ()):
            got = pg["layers"][i][k].detach().numpy()
            want = np.asarray(pg1["layers"][i][k])
            assert np.abs(got - want).max() <= 1e-2 * lr_p + 1e-6
    for i, bn in enumerate(pg["bns"]):
        for k in ("scale", "bias"):
            assert np.abs(bn[k].detach().numpy()
                          - np.asarray(pg1["bns"][i][k])).max() \
                <= 1e-2 * lr_p + 1e-6
    with mock.patch.object(pp, "pair_scores",
                           lambda *a, **kw: pp.pair_scores_ref(*a[:8])):
        adj_j = np.asarray(jeng.pge.apply(pg1, fs1))
    adj_t = teng.pge.apply(pg, fs).detach().numpy()
    np.testing.assert_allclose(adj_t, adj_j, rtol=1e-4, atol=1e-5)
    start = np.asarray(pge_j["layers"][0]["w"])
    assert np.abs(pg["layers"][0]["w"].detach().numpy() - start).max() \
        > 0.5 * lr_p


def test_gcdm_objective_and_gradient_agree(twins, tmp_path):
    jeng, teng = _engines("gcdm", twins, str(tmp_path), nlayers=3,
                          condense_model="GCN", dis_metric="l1",
                          outer_loop=2, inner_loop=1)
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    mp_t = model_params_from_jax("GCN", _np(mp_j), device="cpu")
    sel_t = teng.draw_selection(torch.Generator().manual_seed(4))
    sel = sel_t.numpy()
    assert sel.max() < len(twins[1].idx_train)
    cls_ranges = [jeng.class_ranges[c] for c in jeng.classes]
    coeffs = [jeng.budgets[c] / jeng.n_syn for c in jeng.classes]
    eye = jnp.eye(jeng.n_syn)

    def objective(fs):
        emb_real = [jax.lax.stop_gradient(e) for e in
                    jeng.model.layer_features(mp_j, jeng.features,
                                              jeng.adj_norm_full)]
        emb_syn = jeng.model.layer_features(mp_j, fs, eye)
        loss = jnp.float32(0.0)
        for i in range(2):
            for ci, (st, ed) in enumerate(cls_ranges):
                loss = loss + coeffs[ci] * jdist(
                    jnp.take(emb_real[i], sel[st:ed], axis=0),
                    emb_syn[i][st:ed], "l1")
        return loss

    loss_j, g_j = jax.value_and_grad(objective)(jnp.asarray(feat))
    fs = torch.tensor(feat, requires_grad=True)
    loss_t = teng.objective(mp_t, fs, teng.real_embeddings(mp_t), sel_t)
    g_t, = torch.autograd.grad(loss_t, [fs])
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    g_j = np.asarray(g_j)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()


def test_sgdd_corner_is_the_train_subgraphs(twins, tmp_path):
    jds, tds = twins
    jeng, teng = _engines("sgdd", twins, str(tmp_path), mx_size=60)
    want = np.asarray(jds.adj_train.to_dense())[:60, :60]
    np.testing.assert_array_equal(adj_corner(tds.view_host("train"), 60),
                                  want)
    assert want.sum() > 0
    # The corner of the sparse train subgraph is rank-deficient: the
    # thresholded inverse drops only the smallest singular value and
    # keeps the others at rounding level (1e-7), so both packages'
    # inverses are rounding noise of size 1e7 there.  What the port must
    # do is invert this corner.
    np.testing.assert_array_equal(
        teng.lx_inv.numpy(), mx_inv(torch.as_tensor(want)).numpy())
    assert np.abs(np.asarray(jeng.lx_inv)).max() > 1e6


def test_sgdd_outer_step_agrees(twins, tmp_path):
    """One SGDD outer step on the train subgraph: the matching loss over
    the same sampled blocks plus the spectral-OT term, and its gradients
    with respect to the features and every IGNR leaf.  Every corner of
    this 100-node train subgraph is rank-deficient by more than one
    (the one at 30 by 22), which leaves both engines' inverses rounding
    noise of size 1e7 (see the test above).  Both engines get the same
    well-conditioned inverse in their place: ``mx_inv`` of the corner's
    Laplacian plus the identity (eigenvalues in [1, 4])."""
    mx = 30
    jeng, teng = _engines("sgdd", twins, str(tmp_path), mx_size=mx,
                          opt_scale=1e-3, ntrans=2, outer_loop=2,
                          inner_loop=2)
    corner = adj_corner(twins[1].view_host("train"), mx)
    lap = np.diag(corner.sum(1)) - corner + np.eye(mx, dtype=np.float32)
    lx = np.asarray(JI.mx_inv(jnp.asarray(lap)))
    jeng.lx_inv, teng.lx_inv = jnp.asarray(lx), torch.tensor(lx)
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    pj = jeng.pge.init(jax.random.key(2))
    blocks_j, blocks_t = _blocks(jeng)
    mp_t = model_params_from_jax("SGC", _np(mp_j), device="cpu")
    with mock.patch.object(jeng, "_sample_all_class_blocks",
                           lambda key, real=None: blocks_j), \
            mock.patch.object(teng, "_sample_all_class_blocks",
                              lambda gen: blocks_t):
        def objective(fs, p):
            adj, aux = jeng.generator_forward(p, fs)
            return jeng.match_loss_total(mp_j, fs, adj,
                                         jax.random.key(0)) + aux

        loss_j, (gf_j, gp_j) = jax.value_and_grad(
            objective, argnums=(0, 1))(jnp.asarray(feat), pj)
        fs = torch.tensor(feat, requires_grad=True)
        pt = utils.trainable(ignr_params_from_jax(_np(pj), device="cpu"))
        adj, aux = teng.generator_forward(pt, fs)
        assert aux.item() > 0
        loss_t = teng.match_loss_total(mp_t, fs, adj, teng.gen) + aux
        grads = torch.autograd.grad(loss_t, utils.tree_leaves(pt) + [fs])
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    want = [np.asarray(g) for g in jax.tree.leaves(gp_j)] + [np.asarray(gf_j)]
    got = [g.numpy() for g in grads]
    assert len(got) == len(want) == 22
    # leaf 0 is P, the last the features; the rest are held to the
    # largest gradient entry among them
    assert np.abs(got[0] - want[0]).max() <= 5e-3 * np.abs(want[0]).max()
    assert np.abs(got[-1] - want[-1]).max() <= \
        1e-4 * np.abs(want[-1]).max()
    scale = max(np.abs(w).max() for w in want[1:-1])
    for g, w in zip(got[1:-1], want[1:-1]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * scale


def test_msgc_outer_step_agrees(twins, tmp_path):
    jeng, teng = _engines("msgc", twins, str(tmp_path), ntrans=2,
                          outer_loop=2, inner_loop=2, batch_adj=4)
    np.testing.assert_array_equal(teng.labels_syn.numpy(),
                                  np.asarray(jeng.labels_syn))
    for a, b in zip((teng.rows, teng.cols, teng.batches),
                    (jeng.rows, jeng.cols, jeng.batches)):
        np.testing.assert_array_equal(a, b)
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    sc_j = jeng.pge_init(jax.random.key(2))
    blocks_j, blocks_t = _blocks(jeng)
    mp_t = model_params_from_jax("SGC", _np(mp_j), device="cpu")
    with mock.patch.object(jeng, "_sample_all_class_blocks",
                           lambda key, real=None: blocks_j), \
            mock.patch.object(teng, "_sample_all_class_blocks",
                              lambda gen: blocks_t):
        def objective(fs, sc):
            adj, aux = jeng.generator_forward(sc, fs)
            return jeng.match_loss_total(mp_j, fs, adj,
                                         jax.random.key(0)) + aux

        loss_j, (gf_j, gs_j) = jax.value_and_grad(
            objective, argnums=(0, 1))(jnp.asarray(feat), sc_j)
        fs = torch.tensor(feat, requires_grad=True)
        sc = utils.trainable(pge_params_from_jax(_np(sc_j), device="cpu"))
        adj, aux = teng.generator_forward(sc, fs)
        loss_t = teng.match_loss_total(mp_t, fs, adj, teng.gen) + aux
        grads = torch.autograd.grad(loss_t, [fs] + utils.tree_leaves(sc))
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    want = [np.asarray(gf_j)] + [np.asarray(g)
                                 for g in jax.tree.leaves(gs_j)]
    scale = max(np.abs(g).max() for g in want[1:])
    for i, (got, ref) in enumerate(zip(grads, want)):
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-4 * (np.abs(ref).max() if i == 0 else scale), i


def test_ours_gradient_at_a_zero_row():
    """A synthetic gradient row of exactly 0 (a hidden unit dead on every
    synthetic row of a class): the ``ours`` distance is differentiable
    there, with gradient ``-g_real / 1e-6`` in that row.  The port gives
    it; the JAX package differentiates ``jnp.linalg.norm`` at 0 and gets
    NaN, which GCondX on synth-ind-small under ``ours`` reaches."""
    rng = np.random.default_rng(0)
    gs = rng.normal(size=(1, 4, 3)).astype(np.float32)
    gs[0, 1] = 0.0
    gr = rng.normal(size=(1, 4, 3)).astype(np.float32)
    want = jax.grad(lambda a: jmatch_loss([a[0]], [jnp.asarray(gr[0])],
                                          "ours"))(jnp.asarray(gs))
    assert np.isnan(np.asarray(want)[0, 1]).all()
    t = torch.tensor(gs, requires_grad=True)
    g, = torch.autograd.grad(
        match_loss([t], [torch.tensor(gr)], "ours").sum(), [t])
    np.testing.assert_allclose(g[0, 1].numpy(), -gr[0, 1] / 1e-6,
                               rtol=1e-5)
    # the other rows agree with the JAX package
    np.testing.assert_allclose(np.delete(g.numpy()[0], 1, 0),
                               np.delete(np.asarray(want)[0], 1, 0),
                               rtol=1e-5, atol=1e-6)
