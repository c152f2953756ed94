"""GCDM in the port against the JAX package (CPU, synth-hard).

The JAX package's epoch draws its permutations inside ``jit``, so the
objective is rebuilt on the JAX side from ``gcdm.dist`` and
``layer_features`` (per class, per matched layer, exactly as its epoch
does) and both sides get the same per-class selections.  Tolerances:
``dist`` and the layer activations to 1e-5 relative (float32, another
summation order); the objective to 1e-5 relative and its gradient with
respect to ``feat_syn`` to 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import models as JM
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu.reduce.gcdm import dist as jdist
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.gcdm import dist

METRICS = ["mse", "l1", "l1_mean", "cos", "ours"]   # 'ours' falls back to l1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def datasets():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


@pytest.mark.parametrize("metric", METRICS)
def test_dist_matches_jax(metric):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(13, 7)).astype(np.float32)
    y = rng.normal(size=(13, 7)).astype(np.float32)
    want = float(jdist(jnp.asarray(x), jnp.asarray(y), metric))
    got = dist(torch.tensor(x), torch.tensor(y), metric).item()
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("with_bn", [False, True])
def test_gcn_layer_features_match_jax(datasets, with_bn):
    """Three-layer GCN over the full normalized graph, weights carried
    across (BatchNorms included); ``depth`` computes a prefix."""
    jds, tds = datasets
    cfg = dict(nfeat=jds.n_feat, nhid=16, nclass=jds.nclass, nlayers=3,
               dropout=0.0, with_bn=with_bn)
    jm = JM.get_model("GCN", JM.ModelConfig(**cfg))
    tm = M.get_model("GCN", M.ModelConfig(**cfg))
    pj = jm.init(jax.random.key(0))
    if with_bn:   # move the BatchNorms off the identity
        pj["bns"] = [{"scale": b["scale"] * 1.5, "bias": b["bias"] + 0.1}
                     for b in pj["bns"]]
    pt = model_params_from_jax("GCN", _np(pj), device="cpu")
    assert ("bns" in pt) == with_bn
    want = jm.layer_features(pj, jds.feat, jds.adj_norm())
    got = tm.layer_features(pt, tds.feat, tds.adj_norm())
    assert len(got) == len(want) == tm.n_layer_features() == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(jnp.abs(w).max()))
    prefix = tm.layer_features(pt, tds.feat, tds.adj_norm(), depth=2)
    assert len(prefix) == 2
    for g, w in zip(prefix, got):
        assert torch.equal(g, w)


def _engines(datasets, tmp, metric):
    jds, tds = datasets
    common = dict(dataset="synth-hard", method="gcdm", save_path=tmp,
                  hidden=16, nlayers=3, condense_model="GCN",
                  dis_metric=metric, outer_loop=2, inner_loop=1, epochs=1)
    explicit = set(common) - {"dataset", "method", "save_path"}
    jeng = jcreate("gcdm", jds, jfinalize(JArgs(**common), explicit))
    teng = create_reducer("gcdm", tds, finalize(
        Args(**common, device="cpu"), explicit))
    return jeng, teng


@pytest.mark.parametrize("metric", ["l1", "mse", "cos"])
def test_objective_and_gradient_match_jax(datasets, tmp_path, metric):
    """GCN with 3 layers matches layers 0 and 1; same selections, same
    weights, same synthetic features on both sides."""
    jeng, teng = _engines(datasets, str(tmp_path), metric)
    assert teng.n_match == 2
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    mp_t = model_params_from_jax("GCN", _np(mp_j), device="cpu")
    sel_t = teng.draw_selection(torch.Generator().manual_seed(4))
    sel = sel_t.numpy()
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
                    emb_syn[i][st:ed], metric)
        return loss

    loss_j, g_j = jax.value_and_grad(objective)(jnp.asarray(feat))
    fs = torch.tensor(feat, requires_grad=True)
    with torch.enable_grad():
        loss_t = teng.objective(mp_t, fs, teng.real_embeddings(mp_t), sel_t)
        g_t, = torch.autograd.grad(loss_t, [fs])
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    g_j = np.asarray(g_j)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()


def test_selection_is_a_permutation_cut_to_the_budget(datasets, tmp_path):
    _, teng = _engines(datasets, str(tmp_path), "l1")
    pools = {c: set(np.asarray(teng.data.idx_train)[
        teng.data.labels.numpy()[teng.data.idx_train] == c])
        for c in teng.classes}
    for seed in range(3):
        sel = teng.draw_selection(torch.Generator().manual_seed(seed))
        sel = sel.numpy()
        for c in teng.classes:
            st, ed = teng.class_ranges[c]
            rows = sel[st:ed]
            assert len(rows) == teng.budgets[c] == len(set(rows))
            assert set(rows) <= pools[c]


def test_real_embeddings_compute_only_the_matched_layers(datasets,
                                                         tmp_path):
    """GCN with 2 layers matches layer 0 only: one full-graph product at
    the hidden width, none at the class count (the card test checks the
    same on the blocked SpMM's launch counts)."""
    _, tds = datasets
    args = finalize(Args(dataset="synth-hard", method="gcdm", hidden=16,
                         nlayers=2, save_path=str(tmp_path), device="cpu"),
                    {"hidden", "nlayers"})
    teng = create_reducer("gcdm", tds, args)
    assert teng.n_match == 1
    widths = []
    adj = teng.adj_norm_full
    real_matmul = type(adj).matmul

    def counting(self, x):
        widths.append(x.shape[-1])
        return real_matmul(self, x)

    mp = teng.model.init(torch.Generator().manual_seed(0))
    type(adj).matmul = counting
    try:
        emb = teng.real_embeddings(mp)
    finally:
        type(adj).matmul = real_matmul
    assert widths == [16] and len(emb) == 1 and not emb[0].requires_grad


@pytest.mark.parametrize("method", ["gcdm", "gcdmx"])
def test_gcdm_runs_end_to_end_on_the_cpu(datasets, tmp_path, method):
    _, tds = datasets
    args = finalize(Args(dataset="synth-hard", method=method, epochs=2,
                         hidden=16, run_inter_eval=1, eval_epochs=5,
                         save_path=str(tmp_path), device="cpu"),
                    {"epochs", "hidden", "run_inter_eval", "eval_epochs"})
    assert args.epochs == 2 and args.checkpoints == (-1, 0, 1, 2)
    eng = create_reducer(method, tds, args)
    red = eng.reduce(tds)
    assert red.adj is None and red.feat.shape == (50, tds.n_feat)
    assert torch.isfinite(red.feat).all()
    assert len(eng.epoch_loss_sums) == 2
    assert all(torch.isfinite(x) for x in eng.epoch_loss_sums)
    assert (tmp_path / "reduced_graph" / method /
            "synth-hard_0.5_1.npz").exists()
