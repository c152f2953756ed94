"""DosCond, GCondX and DosCondX in the port against the JAX package (CPU,
synth-hard).

Set-up as in ``tests/test_torch_gcond.py``: n_syn = 50, PGE nhid 32 on its
tile-local plain version (the JAX package's PGE patched to its pure-JAX
oracle), the same sampled blocks and model init injected into both
engines, JAX weights carried across.  One epoch of two outer steps runs
under each alternation: ``"both"`` with structure (DosCond), ``"outer"``
without (GCondX: no feature step at ``ol = 0``, one at ``ol = 1``, then
two inner model steps on the identity adjacency) and ``"both"`` without
(DosCondX).  Tolerances as there: the summed loss to 1e-4 relative, every
updated parameter to 1 % of its learning rate plus 1e-6, the updated PGE's
output to 1e-4 relative.
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
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import (model_params_from_jax,
                                         pge_params_from_jax)
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.models.pge import PGE, PGEConfig
from graphslim_tpu_torch.reduce import create_reducer

# method → (alternation, with structure)
VARIANTS = {"doscond": ("both", True), "gcondx": ("outer", False),
            "doscondx": ("both", False)}


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def datasets():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


def _engines(method, datasets, save):
    jds, tds = datasets
    common = dict(dataset="synth-hard", method=method, save_path=save,
                  hidden=16, ntrans=2, outer_loop=2, inner_loop=2, epochs=1,
                  condense_model="SGC", lr_feat=0.01, lr_adj=0.02)
    explicit = set(common) - {"dataset", "method", "save_path"}
    jeng = jcreate(method, jds, jfinalize(JArgs(**common), explicit))
    teng = create_reducer(method, tds, finalize(
        Args(**common, device="cpu"), explicit))
    n_syn, d = teng.n_syn, teng.d
    if teng.with_structure:
        jeng.pge = JPGE(JPGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                                   backend="pallas"))
        teng.pge = PGE(PGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                                 mm_bf16=False))
    return jeng, teng


def test_variants_have_their_schedule_and_structure(datasets, tmp_path):
    for method, (alternation, struct) in VARIANTS.items():
        jeng, teng = _engines(method, datasets, str(tmp_path))
        assert (teng.alternation, teng.with_structure) == \
            (jeng.alternation, jeng.with_structure) == (alternation, struct)
        assert (teng.pge is None) == (not struct)
        # DosCond and DosCondX force inner_loop 0 through args.replace
        assert teng.args.inner_loop == jeng.args.inner_loop == \
            (0 if method.startswith("doscond") else 2)
        if not struct:
            # one form, None, stands for the identity everywhere; the
            # model gives on it what it gives on the normalized identity
            fs = torch.randn(teng.n_syn, teng.d)
            assert teng.syn_adj_norm(None, fs) is None
            assert teng.inference_adj({}, fs) is None
            assert teng.inner_adj({}, fs) is None
            eye = G.normalize_adj_dense(torch.eye(teng.n_syn),
                                        add_loops=False)
            mp = teng.model.init(torch.Generator().manual_seed(0))
            np.testing.assert_allclose(
                teng.model.apply(mp, fs, None).detach().numpy(),
                teng.model.apply(mp, fs, eye).detach().numpy(),
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", sorted(VARIANTS))
def test_outer_steps_with_adam_agree(datasets, tmp_path, method):
    """One epoch of two outer steps from the same start ends at the same
    parameters on both sides."""
    jeng, teng = _engines(method, datasets, str(tmp_path))
    struct = teng.with_structure
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    pge_j = jeng.pge.init(jax.random.key(2)) if struct else {}
    ids, ws, targets, valid = jeng._sample_all_class_blocks(
        jax.random.key(3))
    blocks_j = (ids, ws, targets, valid)
    blocks_t = (tuple(torch.tensor(np.asarray(i), dtype=torch.int64)
                      for i in ids),
                tuple(torch.tensor(np.asarray(w)) for w in ws),
                torch.tensor(np.asarray(targets), dtype=torch.int64),
                torch.tensor(np.asarray(valid)))
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
    # both alternations step the features at least once in two steps
    assert np.abs(feat_t - feat).max() > 0.5 * lr_f
    if not struct:
        assert pg == {} and pg1 == {}
        return
    # as in test_torch_gcond: the biases in front of a BatchNorm have
    # gradient 0 analytically and are compared through the PGE's output
    n_layers = len(pg["layers"])
    for i in range(n_layers):
        for k in ("w",) + (("b",) if i == n_layers - 1 else ()):
            got = pg["layers"][i][k].detach().numpy()
            want = np.asarray(pg1["layers"][i][k])
            assert np.abs(got - want).max() <= 1e-2 * lr_p + 1e-6
    for i, bn in enumerate(pg["bns"]):
        for k in ("scale", "bias"):
            got = bn[k].detach().numpy()
            want = np.asarray(pg1["bns"][i][k])
            assert np.abs(got - want).max() <= 1e-2 * lr_p + 1e-6
    with mock.patch.object(pp, "pair_scores",
                           lambda *a, **kw: pp.pair_scores_ref(*a[:8])):
        adj_j = np.asarray(jeng.pge.apply(pg1, fs1))
    adj_t = teng.pge.apply(pg, fs).detach().numpy()
    np.testing.assert_allclose(adj_t, adj_j, rtol=1e-4, atol=1e-5)
    start = np.asarray(pge_j["layers"][0]["w"])
    assert np.abs(pg["layers"][0]["w"].detach().numpy() - start).max() \
        > 0.5 * lr_p


@pytest.mark.parametrize("method", sorted(VARIANTS))
def test_variant_runs_end_to_end_on_the_cpu(datasets, tmp_path, method):
    """create_reducer(...).reduce() on synth-hard: finite, of the budget's
    shape, with the identity adjacency without structure, and saved."""
    _, tds = datasets
    args = finalize(Args(dataset="synth-hard", method=method, epochs=2,
                         hidden=16, outer_loop=2, run_inter_eval=1,
                         eval_epochs=5, save_path=str(tmp_path),
                         device="cpu"),
                    {"epochs", "hidden", "outer_loop", "run_inter_eval",
                     "eval_epochs"})
    eng = create_reducer(method, tds, args)
    red = eng.reduce(tds)
    assert len(eng.epoch_loss_sums) == 2
    assert red.feat.shape == (50, tds.n_feat)
    assert torch.isfinite(red.feat).all()
    assert (red.adj is None) == (not VARIANTS[method][1])
    assert (tmp_path / "reduced_graph" / method /
            "synth-hard_0.5_1.npz").exists()
