"""The port's GCond engine against the JAX package on synth-hard (CPU).

n_syn = 50 (r = 0.5 of the 100 train nodes) is not a multiple of 16, so
every PGE row tile is ragged; PGE nhid 32.  Both sides run the PGE with the
tile-local BatchNorm semantics: the port on its plain version, the JAX
package with ``pallas_pge.pair_scores`` patched to its pure-JAX oracle.
The same sampled blocks (drawn by the JAX sampler) are injected into both
engines, and the JAX model/PGE weights are carried across.

Tolerances: the match loss and its gradients agree to 1e-4 relative
(float32 through a nested gradient); Adam moves a parameter by at most
about lr per step, and the two sides' updated parameters agree to 1 % of
lr plus float32 rounding of the parameters (1e-6).
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
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import (model_params_from_jax,
                                         pge_params_from_jax)
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.models.pge import PGE, PGEConfig
from graphslim_tpu_torch.reduce import create_reducer


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("gcond"))
    common = dict(dataset="synth-hard", method="gcond", save_path=save,
                  hidden=16, ntrans=2, outer_loop=2, inner_loop=2, epochs=1)
    explicit = {"hidden", "ntrans", "outer_loop", "inner_loop"}
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("gcond", jds, jfinalize(JArgs(**common), explicit))
    teng = create_reducer("gcond", tds, finalize(
        Args(**common, device="cpu"), explicit))
    n_syn, d = teng.n_syn, teng.d
    jeng.pge = JPGE(JPGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                               backend="pallas"))
    teng.pge = PGE(PGEConfig(nfeat=d, nnodes=n_syn, nhid=32,
                             mm_bf16=False))
    feat = np.asarray(jeng.init_feat_syn())
    mp_j = jeng.model.init(jax.random.key(1))
    pge_j = jeng.pge.init(jax.random.key(2))
    ids, ws, targets, valid = jeng._sample_all_class_blocks(
        jax.random.key(3))
    blocks_t = (tuple(torch.tensor(np.asarray(i), dtype=torch.int64)
                      for i in ids),
                tuple(torch.tensor(np.asarray(w)) for w in ws),
                torch.tensor(np.asarray(targets), dtype=torch.int64),
                torch.tensor(np.asarray(valid)))
    return dict(jeng=jeng, teng=teng, feat=feat, mp_j=mp_j, pge_j=pge_j,
                blocks_j=(ids, ws, targets, valid), blocks_t=blocks_t)


def _patched(e):
    """Inject the same blocks and model init into both engines; the JAX
    PGE runs its pure-JAX tile oracle."""
    mp_t = model_params_from_jax("SGC", _np(e["mp_j"]), device="cpu")
    return [
        mock.patch.object(pp, "pair_scores",
                          lambda *a, **kw: pp.pair_scores_ref(*a[:8])),
        mock.patch.object(e["jeng"], "_sample_all_class_blocks",
                          lambda key, real=None: e["blocks_j"]),
        mock.patch.object(e["teng"], "_sample_all_class_blocks",
                          lambda gen: e["blocks_t"]),
        mock.patch.object(e["jeng"].model, "init",
                          lambda key: e["mp_j"]),
        mock.patch.object(e["teng"].model, "init",
                          lambda gen: utils.tree_map(torch.clone, mp_t)),
    ]


def test_engines_agree_on_budgets(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    assert teng.n_syn == jeng.n_syn == 50 and teng.n_syn % 16
    np.testing.assert_array_equal(teng.labels_syn.numpy(),
                                  np.asarray(jeng.labels_syn))
    np.testing.assert_allclose(teng.coeffs.numpy(), np.asarray(jeng.coeffs))
    assert teng.fanouts == jeng.fanouts and teng.batch == jeng.batch


def test_random_init_feat_syn_equal(engines):
    """The Random init is NumPy-seeded: the same nodes, bit for bit."""
    np.testing.assert_array_equal(
        engines["teng"].init_feat_syn().numpy(), engines["feat"])


def test_match_loss_total_and_gradients_agree(engines):
    e = engines
    jeng, teng = e["jeng"], e["teng"]
    patches = _patched(e)
    for p in patches:
        p.start()
    try:
        mp_j = e["mp_j"]

        def objective(fs, pg):
            adj = jeng.syn_adj_norm(pg, fs)
            return jeng.match_loss_total(mp_j, fs, adj, jax.random.key(0))

        loss_j, (gf_j, gp_j) = jax.value_and_grad(objective, argnums=(0, 1))(
            jnp.asarray(e["feat"]), e["pge_j"])
        mp_t = teng.model.init(None)
        fs = torch.tensor(e["feat"], requires_grad=True)
        pg = utils.trainable(pge_params_from_jax(_np(e["pge_j"]),
                                                 device="cpu"))
        loss_t = teng.match_loss_total(mp_t, fs, teng.syn_adj_norm(pg, fs),
                                       teng.gen)
        grads = torch.autograd.grad(loss_t, [fs] + utils.tree_leaves(pg))
    finally:
        for p in patches:
            p.stop()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    want = [np.asarray(gf_j)] + [np.asarray(g)
                                 for g in jax.tree.leaves(gp_j)]
    assert len(want) == len(grads)
    # The PGE biases in front of a BatchNorm have gradient 0 analytically
    # (rounding noise on both sides), so PGE leaves are held to 1e-4 of
    # the largest PGE gradient entry.
    pge_scale = max(np.abs(g).max() for g in want[1:])
    for i, (got, ref) in enumerate(zip(grads, want)):
        err = np.abs(got.numpy() - ref).max()
        scale = np.abs(ref).max() if i == 0 else pge_scale
        assert err <= 1e-4 * scale, (i, err, scale)


@pytest.mark.parametrize("update_pge", [True, False])
def test_outer_steps_with_adam_agree(engines, update_pge):
    """Two outer steps (match loss → Adam step → inner loop of 2 model
    updates) of one epoch, from the same start, end at the same params."""
    e = engines
    jeng, teng = e["jeng"], e["teng"]
    patches = _patched(e)
    for p in patches:
        p.start()
    try:
        fs_j = jnp.asarray(e["feat"])
        fn = jeng._build_epoch_fn(update_pge)
        fs1, pg1, _, _, loss_j = fn(
            jax.random.key(5), fs_j, e["pge_j"], jeng.opt_feat.init(fs_j),
            jeng.opt_pge.init(e["pge_j"]), jeng.real)
        fs = torch.tensor(e["feat"], requires_grad=True)
        pg = utils.trainable(pge_params_from_jax(_np(e["pge_j"]),
                                                 device="cpu"))
        loss_t = teng._epoch(fs, pg, teng.opt_feat.init([fs]),
                             teng.opt_pge.init(utils.tree_leaves(pg)),
                             update_pge)
    finally:
        for p in patches:
            p.stop()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    lr = teng.args.lr_adj if update_pge else teng.args.lr_feat
    tol = 1e-2 * lr + 1e-6
    feat_t = fs.detach().numpy()
    assert np.abs(feat_t - np.asarray(fs1)).max() <= tol
    # The biases feeding a BatchNorm (all PGE layer biases but the last)
    # have gradient 0 analytically; Adam turns their rounding-noise
    # gradients into noise-sized steps, on either side, and BatchNorm
    # removes them from the output.  They are left out of the leaf-wise
    # comparison, and the updated PGE's output is compared instead.
    n_layers = len(pg["layers"])
    for i in range(n_layers):
        for k in ("w",) + (("b",) if i == n_layers - 1 else ()):
            got = pg["layers"][i][k].detach().numpy()
            assert np.abs(got - np.asarray(pg1["layers"][i][k])).max() <= tol
    for i, bn in enumerate(pg["bns"]):
        for k in ("scale", "bias"):
            got = bn[k].detach().numpy()
            assert np.abs(got - np.asarray(pg1["bns"][i][k])).max() <= tol
    with mock.patch.object(pp, "pair_scores",
                           lambda *a, **kw: pp.pair_scores_ref(*a[:8])):
        adj_j = np.asarray(jeng.pge.apply(pg1, fs1))
    adj_t = teng.pge.apply(pg, fs).detach().numpy()
    np.testing.assert_allclose(adj_t, adj_j, rtol=1e-4, atol=1e-5)
    # the step really moved the side it should
    start = e["pge_j"]["layers"][0]["w"] if update_pge else e["feat"]
    moved = pg["layers"][0]["w"] if update_pge else fs
    assert np.abs(moved.detach().numpy() - np.asarray(start)).max() > 0.5 * lr
