"""The port's MLP, APPNP, Cheby and GraphSage against the JAX package's
(CPU), with the JAX weights carried across (``convert``).

Forwards are held to 1e-5 (float32; the two frameworks sum in different
orders), as ``tests/test_torch_models.py`` holds SGC and GCN, on every
adjacency form the models take: a normalized ``SparseAdj``, a dense
``[n, n]``, ``None`` and, for APPNP and GraphSage (whose teleport term and
root are the targets' self-slot rows), a sampled ``BlockSample``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import graph as JG
from graphslim_tpu import models as JM
from graphslim_tpu.kernels.sample import neighbor_sample_block as j_sample
from graphslim_tpu.models import hoist as JH
from graphslim_tpu.models import nn as jnn
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.kernels.sample import BlockSample
from graphslim_tpu_torch.models import hoist as TH
from graphslim_tpu_torch.models import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, C = 60, 16, 4


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, N, size=(2, 240))
    x = rng.standard_normal((N, D)).astype(np.float32)
    jnorm = JG.gcn_norm(JG.from_edge_index(ei, N, symmetrize=True))
    tnorm = G.gcn_norm(G.from_edge_index(ei, N, symmetrize=True,
                                         device="cpu"))
    return x, jnorm, tnorm


def _split_self(row, col, val, n):
    """Off-diagonal CSR + self-loop values of a normalized adjacency."""
    diag = row == col
    self_vals = np.zeros(n, dtype=np.float32)
    self_vals[row[diag]] = val[diag]
    off = ~diag
    ro, co, vo = row[off], col[off], val[off]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(ro, minlength=n), out=indptr[1:])
    return indptr, co, vo, self_vals


def _adjs(kind, x, jnorm, tnorm):
    """(jax x, jax adj, torch x, torch adj) of one adjacency form."""
    if kind == "sparse":
        return jnp.asarray(x), jnorm, torch.tensor(x), tnorm
    if kind == "dense":
        dense = np.asarray(jnorm.to_dense())
        return (jnp.asarray(x), jnp.asarray(dense), torch.tensor(x),
                torch.tensor(dense))
    if kind == "none":
        return jnp.asarray(x), None, torch.tensor(x), None
    indptr, co, vo, sv = _split_self(np.asarray(jnorm.row),
                                     np.asarray(jnorm.col),
                                     np.asarray(jnorm.val), N)
    block = j_sample(jax.random.key(2), jnp.asarray(indptr),
                     jnp.asarray(co), jnp.asarray(vo), jnp.asarray(sv),
                     jnp.arange(N, dtype=jnp.int32), fanouts=[3, 2])
    tblock = BlockSample(
        node_ids=tuple(torch.tensor(np.asarray(i), dtype=torch.int64)
                       for i in block.node_ids),
        weights=tuple(torch.tensor(np.asarray(w)) for w in block.weights))
    return (jnp.asarray(x)[block.node_ids[0]], block,
            torch.tensor(x)[tblock.node_ids[0]], tblock)


def _pair(name, **cfg):
    base = dict(nfeat=D, nhid=16, nclass=C, nlayers=2, dropout=0.0,
                ntrans=2)
    base.update(cfg)
    jmodel = JM.get_model(name, JM.ModelConfig(**base))
    jp = jmodel.init(jax.random.key(1))
    tp = model_params_from_jax(name, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return jmodel, jp, M.get_model(name, M.ModelConfig(**base)), tp


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("kind", ["sparse", "dense", "none"])
@pytest.mark.parametrize("name", ["MLP", "APPNP", "Cheby", "GraphSage"])
def test_forward_matches_jax(graph, name, kind):
    jmodel, jp, tmodel, tp = _pair(name)
    jx, ja, tx, ta = _adjs(kind, *graph)
    _close(tmodel.apply(tp, tx, ta), jmodel.apply(jp, jx, ja))


@pytest.mark.parametrize("name", ["APPNP", "GraphSage"])
def test_block_forward_takes_the_self_slot_rows(graph, name):
    jmodel, jp, tmodel, tp = _pair(name)
    jx, ja, tx, ta = _adjs("block", *graph)
    got = tmodel.apply(tp, tx, ta)
    assert got.shape == (N, C)
    _close(got, jmodel.apply(jp, jx, ja))


@pytest.mark.parametrize("activation", sorted(jnn.ACTIVATIONS))
def test_appnp_activation_matches_jax(graph, activation):
    assert sorted(tnn.ACTIVATIONS) == sorted(jnn.ACTIVATIONS)
    jmodel, jp, tmodel, tp = _pair("APPNP", activation=activation,
                                   alpha=0.2)
    jx, ja, tx, ta = _adjs("sparse", *graph)
    _close(tmodel.apply(tp, tx, ta), jmodel.apply(jp, jx, ja))
    z = np.linspace(-30, 30, 241, dtype=np.float32)
    np.testing.assert_allclose(
        tnn.ACTIVATIONS[activation](torch.tensor(z)).numpy(),
        np.asarray(jnn.ACTIVATIONS[activation](jnp.asarray(z))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["sparse", "dense", "none"])
def test_hoisted_cheby_matches_cheby_and_jax(graph, kind):
    """``X + ÂX`` precomputed once: the hoisted forward equals the plain
    Cheby (1e-5) and the JAX package's hoisted Cheby."""
    jmodel, jp, tmodel, tp = _pair("Cheby")
    jx, ja, tx, ta = _adjs(kind, *graph)
    hm, hops, keep = TH.hoist_plan(tmodel)
    assert hops == ("chebsum", 2) and keep
    x_pre, a_pre, _, _ = TH.hoist_batch((tx, ta, None, None), hops, keep)
    got = hm.apply(tp, x_pre, a_pre)
    torch.testing.assert_close(got, tmodel.apply(tp, tx, ta), **TOL)
    jhm, jhops, jkeep = JH.hoist_plan(jmodel)
    jx_pre, ja_pre, _, _ = JH.hoist_batch((jx, ja, None, None), jhops,
                                          jkeep)
    _close(x_pre, jx_pre)
    _close(got, jhm.apply(jp, jx_pre, ja_pre))


def test_with_bn_is_not_hoisted_and_matches_jax(graph):
    jmodel, jp, tmodel, tp = _pair("Cheby", with_bn=True)
    assert TH.hoist_plan(tmodel) is None
    jx, ja, tx, ta = _adjs("sparse", *graph)
    _close(tmodel.apply(tp, tx, ta), jmodel.apply(jp, jx, ja))


@pytest.mark.parametrize("name", ["MLP", "GraphSage"])
def test_multi_label_gives_sigmoid_scores(graph, name):
    jmodel, jp, tmodel, tp = _pair(name, multi_label=True)
    jx, ja, tx, ta = _adjs("sparse", *graph)
    got = tmodel.apply(tp, tx, ta)
    _close(got, jmodel.apply(jp, jx, ja))
    assert ((got > 0) & (got < 1)).all()
    torch.testing.assert_close(got, torch.sigmoid(tmodel.embed(tp, tx, ta)))


def test_registry_builds_every_name():
    from graphslim_tpu.models import MODEL_REGISTRY as JREG

    assert sorted(M.MODEL_REGISTRY) == sorted(JREG)
    cfg = M.ModelConfig(nfeat=D, nhid=16, nclass=C)
    for name, cls in JREG.items():
        model = M.get_model(name, cfg)
        assert type(model).__name__ == cls.__name__
    with pytest.raises(ValueError, match="Unknown model"):
        M.get_model("GIN", cfg)
