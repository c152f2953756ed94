"""The port's SGC/GCN models and on-device sampler against the JAX package
(CPU).

Forwards use the JAX weights carried across (``convert``); tolerance
1e-5 (float32, the two frameworks sum in different orders).  The samplers
draw different random numbers, so the sampler is held to its structure,
to unbiasedness over seeds, and to exact agreement with the full
aggregation at ``fanout >= max_deg``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import graph as JG
from graphslim_tpu import models as JM
from graphslim_tpu.kernels.sample import neighbor_sample_block as j_sample
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.kernels.sample import (BlockSample,
                                                build_packed_csr,
                                                neighbor_sample_block)


def _graph(n=60, e=240, d=16, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    x = rng.standard_normal((n, d)).astype(np.float32)
    return ei, x


def _split_self(norm_row, norm_col, norm_val, n):
    """Off-diagonal CSR + self-loop values of a normalized adjacency."""
    diag = norm_row == norm_col
    self_vals = np.zeros(n, dtype=np.float32)
    self_vals[norm_row[diag]] = norm_val[diag]
    off = ~diag
    ro, co, vo = norm_row[off], norm_col[off], norm_val[off]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(ro, minlength=n), out=indptr[1:])
    return indptr, co, vo, self_vals


@pytest.mark.parametrize("name", ["SGC", "GCN"])
@pytest.mark.parametrize("adj_kind", ["full", "block"])
def test_forward_with_carried_weights_matches_jax(name, adj_kind):
    ei, x = _graph()
    n, d, c = x.shape[0], x.shape[1], 4
    jnorm = JG.gcn_norm(JG.from_edge_index(ei, n, symmetrize=True))
    cfg = dict(nfeat=d, nhid=8, nclass=c, nlayers=2, dropout=0.0,
               ntrans=2)
    jmodel = JM.get_model(name, JM.ModelConfig(**cfg))
    jparams = jmodel.init(jax.random.key(1))
    tparams = model_params_from_jax(name, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tmodel = M.get_model(name, M.ModelConfig(**cfg))
    if adj_kind == "full":
        want = jmodel.apply(jparams, jnp.asarray(x), jnorm)
        tnorm = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                             device="cpu"))
        got = tmodel.apply(tparams, torch.tensor(x), tnorm)
    else:
        row, col = np.asarray(jnorm.row), np.asarray(jnorm.col)
        indptr, co, vo, sv = _split_self(row, col, np.asarray(jnorm.val),
                                         n)
        block = j_sample(jax.random.key(2), jnp.asarray(indptr),
                         jnp.asarray(co), jnp.asarray(vo), jnp.asarray(sv),
                         jnp.arange(n, dtype=jnp.int32), fanouts=[3, 2])
        want = jmodel.apply(jparams, jnp.asarray(x)[block.node_ids[0]],
                            block)
        tblock = BlockSample(
            node_ids=tuple(torch.tensor(np.asarray(i), dtype=torch.int64)
                           for i in block.node_ids),
            weights=tuple(torch.tensor(np.asarray(w))
                          for w in block.weights))
        got = tmodel.apply(tparams, torch.tensor(x)[tblock.node_ids[0]],
                           tblock)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _tables(n=24, seed=0):
    rng = np.random.default_rng(seed)
    src = np.arange(n)
    ei = np.concatenate([np.stack([src, (src + 1) % n]),
                         np.stack([src, (src + 5) % n]),
                         rng.integers(0, n, size=(2, 40))], axis=1)
    norm = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                        device="cpu"))
    row, col, val = norm.row.numpy(), norm.col.numpy(), norm.val.numpy()
    indptr, co, vo, sv = _split_self(row, col, val, n)
    return norm, indptr, build_packed_csr(indptr, co, vo, sv, "cpu"), sv


def test_sampler_structure():
    n, fanouts = 24, [2, 3]
    norm, indptr, tables, sv = _tables(n)
    deg = np.diff(indptr)
    targets = torch.arange(n)
    gen = torch.Generator().manual_seed(0)
    block = neighbor_sample_block(gen, tables, targets, fanouts)
    assert [w.shape for w in block.weights] == [(n * 3, 4), (n, 3)]
    assert [i.shape[0] for i in block.node_ids] == [n * 3 * 4, n * 3, n]
    w1 = block.weights[1].numpy()                 # hop from the targets
    src1 = block.node_ids[1].numpy().reshape(n, 3)
    # the self slot is last: the target itself with its self-loop weight
    np.testing.assert_array_equal(src1[:, -1], np.arange(n))
    np.testing.assert_allclose(w1[:, -1], sv)
    # padding: slots >= deg have weight 0 and point at the target
    for r in range(n):
        for s in range(int(deg[r]), 2):
            assert w1[r, s] == 0 and src1[r, s] == r
        # sampled neighbours are real neighbours of r
        nb = set(norm.col.numpy()[norm.row.numpy() == r])
        assert set(src1[r, :min(int(deg[r]), 2)]) <= nb


def test_subsampled_unbiased_estimator():
    """With the deg/fanout rescale, the mean one-hop block aggregation over
    many draws converges to A_norm @ x (CLT tolerance as the JAX test)."""
    n, d, fanout, draws = 24, 5, 2, 4000
    norm, indptr, tables, _ = _tables(n)
    assert int(np.diff(indptr).max()) > fanout
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (n, d)).astype(np.float32))
    # every draw at once: targets repeated, each row sampled independently
    targets = torch.arange(n).repeat(draws)
    gen = torch.Generator().manual_seed(7)
    block = neighbor_sample_block(gen, tables, targets, [fanout])
    srcs, w = block.node_ids[0].reshape(-1, fanout + 1), block.weights[0]
    agg = (x[srcs] * w[..., None]).sum(1).reshape(draws, n, d)
    want = norm.to_dense() @ x
    np.testing.assert_allclose(agg.mean(0).numpy(), want.numpy(),
                               atol=0.05, rtol=0.05)


@pytest.mark.parametrize("name", ["SGC", "GCN"])
def test_blocks_equal_full_aggregation_at_max_fanout(name):
    """fanout >= max_deg: every neighbour is enumerated with its own
    weight, so the block forward equals the full forward (float32 sums
    in another order: 1e-5)."""
    ei, x = _graph(seed=3)
    n = x.shape[0]
    norm = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                        device="cpu"))
    row, col, val = norm.row.numpy(), norm.col.numpy(), norm.val.numpy()
    indptr, co, vo, sv = _split_self(row, col, val, n)
    max_deg = int(np.diff(indptr).max())
    tables = build_packed_csr(indptr, co, vo, sv, "cpu")
    block = neighbor_sample_block(torch.Generator().manual_seed(0), tables,
                                  torch.arange(n), [max_deg, max_deg])
    model = M.get_model(name, M.ModelConfig(nfeat=x.shape[1], nhid=8,
                                            nclass=3, ntrans=2))
    params = model.init(torch.Generator().manual_seed(0))
    xt = torch.tensor(x)
    full = model.apply(params, xt, norm)
    blk = model.apply(params, xt[block.node_ids[0]], block)
    torch.testing.assert_close(blk, full, rtol=1e-5, atol=1e-5)


def test_batched_params_give_per_class_forwards():
    """Params with a leading class axis run C forwards in one pass (the
    port's stand-in for vmap): slice c equals the forward with params c."""
    ei, x = _graph(seed=4)
    n = x.shape[0]
    norm = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                        device="cpu")).to_dense()
    model = M.get_model("SGC", M.ModelConfig(nfeat=x.shape[1], nhid=8,
                                             nclass=3, ntrans=2))
    gen = torch.Generator().manual_seed(0)
    ps = [model.init(gen) for _ in range(3)]
    from graphslim_tpu_torch.utils import tree_map
    batched = tree_map(lambda *leaves: torch.stack(leaves), *ps)
    out = model.apply(batched, torch.tensor(x), norm)
    for c in range(3):
        torch.testing.assert_close(
            out[c], model.apply(ps[c], torch.tensor(x), norm),
            rtol=1e-6, atol=1e-6)
