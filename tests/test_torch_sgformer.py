"""The port's SGFormer and dense GNTK against the JAX package's (CPU,
float32), with the JAX weights carried across (``convert``).

* SGFormer forward on a normalized ``SparseAdj``, a dense ``[n, n]`` and
  ``None``, at 1, 2 and 3 transformer layers: 1e-5 (summation order; the
  attention divides by the Frobenius norm of the whole ``[n, H, D]``
  tensor, and its layer norms take the population variance).  Its
  gradients at dropout 0 against ``jax.grad``: 1e-4 of each leaf's
  largest; the unread ``g_bn`` leaves get zero in both.
* With dropout, the port draws the transformer branch's masks before the
  graph branch's: a model whose graph weight is 0 gives the same output
  whatever the graph branch draws.
* GNTK's ``diag_list`` and ``gntk`` on two random graphs, under both
  scales: 1e-5 of the largest (the arc-cosine recursion is clipped at
  ±0.9999 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import graph as JG
from graphslim_tpu import models as JM
from graphslim_tpu.models.gntk import GNTK as JGNTK
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.models.gntk import GNTK as TGNTK
from graphslim_tpu_torch.utils import tree_leaves

N, D, C = 50, 12, 4


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    ei = rng.integers(0, N, size=(2, 200))
    x = rng.standard_normal((N, D)).astype(np.float32)
    jnorm = JG.gcn_norm(JG.from_edge_index(ei, N, symmetrize=True))
    tnorm = G.gcn_norm(G.from_edge_index(ei, N, symmetrize=True,
                                         device="cpu"))
    return x, jnorm, tnorm


def _pair(trans_layers, dropout=0.0):
    cfg = dict(nfeat=D, nhid=16, nclass=C, dropout=dropout,
               trans_layers=trans_layers)
    jmodel = JM.get_model("SGFormer", JM.ModelConfig(**cfg))
    jp = jmodel.init(jax.random.key(trans_layers))
    tp = model_params_from_jax("SGFormer", jax.tree.map(np.asarray, jp),
                               device="cpu")
    return jmodel, jp, M.get_model("SGFormer", M.ModelConfig(**cfg)), tp


def _adj(kind, jnorm, tnorm):
    if kind == "sparse":
        return jnorm, tnorm
    if kind == "dense":
        dense = np.asarray(jnorm.to_dense())
        return jnp.asarray(dense), torch.tensor(dense)
    return None, None


@pytest.mark.parametrize("kind", ["sparse", "dense", "none"])
@pytest.mark.parametrize("trans_layers", [1, 2, 3])
def test_forward_matches_jax(graph, trans_layers, kind):
    x, jnorm, tnorm = graph
    jmodel, jp, tmodel, tp = _pair(trans_layers)
    ja, ta = _adj(kind, jnorm, tnorm)
    assert len(tp["t_conv"]) == trans_layers
    np.testing.assert_allclose(
        tmodel.apply(tp, torch.tensor(x), ta).numpy(),
        np.asarray(jmodel.apply(jp, jnp.asarray(x), ja)),
        rtol=1e-5, atol=1e-5)


def test_gradients_match_jax(graph):
    x, jnorm, tnorm = graph
    jmodel, jp, tmodel, tp = _pair(2)
    y = np.random.default_rng(1).integers(0, C, N)

    def jloss(p):
        out = jmodel.apply(p, jnp.asarray(x), jnorm, training=True)
        return -jnp.mean(jnp.take_along_axis(out, jnp.asarray(y)[:, None],
                                             1))

    jg = jax.tree.leaves(jax.jit(jax.grad(jloss))(jp))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        out = tmodel.apply(tp, torch.tensor(x), tnorm, training=True)
        loss = -out.gather(1, torch.as_tensor(y)[:, None]).mean()
        tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert len(tg) == len(jg)
    for g, want in zip(tg, jg):
        want = np.asarray(want)
        got = np.zeros_like(want) if g is None else g.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-8


def test_transformer_masks_are_drawn_first(graph):
    """With the graph weight at 0 the output is the transformer branch's
    alone, which reads the first draws of the generator: a generator that
    the graph branch then reads further gives the same output."""
    x, _, tnorm = graph
    _, _, tmodel, tp = _pair(2, dropout=0.5)
    tmodel.graph_weight = 0.0
    outs = [tmodel.apply(tp, torch.tensor(x), adj, training=True,
                         gen=torch.Generator().manual_seed(4))
            for adj in (tnorm, None)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    base = tmodel.apply(tp, torch.tensor(x), tnorm)
    assert not torch.equal(outs[0], base)


def _random_graph(n, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.15).astype(np.float32)
    a = np.triu(a, 1)
    return (rng.standard_normal((n, 6)).astype(np.float32), a + a.T)


@pytest.mark.parametrize("scale", ["degree", "uniform"])
def test_gntk_matches_jax(scale):
    x1, a1 = _random_graph(14, 0)
    x2, a2 = _random_graph(9, 1)
    jk = JGNTK(num_layers=2, num_mlp_layers=3, scale=scale)
    tk = TGNTK(num_layers=2, num_mlp_layers=3, scale=scale)
    jd = jk.diag_list(jnp.asarray(x1), jnp.asarray(a1))
    td = tk.diag_list(torch.tensor(x1), torch.tensor(a1))
    assert len(td) == len(jd) == 4
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    want = np.asarray(jk.gntk(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(a1), jnp.asarray(a2)))
    got = tk.gntk(torch.tensor(x1), torch.tensor(x2), torch.tensor(a1),
                  torch.tensor(a2)).numpy()
    assert got.shape == (14, 9)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
