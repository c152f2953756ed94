"""The port's GAT against the JAX package's (CPU, synth-hard), with the
JAX weights carried across (``convert``).

* Forward on the normalized ``SparseAdj`` (segment path) and on the ELL
  layout, default and ``cap=4`` (the heavy path), against the JAX
  model on the same path: 1e-5 (float32, summation order).  Across the
  two paths, as ``tests/test_models.py`` holds the JAX package: 2e-3
  relative, 2e-4 absolute.
* The bf16 inference path (hidden 256, 8 heads of 32: messages and source
  logits rounded to bf16) against the JAX bf16 path and against the
  port's float32 segment path: argmax agreement ≥ 0.99 and within 0.05
  (the JAX test's bounds; the two frameworks' bf16 sums differ).
* Gradients through the segment path against ``jax.grad`` at dropout 0:
  1e-4 of each leaf's largest.
* A dense adjacency is refused with the JAX package's ``TypeError``; the
  initial attention vectors take fan-in 2 and fan-out h.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import models as JM
from graphslim_tpu.data import load as jload
from graphslim_tpu.kernels.ell import ell_from_sparse as j_ell
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels.ell import ell_from_sparse as t_ell


@pytest.fixture(scope="module")
def twins():
    return jload("synth-hard", seed=0), load("synth-hard", seed=0,
                                             device="cpu")


def _pair(ds, nhid=32, nheads=8, seed=0):
    cfg = dict(nfeat=ds.n_feat, nhid=nhid, nclass=ds.nclass, nheads=nheads,
               dropout=0.0)
    jmodel = JM.get_model("GAT", JM.ModelConfig(**cfg))
    jp = jmodel.init(jax.random.key(seed))
    tp = model_params_from_jax("GAT", jax.tree.map(np.asarray, jp),
                               device="cpu")
    return jmodel, jp, M.get_model("GAT", M.ModelConfig(**cfg)), tp


def _japply(jmodel, jp, x, adj):
    """The JAX forward, jitted (eager dispatch of its ops is slow)."""
    return jax.jit(lambda p: jmodel.apply(p, x, adj))(jp)


def _adj(jds, tds, layout):
    if layout == "sparse":
        return jds.adj_norm(), tds.adj_norm()
    if layout == "ell":
        return jds.adj_norm_ell(), tds.adj_norm_ell()
    return j_ell(jds.adj_norm(), cap=4), t_ell(tds.adj_norm(), cap=4)


@pytest.mark.parametrize("layout", ["sparse", "ell", "ell_cap4"])
def test_forward_matches_jax(twins, layout):
    jds, tds = twins
    jmodel, jp, tmodel, tp = _pair(jds)
    ja, ta = _adj(jds, tds, layout)
    want = np.asarray(_japply(jmodel, jp, jds.feat, ja))
    got = tmodel.apply(tp, tds.feat, ta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if layout != "sparse":
        seg = tmodel.apply(tp, tds.feat, tds.adj_norm()).numpy()
        np.testing.assert_allclose(got, seg, rtol=2e-3, atol=2e-4)


def test_bf16_inference_path_matches_jax_and_float32(twins):
    jds, tds = twins
    jmodel, jp, tmodel, tp = _pair(jds, nhid=256, nheads=8)
    want = np.asarray(_japply(jmodel, jp, jds.feat, jds.adj_norm_ell()))
    got = tmodel.apply(tp, tds.feat, tds.adj_norm_ell()).numpy()
    f32 = tmodel.apply(tp, tds.feat, tds.adj_norm()).numpy()
    # the ELL path at training (dropout 0) keeps float32 end to end
    f32_ell = tmodel.apply(tp, tds.feat, tds.adj_norm_ell(),
                           training=True).numpy()
    np.testing.assert_allclose(f32_ell, f32, rtol=2e-3, atol=2e-4)
    assert np.abs(got - f32_ell).max() > 0      # the bf16 path ran
    for ref in (want, f32):
        assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.99
        np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


def test_segment_gradients_match_jax(twins):
    jds, tds = twins
    jmodel, jp, tmodel, tp = _pair(jds, seed=3)
    y = np.array(jds.labels)

    def jloss(p):
        out = jmodel.apply(p, jds.feat, jds.adj_norm(), training=True)
        return -jnp.mean(jnp.take_along_axis(out, jnp.asarray(y)[:, None],
                                             1))

    jg = jax.jit(jax.grad(jloss))(jp)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    with torch.enable_grad():
        out = tmodel.apply(leaves, tds.feat, tds.adj_norm(), training=True)
        loss = -out.gather(1, torch.as_tensor(y)[:, None]).mean()
        tg = torch.autograd.grad(loss, list(leaves.values()))
    for (k, _), g in zip(leaves.items(), tg):
        want = np.asarray(jg[k])
        assert np.abs(g.numpy() - want).max() <= \
            1e-4 * np.abs(want).max() + 1e-8, k


def test_dense_adjacency_is_refused(twins):
    _, tds = twins
    model = M.get_model("GAT", M.ModelConfig(nfeat=tds.n_feat, nhid=16,
                                             nclass=tds.nclass))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="SparseAdj or EllAdj"):
        model.apply(params, tds.feat, tds.adj_norm().to_dense())


def test_attention_vectors_take_fan_in_two():
    cfg = M.ModelConfig(nfeat=10, nhid=64, nclass=3, nheads=8)
    p = M.get_model("GAT", cfg).init(torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in p.items()}
    assert shapes == {"w1": (10, 64), "a1": (2, 8, 8), "w2": (64, 3),
                      "a2": (2, 1, 3)}
    lim = math.sqrt(6.0 / (2 + 8))
    assert p["a1"].abs().max() <= lim and p["a1"].abs().max() > 0.9 * lim
