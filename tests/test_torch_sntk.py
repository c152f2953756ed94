"""The port's SNTK and kernel ridge regression against the JAX package's
(``graphslim_tpu/models/sntk.py``), on numpy inputs from a seed (CPU).

Tolerances, max|Δ| ≤ tol · max|reference|: the gram matrix and the KRR
prediction 1e-5 (float32, only the summation order differs); their
gradients with respect to the synthetic features and labels 1e-4 (the
backward of a linear solve and of ``arccos`` adds rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.models.sntk import SNTK as JSNTK
from graphslim_tpu.models.sntk import krr_forward as jkrr
from graphslim_tpu_torch.models.sntk import SNTK, krr_forward


def _inputs(seed=0, n_t=14, n_s=9, d=6, C=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def agg(n):
        a = (rng.random((n, n)) < 0.3).astype(f32)
        return np.maximum(a, a.T) + np.eye(n, dtype=f32)

    return dict(g_t=rng.normal(size=(n_t, d)).astype(f32),
                g_s=rng.normal(size=(n_s, d)).astype(f32),
                y_s=rng.random((n_s, C)).astype(f32),
                y_t=np.eye(C, dtype=f32)[rng.integers(0, C, n_t)],
                E_t=agg(n_t), E_s=agg(n_s))


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


CASES = [(K, L, scale) for K in (1, 2) for L in (1, 2)
         for scale in ("add", "average")]


@pytest.mark.parametrize("K,L,scale", CASES)
def test_nodes_gram_matches_jax(K, L, scale):
    x = _inputs()
    j = JSNTK(K=K, L=L, scale=scale).nodes_gram(
        *(jnp.asarray(x[k]) for k in ("g_t", "g_s", "E_t", "E_s")))
    t = SNTK(K=K, L=L, scale=scale).nodes_gram(
        *(torch.tensor(x[k]) for k in ("g_t", "g_s", "E_t", "E_s")))
    _close(t.numpy(), j, 1e-5)


@pytest.mark.parametrize("K,L,scale", CASES)
def test_krr_forward_and_its_gradient_match_jax(K, L, scale):
    x = _inputs(seed=1)
    ridge = 1.0 if scale == "average" else 1e-2

    def jloss(gs, ys):
        pred = jkrr(JSNTK(K=K, L=L, scale=scale).nodes_gram, ridge,
                    jnp.asarray(x["g_t"]), gs, ys, jnp.asarray(x["E_t"]),
                    jnp.asarray(x["E_s"]))
        return jnp.mean((pred - x["y_t"]) ** 2), pred

    (_, pred_j), (gg_j, gy_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x["g_s"]),
                                             jnp.asarray(x["y_s"]))
    gs = torch.tensor(x["g_s"], requires_grad=True)
    ys = torch.tensor(x["y_s"], requires_grad=True)
    with torch.enable_grad():
        pred = krr_forward(SNTK(K=K, L=L, scale=scale).nodes_gram, ridge,
                           torch.tensor(x["g_t"]), gs, ys,
                           torch.tensor(x["E_t"]), torch.tensor(x["E_s"]))
        loss = ((pred - torch.tensor(x["y_t"])) ** 2).mean()
        gg, gy = torch.autograd.grad(loss, [gs, ys])
    _close(pred.detach().numpy(), pred_j, 1e-5)
    _close(gg.numpy(), gg_j, 1e-4)
    _close(gy.numpy(), gy_j, 1e-4)
