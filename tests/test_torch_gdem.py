"""The port's GDEM against the JAX package (and numpy) on the CPU.

* The filtered-subspace eigensolver (``eigen_backend='device'``; on the
  CPU through the plain SpMM) on the graph of the JAX package's
  ``test_gdem_device_eigensolver_matches_arpack`` (n = 1200, k = 12)
  against ``numpy.linalg.eigh``: eigenvalues within 1e-4, the projectors
  on the 8 leading, well-separated pairs within 1e-3, and no ARPACK call.
* ``subspace_covariance`` and ``embed_mean`` within 1e-5 of max.
* On synth-hard, with the JAX package's eigen cache and initial
  eigenvectors handed in: the cache the port computes itself (the dense
  path) equals the JAX one, and one epoch of eigenvector steps (e1) and
  one of feature steps (e2) give the loss within 1e-4 (relative) and the
  updated features and adjacency within 1e-2 · lr + 1e-6 (one Adam step;
  float32 rounding may flip a near-zero gradient's step).
"""

import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu.reduce import gdem as JD
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce import gdem as TD


def _arpack_test_graph():
    """The normalized adjacency of the JAX package's eigensolver test."""
    rng = np.random.default_rng(3)
    n = 1200
    src = np.arange(n)
    rows = np.concatenate([src, src, rng.integers(0, n, 3 * n)])
    cols = np.concatenate([(src + 1) % n, (src + 17) % n,
                           rng.integers(0, n, 3 * n)])
    m = rows != cols
    rows, cols = rows[m], cols[m]
    W = sp.csr_matrix((np.ones(2 * len(rows)),
                       (np.concatenate([rows, cols]),
                        np.concatenate([cols, rows]))), shape=(n, n))
    W.data[:] = 1.0
    W = W + sp.eye(n)
    dinv = 1.0 / np.sqrt(np.asarray(W.sum(1)).ravel())
    return sp.diags(dinv) @ W @ sp.diags(dinv)


def test_filtered_subspace_solver_matches_eigh():
    An = _arpack_test_graph()
    n, k = An.shape[0], 12
    vals, vecs, info = TD.eigsh_smallest(An, k, "device", "cpu")
    assert info["backend"] == "device" and not info["arpack"]
    assert info["residual"] < 1e-3
    w, U = np.linalg.eigh((sp.eye(n) - An).toarray())
    np.testing.assert_allclose(np.sort(vals), w[:k], atol=1e-4)
    kk = 8
    P = vecs[:, :kk] @ vecs[:, :kk].T
    Pr = U[:, :kk] @ U[:, :kk].T
    assert np.abs(P - Pr).max() < 1e-3
    assert w[kk] - w[kk - 1] > 1e-3     # the pairs compared are separated


def test_auto_backend_is_the_host_on_the_cpu():
    An = _arpack_test_graph()
    vals, _, info = TD.eigsh_smallest(An, 6, "auto", "cpu")
    assert info["backend"] == "host" and info["arpack"]
    with pytest.raises(ValueError, match="eigen_backend"):
        TD.eigsh_smallest(An, 6, "tpu", "cpu")


def test_covariance_and_embedding_match_jax():
    rng = np.random.default_rng(1)
    n, k, d, C = 60, 7, 5, 3
    U = np.linalg.qr(rng.normal(size=(n, k)))[0].astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    lam = np.sort(rng.random(k)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, n)]
    for got, ref in (
            (TD.subspace_covariance(torch.tensor(U), torch.tensor(x)),
             JD.subspace_covariance(jnp.asarray(U), jnp.asarray(x))),
            (TD.embed_mean(torch.tensor(lam), torch.tensor(U),
                           torch.tensor(x), torch.tensor(onehot)),
             JD.embed_mean(jnp.asarray(lam), jnp.asarray(U), jnp.asarray(x),
                           jnp.asarray(onehot)))):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("e1", [10, 0])
def test_one_epoch_matches_jax(tmp_path, e1):
    common = dict(dataset="synth-hard", method="gdem", epochs=1, e1=e1,
                  eval_epochs=20)
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("gdem", jds, jfinalize(JArgs(
        **common, save_path=str(tmp_path / "j")), set(common))
        .replace(checkpoints=()))
    teng = create_reducer("gdem", tds, finalize(Args(
        **common, save_path=str(tmp_path / "t"), device="cpu"),
        set(common)).replace(checkpoints=()))
    assert teng.eigen_k == jeng.eigen_k == 50
    # the eigen cache: computed by each package, equal; the JAX one is
    # handed to the port
    ref = jeng._lcc_eigen(jds)
    own = teng.lcc_eigen(tds)
    for a, b in zip(own, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    src = os.path.join(jeng.args.save_path, "eigen", jds.name)
    dst = os.path.join(teng.args.save_path, "eigen", tds.name)
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
    lr = teng.args.lr_eigenvec if e1 else teng.args.lr_feat
    tol = 1e-2 * lr + 1e-6
    np.testing.assert_allclose(tred.feat.numpy(), np.asarray(jred.feat),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tred.adj.numpy(), np.asarray(jred.adj),
                               rtol=0, atol=tol)
    # the step moved the side it should
    x0 = teng.init_feat_syn().numpy()
    moved_x = np.abs(tred.feat.numpy() - x0).max()
    assert (moved_x == 0) if e1 else (moved_x > 0.5 * lr)
