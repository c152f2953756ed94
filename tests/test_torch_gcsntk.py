"""The port's GCSNTK against the JAX package on synth-hard (CPU).

The JAX draws cannot be followed by torch, so both sides start from the
JAX package's ``x_s, y_s ~ U(0, 1)`` (handed to the port through
``init_syn``), and with ``_BATCH`` patched small in both packages the JAX
k-means assignment is handed to the port through ``partition``.  One
epoch of Adam steps (lr 0.01) then ends at the same ``(x_s, y_s)``:
max|Δ| ≤ 1e-2 · lr per Adam step + 1e-6 (Adam moves a parameter by at
most about lr a step, and float32 rounding of the KRR gradient, a linear
solve's backward, may flip a near-zero gradient's step).  The batches
themselves (rows, one-hot labels, dense blocks plus the identity) are
equal.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

import graphslim_tpu.reduce.gcsntk as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.kernels.kmeans import kmeans as jkmeans
from graphslim_tpu.reduce import create_reducer as jcreate
import graphslim_tpu_torch.reduce.gcsntk as TG
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer


def _pair(tmp_path, **kw):
    common = dict(dataset="synth-hard", method="gcsntk",
                  save_path=str(tmp_path), epochs=1, **kw)
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("gcsntk", jds, jfinalize(JArgs(**common), set(common))
                   .replace(checkpoints=()))
    teng = create_reducer("gcsntk", tds, finalize(
        Args(**common, device="cpu"), set(common)).replace(checkpoints=()))
    return jds, jeng, tds, teng


def _jax_init(jeng):
    k1, k2 = jax.random.split(jax.random.key(jeng.args.seed))
    return (np.asarray(jax.random.uniform(k1, (jeng.n_syn, jeng.d))),
            np.asarray(jax.random.uniform(k2, (jeng.n_syn,
                                               jeng.data.nclass))))


@pytest.mark.parametrize("batch", [None, 50])
def test_one_epoch_matches_jax(tmp_path, batch):
    jds, jeng, tds, teng = _pair(tmp_path)
    assert teng.n_syn == jeng.n_syn == 50
    x0, y0 = _jax_init(jeng)
    patches = [mock.patch.object(teng, "init_syn", lambda: (
        torch.tensor(x0), torch.tensor(y0)))]
    n_batches = 1
    if batch is not None:
        idx = np.asarray(jds.idx_train)
        k = -(-idx.shape[0] // batch)
        n_batches = k
        _, assign = jkmeans(jax.random.key(jeng.args.seed),
                            jds.feat[idx], k)
        assign = np.array(assign)
        patches += [mock.patch.object(JG, "_BATCH", batch),
                    mock.patch.object(TG, "_BATCH", batch),
                    mock.patch.object(teng, "partition",
                                      lambda feat, kk: assign)]
    for p in patches:
        p.start()
    try:
        jb = jeng._train_batches(jds)
        tb = teng.train_batches(tds)
        assert len(tb) == len(jb) == (n_batches if batch else 1)
        for (jx, jy, jE), (tx, ty, tE) in zip(jb, tb):
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))
        jred = jeng._reduce(jds, False)
        tred = teng._reduce(tds, False)
    finally:
        for p in patches:
            p.stop()
    tol = 1e-2 * 0.01 * n_batches + 1e-6
    for got, ref in ((tred.feat, jred.feat), (tred.labels, jred.labels)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= tol, \
            np.abs(got.numpy() - ref).max()
    # the step moved both
    assert np.abs(tred.feat.numpy() - x0).max() > 1e-3
    assert np.abs(tred.labels.numpy() - y0).max() > 1e-3
