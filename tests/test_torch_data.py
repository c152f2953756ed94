"""The port's data layer against the JAX package (CPU): twins, splits,
CSR arrays, normalization and the shipped arxiv artifact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import graph as JG
from graphslim_tpu.data import load as jload
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.data import load, read_npz

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                        "artifacts", "arxiv_gcond_r0.01.npz")


@pytest.mark.parametrize("name", ["synth-hard", "cora"])
def test_twins_equal_in_both_packages(name):
    """Same generator, same seed: features, labels, splits and CSR arrays
    are equal, bit for bit."""
    j = jload(name, seed=0)
    t = load(name, seed=0, device="cpu")
    np.testing.assert_array_equal(t.feat.numpy(), np.asarray(j.feat))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    for split in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(t, split), getattr(j, split))
    for field in ("indptr", "row", "col"):
        np.testing.assert_array_equal(getattr(t.adj, field).numpy(),
                                      np.asarray(getattr(j.adj, field)))
    assert t.nclass == j.nclass and t.adj.val is None


def test_gcn_norm_and_adj_norm_agree():
    """Normalized values agree to 1e-6 (both are host float64 sums cast
    to float32)."""
    j = jload("synth-hard", seed=0)
    t = load("synth-hard", seed=0, device="cpu")
    jn, tn = JG.gcn_norm(j.adj), G.gcn_norm(t.adj)
    np.testing.assert_array_equal(tn.col.numpy(), np.asarray(jn.col))
    np.testing.assert_allclose(tn.val.numpy(), np.asarray(jn.val),
                               rtol=1e-6, atol=1e-6)
    ja, ta = j.adj_norm(), t.adj_norm()
    np.testing.assert_array_equal(ta.indptr.numpy(), np.asarray(ja.indptr))
    np.testing.assert_allclose(ta.val.numpy(), np.asarray(ja.val),
                               rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(0).standard_normal(
        (t.n_nodes, 3)).astype(np.float32)
    np.testing.assert_allclose(ta.matmul(torch.tensor(x)).numpy(),
                               np.asarray(ja.matmul(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_normalize_adj_dense_agrees():
    rng = np.random.default_rng(1)
    a = rng.random((37, 37)).astype(np.float32)
    a = (a + a.T) / 2
    a[rng.random((37, 37)) < 0.5] = 0.0
    want = np.asarray(JG.normalize_adj_dense(jnp.asarray(a)))
    got = G.normalize_adj_dense(torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_arxiv_artifact_reads_unchanged():
    red = read_npz(ARTIFACT, device="cpu")
    blob = np.load(ARTIFACT)
    assert red.feat.shape == (1354, 128) and red.adj.shape == (1354, 1354)
    np.testing.assert_array_equal(red.feat.numpy(), blob["feat"])
    np.testing.assert_array_equal(red.adj.numpy(), blob["adj"])
    np.testing.assert_array_equal(red.labels.numpy(), blob["labels"])
    assert red.labels.dtype == torch.int64
