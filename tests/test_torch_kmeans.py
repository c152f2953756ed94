"""The port's k-means, incremental k-means++ and fuzzy c-means against the
JAX package on the CPU, on synth-hard's features.

Both sides start from the same centroids (``init``), so Lloyd's iterates
are the same arithmetic: the centroids agree to 1e-5 relative (float32
matrix products summed in a different order) and the assignments are
equal.  The empty-cluster case plants a centroid far from every row: it
must come back unchanged on both sides.  Fuzzy c-means from the same
``init`` agrees to 1e-5 relative.  Incremental k-means++: the D² distances
of the first pick equal the JAX package's (read from the logits it hands
``jax.random.categorical``) to 1e-5 of their maximum; with both sides'
draws replaced by the most likely pick, the picked centroids are equal;
and where every row but one sits on an old center, that row is always
picked.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphslim_tpu.kernels.kmeans as jk
from graphslim_tpu.reduce.gecc import fuzzy_cmeans as jfuzzy
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import kmeans as tk

K = 6


@pytest.fixture(scope="module")
def feat():
    x = load("synth-hard", seed=0, device="cpu").feat[:240]
    return x.numpy()


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max()


@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_matches_jax(feat, weighted):
    rng = np.random.default_rng(3)
    init = feat[rng.choice(feat.shape[0], K, replace=False)]
    w = rng.uniform(0.5, 3.0, feat.shape[0]).astype(np.float32) \
        if weighted else None
    cj, aj = jk.kmeans(jax.random.key(0), jnp.asarray(feat), K,
                       weights=None if w is None else jnp.asarray(w),
                       init=jnp.asarray(init))
    ct, at = tk.kmeans(torch.tensor(feat), K,
                       weights=None if w is None else torch.tensor(w),
                       init=torch.tensor(init))
    _close(ct.numpy(), cj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_empty_cluster_keeps_its_centroid(feat):
    init = feat[:K].copy()
    init[2] = 1e3            # no row is nearer to it than to the others
    cj, aj = jk.kmeans(jax.random.key(0), jnp.asarray(feat), K,
                       init=jnp.asarray(init))
    ct, at = tk.kmeans(torch.tensor(feat), K, init=torch.tensor(init))
    assert not (at.numpy() == 2).any()
    np.testing.assert_array_equal(ct.numpy()[2], init[2])
    np.testing.assert_array_equal(np.asarray(cj)[2], init[2])
    _close(ct.numpy(), cj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_kmeans_draws_distinct_rows_without_init(feat):
    gen = torch.Generator().manual_seed(0)
    rows = tk.random_rows(feat.shape[0], K, gen)
    assert len(set(rows.tolist())) == K
    c, a = tk.kmeans(torch.tensor(feat), K,
                     gen=torch.Generator().manual_seed(0))
    c0, a0 = tk.kmeans(torch.tensor(feat), K,
                       init=torch.tensor(feat)[rows])
    assert torch.equal(c, c0) and torch.equal(a, a0)


def test_fuzzy_cmeans_matches_jax(feat):
    init = feat[np.random.default_rng(4).choice(feat.shape[0], K,
                                                replace=False)]
    cj = jfuzzy(jax.random.key(0), jnp.asarray(feat), K, 1.3, 50,
                init=jnp.asarray(init))
    ct = tk.fuzzy_cmeans(torch.tensor(feat), K, 1.3, 50,
                         init=torch.tensor(init))
    _close(ct.numpy(), cj)


def _jax_kmeanspp(x, old, needed):
    """The JAX package's picks with its draw replaced by the most likely
    one; returns (centers, the logits of every draw)."""
    logits = []

    def most_likely(key, lg, *a, **kw):
        logits.append(np.asarray(lg))
        return jnp.argmax(lg)

    with jax.disable_jit(), mock.patch.object(jax.random, "categorical",
                                              most_likely):
        out = jk.incremental_kmeanspp(jax.random.key(0), jnp.asarray(x),
                                      jnp.asarray(old), needed)
    return np.asarray(out), logits


def _torch_kmeanspp(x, old, needed):
    def most_likely(probs, n, generator=None):
        return torch.argmax(probs).reshape(1)

    with mock.patch.object(torch, "multinomial", most_likely):
        return tk.incremental_kmeanspp(torch.tensor(x), torch.tensor(old),
                                       needed,
                                       torch.Generator().manual_seed(0))


def test_kmeanspp_distances_and_picks_match_jax(feat):
    old = feat[:4]
    cj, logits = _jax_kmeanspp(feat, old, 3)
    d2_jax = np.exp(logits[0])
    d2_jax[d2_jax <= 1e-29] = 0.0          # log(max(d², 1e-30)) of a 0
    d2 = tk.kmeanspp_distances(torch.tensor(feat), torch.tensor(old))
    _close(d2.numpy(), d2_jax)
    # the old centers themselves: 0 up to the expansion's rounding
    assert (d2.numpy()[:4] <= 1e-5 * d2.numpy().max()).all()
    ct = _torch_kmeanspp(feat, old, 3)
    _close(ct.numpy(), cj)
    # with no old center the first pick is uniform
    d2_empty = tk.kmeanspp_distances(torch.tensor(feat),
                                     torch.zeros((0, feat.shape[1])))
    assert torch.equal(d2_empty, torch.ones(feat.shape[0]))


def test_kmeanspp_degenerate_picks_the_one_admissible_row(feat):
    """Every row but one coincides with an old center: D² sampling has a
    single row of weight above the expansion's rounding, and picks it at
    every seed."""
    x = np.repeat(feat[:3], 20, axis=0)
    x[17] = feat[50]
    for seed in range(8):
        got = tk.incremental_kmeanspp(
            torch.tensor(x), torch.tensor(feat[:3]), 1,
            torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(got.numpy()[0], feat[50])
