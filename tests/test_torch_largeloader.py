"""``LargeDataLoader`` in the port against the JAX package (CPU).

The JAX k-means draws its initial rows from its key; they come into the
port through ``LargeDataLoader.init_rows``.  With them the batches are
equal, the standardized train features agree to 1e-6 of the largest
(float32 means and deviations summed in other orders), the features after
the GCF hops to 1e-5 of the largest, and every ``get_batch`` gives the
same rows, labels and dense sub-adjacency (exactly, but the features, to
the same bounds).
"""

from unittest import mock

import jax
import numpy as np
import pytest

from graphslim_tpu.data import load as jload
from graphslim_tpu.data.largeloader import LargeDataLoader as JLoader
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.data.largeloader import LargeDataLoader

from torch_shared import one_thread as _one_thread  # noqa: F401


def _max_rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _jax_rows(seed: int, n: int, k: int) -> np.ndarray:
    """The initial rows of the JAX package's ``kmeans(key(seed), x, k)``."""
    return np.array(jax.random.choice(jax.random.key(seed), n, shape=(k,),
                                      replace=False))


@pytest.mark.parametrize("name", ["synth-small", "synth-ind-small"])
@pytest.mark.parametrize("hops", [0, 2])
@pytest.mark.parametrize("split_method", ["kmeans", "mod"])
def test_batches_and_features_equal_jax(name, hops, split_method):
    jds = jload(name, split="fixed", seed=0)
    tds = load(name, split="fixed", seed=0, device="cpu")
    kw = dict(batch_size=100, split_method=split_method, gcf_hops=hops,
              seed=3)
    jl = JLoader(jds, **kw)
    with mock.patch.object(LargeDataLoader, "init_rows",
                           lambda self, n, k, gen: _jax_rows(3, n, k)):
        tl = LargeDataLoader(tds, **kw)
    assert tl.properties() == jl.properties()
    assert tl.n_batch == jl.n_batch > 1
    for a, b in zip(tl.batches, jl.batches):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tl.labels, jl.labels)
    assert _max_rel(tl.feat.numpy(), jl.feat) <= (1e-5 if hops else 1e-6)
    for i in range(tl.n_batch):
        x, y, a = tl.get_batch(i)
        jx, jy, ja = jl.get_batch(i)
        assert _max_rel(x.numpy(), jx) <= (1e-5 if hops else 1e-6)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_batches_of_one_row_are_dropped():
    """k-means into nearly as many batches as rows leaves empty batches
    and batches of one row; both packages drop them alike."""
    jds = jload("synth-small", split="fixed", seed=0)
    tds = load("synth-small", split="fixed", seed=0, device="cpu")
    n = len(tds.idx_train)
    jl = JLoader(jds, batch_size=2, seed=1)
    with mock.patch.object(LargeDataLoader, "init_rows",
                           lambda self, n, k, gen: _jax_rows(1, n, k)):
        tl = LargeDataLoader(tds, batch_size=2, seed=1)
    assert tl.n_batch == jl.n_batch < n // 2
    assert all(b.size > 1 for b in tl.batches)
    for a, b in zip(tl.batches, jl.batches):
        np.testing.assert_array_equal(a, b)


def test_the_k_means_draws_its_rows_from_the_generator():
    """Without the seam the initial rows are distinct rows of the train
    features, drawn from the seeded generator: two loaders agree."""
    tds = load("synth-small", split="fixed", seed=0, device="cpu")
    a = LargeDataLoader(tds, batch_size=100, seed=5)
    b = LargeDataLoader(tds, batch_size=100, seed=5)
    assert a.n_batch == b.n_batch > 1
    for x, y in zip(a.batches, b.batches):
        np.testing.assert_array_equal(x, y)
