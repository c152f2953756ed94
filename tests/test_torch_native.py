"""The port's native host library against the JAX package's (CPU).

``graphslim_tpu_torch/native`` compiles its own copy of
``graphslim_native.cpp`` into ``build/native/`` and binds the t-spanner,
the greedy matching, the exact blossom matching, the edge-cut partitioner,
the sort-and-dedup and the connected components with no Python
fallback.  On random weighted graphs each op returns exactly what the JAX
package's library returns (asserted loaded, so that its Python fallbacks
are never what the port is compared with); the blossom is also held to a
brute-force maximum over vertex subsets.
"""

import itertools
import re

import numpy as np
import pytest
from torch_shared import REPO, jax_native_lib

from graphslim_tpu import native as jnative
from graphslim_tpu_torch import native


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jax_native_lib() is not None, "the JAX package's native " \
        "library did not load: its fallbacks would be compared"
    return native.load()


def _graph(seed: int, n: int, m: int):
    """Random simple weighted graph: upper-triangle pairs, no loops."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src < dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    w = rng.uniform(0.1, 3.0, pairs.shape[0])
    return pairs[:, 0], pairs[:, 1], w


def test_the_copy_is_verbatim_and_built_in_the_port():
    port = REPO / "graphslim_tpu_torch" / "native" / "graphslim_native.cpp"
    jax_src = REPO / "graphslim_tpu" / "native" / "graphslim_native.cpp"
    assert port.read_bytes() == jax_src.read_bytes()
    assert native.SOURCE == port
    so = native.build()
    assert so.parent == REPO / "build" / "native"
    assert re.fullmatch(r"libgraphslim_native_[0-9a-f]{16}\.so", so.name)
    assert so.exists() and native.build() == so


def test_an_edited_source_gets_a_library_of_its_own(tmp_path, monkeypatch):
    cxx = native._compiler()
    so = native.library_path(cxx)
    edited = tmp_path / "graphslim_native.cpp"
    edited.write_bytes(native.SOURCE.read_bytes() + b"// edited\n")
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.library_path(cxx) != so
    assert native.library_path(cxx).parent == so.parent


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()


@pytest.mark.parametrize("seed,n,m,t", [
    (0, 60, 400, 2.0), (1, 200, 1500, 4.0), (2, 500, 3000, 3.0),
    (3, 30, 40, 4.0)])
def test_t_spanner_equals_jax(seed, n, m, t):
    src, dst, w = _graph(seed, n, m)
    got = native.t_spanner(src, dst, w, n, t)
    np.testing.assert_array_equal(got, jnative.t_spanner(src, dst, w, n, t))
    assert 0 < got.shape[0] <= src.shape[0]


@pytest.mark.parametrize("seed,n,m,r", [
    (0, 60, 400, 0.5), (1, 200, 1500, 0.3), (2, 500, 3000, 0.9),
    (3, 30, 40, 1.0)])
def test_greedy_matching_equals_jax(seed, n, m, r):
    src, dst, w = _graph(seed, n, m)
    got = native.greedy_matching(src, dst, w, n, r)
    np.testing.assert_array_equal(got, jnative.greedy_matching(src, dst, w,
                                                               n, r))
    flat = got.ravel()
    assert len(set(flat.tolist())) == flat.shape[0]


@pytest.mark.parametrize("seed,n,m", [(0, 40, 200), (1, 120, 900),
                                      (2, 300, 2000)])
def test_blossom_equals_jax(seed, n, m):
    src, dst, w = _graph(seed, n, m)
    got = native.max_weight_matching(src, dst, w, n)
    np.testing.assert_array_equal(got, jnative.max_weight_matching(src, dst,
                                                                   w, n))
    assert native.max_weight_matching(src, dst, -w, n).shape == (0, 2)


def _best_matching_weight(W: np.ndarray) -> float:
    """Maximum matching weight by dynamic programming over vertex sets."""
    n = W.shape[0]
    best = np.full(1 << n, -1.0)
    best[0] = 0.0
    for mask in range(1 << n):
        if best[mask] < 0:
            continue
        i = 0
        while i < n and (mask >> i) & 1:
            i += 1
        if i == n:
            continue
        m2 = mask | (1 << i)
        best[m2] = max(best[m2], best[mask])
        for j in range(i + 1, n):
            if not (mask >> j) & 1 and W[i, j] > 0:
                m3 = m2 | (1 << j)
                best[m3] = max(best[m3], best[mask] + W[i, j])
    return best[-1]


def test_blossom_is_exact_against_brute_force():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(2, 11))
        edges = [(i, j) for i, j in itertools.combinations(range(n), 2)
                 if rng.random() < 0.6]
        if not edges:
            continue
        src = np.array([e[0] for e in edges])
        dst = np.array([e[1] for e in edges])
        w = rng.integers(1, 20, size=len(edges)).astype(np.float64)
        pairs = native.max_weight_matching(src, dst, w, n)
        W = np.zeros((n, n))
        W[src, dst] = w
        W += W.T
        got = sum(W[i, j] for i, j in pairs)
        assert got == _best_matching_weight(W), n
        flat = pairs.ravel().tolist()
        assert len(set(flat)) == len(flat)


def _csr(seed: int, n: int, m: int):
    """A random symmetric CSR graph (no loops, duplicates merged)."""
    src, dst, _ = _graph(seed, n, m)
    row = np.concatenate([src, dst])
    col = np.concatenate([dst, src])
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=indptr[1:])
    return indptr, col


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("seed,n,m", [(0, 60, 300), (1, 500, 2500),
                                      (2, 2000, 6000)])
def test_partition_graph_equals_jax(seed, n, m, k):
    indptr, col = _csr(seed, n, m)
    for slack, passes in ((0.02, 10), (0.06, 8)):
        part, cut = native.partition_graph(indptr, col, k, slack=slack,
                                           passes=passes)
        jpart, jcut = jnative.partition_graph(indptr, col, k, slack=slack,
                                              passes=passes)
        assert np.array_equal(part, jpart) and cut == jcut
        assert part.min() >= 0 and part.max() < k


@pytest.mark.parametrize("seed,n,m", [(0, 50, 400), (3, 300, 5000)])
def test_csr_sort_dedup_equals_jax(seed, n, m):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    vals = rng.normal(size=m)
    got = native.csr_sort_dedup(rows, cols, vals)
    want = jnative.csr_sort_dedup(rows.copy(), cols.copy(), vals.copy())
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    keys = got[0] * n + got[1]
    assert (np.diff(keys) > 0).all()
    assert np.isclose(got[2].sum(), vals.sum())


@pytest.mark.parametrize("seed,n,m", [(0, 100, 60), (4, 2000, 1500)])
def test_connected_components_equals_jax(seed, n, m):
    src, dst, _ = _graph(seed, n, m)
    n_comp, comp = native.connected_components(src, dst, n)
    jn, jcomp = jnative.connected_components(src, dst, n)
    assert n_comp == jn and np.array_equal(comp, jcomp)
    assert len(np.unique(comp)) == n_comp
    assert (comp[src] == comp[dst]).all()
