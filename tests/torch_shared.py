"""Helpers shared by the port's test modules (``tests/test_torch_*.py``).

Import what a module needs by name; the fixture ``one_thread`` becomes the
module's own when imported into it (``from torch_shared import
one_thread``).
"""

import fcntl
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one thread for torch and for NumPy's BLAS, so the
    suite's parallel workers do not oversubscribe the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def jax_native_lib():
    """The JAX package's native library, which builds itself in its own
    directory at first load; the load is serialized across test workers
    so that none reads a library another is still writing."""
    from graphslim_tpu import native as jnative

    lock = REPO / "build" / "jax_native.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        return jnative.load()


def determined_columns(L: np.ndarray, K: int) -> list:
    """The columns of a first-K Laplacian basis that float32 determines:
    1..K-1 less those whose eigenvalue lies within 1e-3 of the first one
    left out.  Column 0 is the null space, whose float32 eigenvalue is
    rounding: it is zeroed or scaled by that rounding's ``λ^-1/2``."""
    lam = np.linalg.eigvalsh(np.asarray(L, dtype=np.float64))
    k = min(K, L.shape[0] - 1)
    return [j for j in range(1, k) if lam[k] - lam[j] > 1e-3]


def basis64(L: np.ndarray, K: int) -> np.ndarray:
    """The first-K basis ``U diag(λ^-1/2)`` (λ₀ zeroed) from a float64
    ``eigh`` of the dense Laplacian: what the float32 bases approximate."""
    lam, U = np.linalg.eigh(np.asarray(L, dtype=np.float64))
    k = min(K, L.shape[0] - 1)
    lam, U = lam[:k], U[:, :k]
    null = lam < 1e-10
    return U * np.where(null, 0.0, np.where(null, 1.0, lam) ** -0.5)


def cheapest_relative_errors(exact: np.ndarray, n: int, r: float,
                             *costs: np.ndarray) -> list:
    """Largest relative error of each cost array against ``exact`` over
    the candidate sets the first level of a component of ``n`` nodes can
    pop: the ``floor(r_cur·n)`` cheapest finite ones, ``r_cur`` as
    ``CoarsenBase.coarsen_component`` derives it from the rate ``r``."""
    r = float(np.clip(r, 0, 0.999))
    r_cur = float(np.clip(1 - np.ceil(r * n) / n, 0.0, 0.99))
    fin = np.flatnonzero(np.isfinite(exact))
    idx = fin[np.argsort(exact[fin], kind="stable")[:int(r_cur * n)]]
    return [float((np.abs(c[idx] - exact[idx]) / np.abs(exact[idx])).max())
            for c in costs]


def first_level_costs(module, agent, W, B) -> np.ndarray:
    """Every candidate set's cost at the first level of a variation
    coarsener of ``module`` (the heap's costs; the matching's negated
    edge weights), with the selection itself stubbed out."""
    seen = {}

    def sets(costs, *a, **kw):
        seen["costs"] = np.asarray(costs, dtype=np.float64)
        return []

    def matching(edges, weights, *a):
        seen["costs"] = -np.asarray(weights, dtype=np.float64)
        return []

    with mock.patch.object(module, "_greedy_set_selection", sets), \
            mock.patch.object(module, "_greedy_matching", matching):
        agent.contract_sets(W, B, 0.5)
    return seen["costs"]


def dataset_pair(name: str, seed: int = 0) -> tuple:
    """The same twin loaded by both packages: (JAX dataset, port dataset
    on the CPU)."""
    from graphslim_tpu.data import load as jload
    from graphslim_tpu_torch.data import load

    return jload(name, seed=seed), load(name, seed=seed, device="cpu")


def reduced_pair(jds, kind: str, n: int = 60, onehot: bool = False) -> tuple:
    """The same reduced triple in both packages (JAX ``Reduced``, port
    ``Reduced`` on the CPU): the first ``n`` rows of the graph reducers
    consume, with their induced subgraph as a ``SparseAdj`` (``kind``
    "sparse"), dense ("dense") or no adjacency ("none"), and labels as
    class ids or one-hot rows."""
    import jax.numpy as jnp

    from graphslim_tpu import graph as JG
    from graphslim_tpu_torch import graph as G

    feat, adj, labels = jds.train_graph()
    rows = np.arange(n)
    jsub = JG.submatrix(adj, rows)
    f = np.asarray(feat)[rows]
    y = np.asarray(labels)[rows].astype(np.int64)
    if onehot:
        y = np.eye(int(jds.nclass), dtype=np.float32)[y]
    if kind == "sparse":
        ja = jsub
        ta = G.from_edge_index(JG.to_edge_index(jsub), n,
                               edge_weight=np.asarray(jsub.values_or_ones()),
                               dedup=False, device="cpu")
    elif kind == "dense":
        dense = np.asarray(jsub.to_dense())
        ja, ta = jnp.asarray(dense), torch.as_tensor(np.array(dense))
    else:
        ja = ta = None
    return (JG.Reduced(feat=jnp.asarray(f), adj=ja, labels=jnp.asarray(y)),
            G.Reduced(feat=torch.as_tensor(f), adj=ta,
                      labels=torch.as_tensor(y)))
