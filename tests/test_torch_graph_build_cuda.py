"""The loaded graph's build on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest -s
tests/test_torch_graph_build_cuda.py -m cuda`` (``-s`` shows the build's
and the read-back's seconds).

* ``graph.from_edge_index_on`` and ``graph.submatrix_on`` on the card give
  the CPU build's arrays bit for bit, on a random graph of a few million
  edges.
* After ``data.load`` the card holds the dataset's tensors and nothing
  else: no load-time temporary outlives the load.
"""

import time

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.data import load

pytestmark = pytest.mark.cuda

N_NODES = 400_000
N_EDGES = 3_000_000
# the caching allocator hands a large request a block up to 1 MiB longer
# than the request, rounded to 512 bytes
BLOCK_SLACK = (1 << 20) + 512


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edges(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N_NODES, size=(2, N_EDGES))
    ei[:, :100_000] = ei[:, 100_000:200_000]     # duplicates
    ei[1, 200_000:210_000] = ei[0, 200_000:210_000]  # self loops
    return ei


def _same(a: G.SparseAdj, b: G.SparseAdj) -> None:
    for field in ("indptr", "row", "col"):
        x, y = getattr(a, field).cpu(), getattr(b, field).cpu()
        assert x.dtype == y.dtype == torch.int64, field
        assert torch.equal(x, y), field


def test_the_card_builds_the_cpu_build(card):
    ei = _edges(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adj = G.from_edge_index_on(card, ei, N_NODES)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    ref = G.from_edge_index_on("cpu", ei, N_NODES)
    _same(adj, ref)
    idx = np.sort(np.random.default_rng(1).choice(N_NODES, 260_000,
                                                  replace=False))
    t0 = time.perf_counter()
    sub = G.submatrix_on(adj, idx)
    torch.cuda.synchronize()
    induced = time.perf_counter() - t0
    _same(sub, G.submatrix_on(ref, idx))
    t0 = time.perf_counter()
    h = G.host_of(sub)
    read = time.perf_counter() - t0
    print(f"\n{torch.cuda.get_device_name(0)}: build of {2 * N_EDGES} "
          f"entries {built:.4f} s, induced view {induced:.4f} s, "
          f"read-back of {h.row.shape[0]} entries {read:.4f} s")


def _kept_bytes(ds) -> tuple:
    """(bytes, tensors) of the distinct card storages ``ds`` keeps, each
    rounded up to the allocator's 512 bytes."""
    tensors = [ds.feat, ds.labels]
    for split in ("", "_train", "_val", "_test"):
        adj = getattr(ds, f"adj{split}")
        if adj is not None:
            tensors += [adj.indptr, adj.row, adj.col]
        if split:
            tensors += [getattr(ds, f"feat{split}"),
                        getattr(ds, f"labels{split}")]
    storages = {t.untyped_storage().data_ptr():
                t.untyped_storage().nbytes() for t in tensors}
    return sum(-(-b // 512) * 512 for b in storages.values()), len(storages)


def test_load_keeps_only_the_dataset_on_the_card(card, tmp_path):
    rng = np.random.default_rng(2)
    perm = rng.permutation(N_NODES)
    np.savez(tmp_path / "synth-small.npz", edge_index=_edges(3),
             feat=rng.standard_normal((N_NODES, 16)).astype(np.float32),
             labels=rng.integers(0, 4, N_NODES).astype(np.int32),
             idx_train=perm[:260_000], idx_val=perm[260_000:300_000],
             idx_test=perm[300_000:])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ds = load("synth-small", setting="ind", data_dir=str(tmp_path),
              device=card)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    kept, n = _kept_bytes(ds)
    assert ds.adj._host is None and ds.adj_train._host is None
    assert kept <= held <= kept + n * BLOCK_SLACK, (held, kept, n)
    print(f"\nheld {held} bytes after load, the dataset's {n} storages "
          f"{kept}")
