#!/usr/bin/env python3
"""Time the blocked SpMM kernel over tile sizes and staging rules.

Run on the card from the root of a checkout: ``python3
tools/spmm_tile_sweep.py``.  Prints the card's name and power limit, then
one line per layout (median of 20 launches, CUDA events, d = 128 unless
said otherwise):

1. the arxiv twin's normalized adjacency (random node order) over the
   destination-tile size ``td`` with every block direct, and with sparser
   and sparser runs staged (``stage_min``);
2. banded graphs of the same size whose neighbours lie within a few rows
   (locality-ordered graphs), where every run reuses its source tile, from
   5 uses of a staged row (14 neighbours within 128 rows) to 60 (64 within
   32) and 128 (dense 128 x 128 diagonal blocks): every block direct
   against every block staged, over the source-tile size ``ts``.

Beside each time: the stored blocks, how many are staged, and the bytes of
``x`` the layout makes the kernel request (gathered rows for direct entries,
whole source tiles for staged blocks).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from graphslim_tpu_torch import graph as G  # noqa: E402
from graphslim_tpu_torch.data import load  # noqa: E402
from graphslim_tpu_torch.kernels import spmm_blocked as SB  # noqa: E402

NEVER = 10 ** 9


def x_bytes(layout, d: int) -> float:
    """Bytes of x that the kernel requests under this layout."""
    lens = torch.diff(layout.blk_ptr.long())
    direct = int(lens[layout.blk_src < 0].sum())
    # consecutive pieces of one run share a staged tile
    staged = layout.blk_src >= 0
    key = layout.blk_dst.long() * (2 ** 31) + layout.blk_src.long()
    tiles = int(torch.unique(key[staged]).numel())
    return direct * d * 4.0 + tiles * layout.ts * d * 4.0


def line(tag: str, adj, x, ref, **sizes) -> None:
    layout = adj.blocked(**sizes)
    out = SB.spmm_blocked(layout, x)
    err = float((out - ref).abs().max())
    if not err <= 1e-5 * float(ref.abs().max()) + 1e-6:
        raise SystemExit(f"spmm_tile_sweep: {tag} {sizes} is off by {err}")
    ms = CS.median_ms(lambda: SB.spmm_blocked(layout, x))
    d = x.shape[1]
    print(f"{tag} d={d} td={layout.td} ts={layout.ts} stage_min="
          f"{sizes.get('stage_min', 'default')}: {ms:.4f} ms, "
          f"blocks={layout.n_blocks} ({layout.n_staged} staged), x bytes "
          f"requested {x_bytes(layout, d) / 1e9:.3f} GB, build "
          f"{layout.build_seconds:.2f} s", flush=True)
    adj._layouts.clear()


def banded(n: int, per_row: int, half_width: int):
    rng = np.random.default_rng(0)
    row = np.repeat(np.arange(n), per_row)
    col = np.clip(row + rng.integers(-half_width, half_width + 1,
                                     row.shape[0]), 0, n - 1)
    if half_width == 0:        # dense diagonal blocks of 128 x 128
        col = (row // 128) * 128 + np.tile(np.arange(per_row), n)
        col = np.minimum(col, n - 1)
    return G.gcn_norm(G.from_edge_index(np.stack([row, col]), n,
                                        symmetrize=True, device="cuda"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("spmm_tile_sweep: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.environ.setdefault("GRAPHSLIM_TORCH_CACHE",
                          os.path.join(HERE, "build", "cache"))
    ds = load("ogbn-arxiv", seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = ds.n_nodes
    for name, make, widths in (
            ("arxiv", ds.adj_norm, (128, 256)),
            ("banded", lambda: banded(n, 14, 128), (128, 256)),
            ("band 64 in +-32", lambda: banded(n, 64, 32), (128,)),
            ("dense 128-blocks", lambda: banded(n, 128, 0), (128,))):
        adj = make()
        print(f"{name}: {adj.n_rows} rows, {adj.nnz} stored entries",
              flush=True)
        for d in widths:
            x = torch.randn(adj.n_rows, d, generator=gen, device="cuda")
            ref = SB.spmm_blocked_plain(adj.blocked(stage_min=NEVER), x)
            csr = adj.to_csr()
            lib = CS.median_ms(lambda: torch.sparse.mm(csr, x))
            print(f"{name} d={d}: torch.sparse.mm {lib:.4f} ms", flush=True)
            for td in (16, 32, 64, 128, 256):
                line(name, adj, x, ref, td=td, stage_min=NEVER)
            if name == "arxiv":
                for stage_min in (8, 4):
                    line(name, adj, x, ref, stage_min=stage_min)
            else:
                for ts in (64, 128, 256, 448):
                    for td in (64, 128):
                        line(name, adj, x, ref, td=td, ts=ts, stage_min=1)
                line(name, adj, x, ref)     # the default sizes and rule


if __name__ == "__main__":
    main()
