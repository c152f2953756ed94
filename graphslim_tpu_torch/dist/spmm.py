"""Node-partitioned distributed SpMM over ``torch.distributed``.

Counterpart of ``graphslim_tpu/dist/spmm.py``.  The full graph's rows are
cut into ``S`` contiguous shards of ``rows_per`` rows, one a rank; each
rank aggregates its own rows.  Three feature layouts, as there:

* ``replicated`` — every rank holds all of ``x``; no communication;
* ``gather``     — ``x`` is node-sharded; ``all_gather_into_tensor``
  reassembles it before the local product;
* ``halo``       — ``x`` is node-sharded; each rank receives only the
  boundary rows its edges reference (``all_to_all_single``), padded to one
  size for every pair (:class:`HaloPartition`) or exact a pair
  (:class:`RaggedHaloPartition`, with ``all_to_all_single`` at split sizes
  or ``S - 1`` rounds of ``batch_isend_irecv``).

The routing tables are built on the host in NumPy and equal the JAX
package's bit for bit.  A shard_map body becomes a per-rank function on the
rank's local blocks: every function here takes and returns this rank's
rows, and there is no global view.  Each local product is the blocked
SpMM (:mod:`graphslim_tpu_torch.kernels.spmm_blocked`; the kernel on the
card, its plain version on the CPU) over a layout built once per shard:
square for the interior (locally owned columns), rectangular
``[rows_per, recv_len]`` for the boundary; the send buffer is taken by the
row gather (:mod:`graphslim_tpu_torch.kernels.smem_gather`).  The ragged
layout starts its exchange asynchronously, runs the interior product while
the rows are in flight, then waits and adds the boundary product: the
port's form of the overlap the JAX package leaves to XLA's scheduler.

:class:`DistAdj` carries the ``matmul`` contract of
``models.base.aggregate`` for the evaluator's validation and test
forwards.  It is forward-only: nothing in either package differentiates
through it, and its ``matmul`` raises on an input that requires grad.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.dist.mesh import all_gather, axis_size
from graphslim_tpu_torch.kernels.smem_gather import gather_rows
from graphslim_tpu_torch.kernels.spmm_blocked import (BlockedCOO,
                                                      build_blocked,
                                                      spmm_blocked)


def _host(adj) -> G.HostAdj:
    return adj if isinstance(adj, G.HostAdj) else G.host_of(adj)


# ---------------------------------------------------------------------------
# Host-side routing tables (NumPy; equal to the JAX package's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Edge lists per shard, padded to a common length.

    ``row_local[s, e]`` is the row index *within shard s*; padded slots
    carry ``val = 0``.  ``counts[s]`` is shard s's number of real entries
    (they come first)."""

    row_local: np.ndarray   # [S, E_max] int32
    col: np.ndarray         # [S, E_max] int32 (global)
    val: np.ndarray         # [S, E_max] float32
    rows_per_shard: int
    n_rows: int
    counts: np.ndarray      # [S] int64
    _layouts: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @property
    def n_shards(self) -> int:
        return self.row_local.shape[0]

    def rows_of(self, s: int) -> int:
        """Real rows of shard ``s`` (the last one may hold fewer)."""
        lo = min(s * self.rows_per_shard, self.n_rows)
        return min(self.rows_per_shard, self.n_rows - lo)


def partition_rows(adj, n_shards: int) -> RowPartition:
    """Host-side contiguous row partition with per-shard edge padding."""
    h = _host(adj)
    n = h.n_rows
    rows_per = -(-n // n_shards)
    row, col = np.asarray(h.row), np.asarray(h.col)
    val = np.asarray(h.values_or_ones())
    indptr = np.asarray(h.indptr)
    counts = []
    for s in range(n_shards):
        lo = min(s * rows_per, n)
        hi = min((s + 1) * rows_per, n)
        counts.append(int(indptr[hi] - indptr[lo]))
    e_max = max(max(counts), 1)
    rl = np.zeros((n_shards, e_max), dtype=np.int32)
    cl = np.zeros((n_shards, e_max), dtype=np.int32)
    vl = np.zeros((n_shards, e_max), dtype=np.float32)
    for s in range(n_shards):
        lo = min(s * rows_per, n)
        hi = min((s + 1) * rows_per, n)
        a, b = int(indptr[lo]), int(indptr[hi])
        m = b - a
        rl[s, :m] = row[a:b] - lo
        cl[s, :m] = col[a:b]
        vl[s, :m] = val[a:b]
    return RowPartition(rl, cl, vl, rows_per, n,
                        np.asarray(counts, dtype=np.int64))


def edge_cut_order(adj, n_shards: int, slack: float = 0.02,
                   passes: int = 10) -> np.ndarray:
    """Node permutation grouping a balanced min-edge-cut partition.

    The multilevel partitioner of the native host library
    (``native.partition_graph``).  Apply the returned order to the graph
    (and features); contiguous row partitions then align with the parts.
    There is no fallback: the JAX package falls back to reverse
    Cuthill-McKee without its library, the port builds its library or
    raises."""
    from graphslim_tpu_torch import native

    h = _host(adj)
    part, _ = native.partition_graph(np.asarray(h.indptr),
                                     np.asarray(h.col), n_shards,
                                     slack=slack, passes=passes)
    return np.argsort(part, kind="stable")


def _reorder_host(h: G.HostAdj, order: np.ndarray) -> G.HostAdj:
    n = h.n_rows
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return G.host_from_edge_index(
        np.stack([inv[np.asarray(h.row)], inv[np.asarray(h.col)]]), n,
        edge_weight=np.asarray(h.values_or_ones()), dedup=False)


def reorder_adj(adj: G.SparseAdj, order: np.ndarray) -> G.SparseAdj:
    """Relabel nodes of ``adj`` so ``order[i]`` becomes node ``i`` (on
    ``adj``'s device; a ``HostAdj`` stays on the host)."""
    h = _reorder_host(_host(adj), order)
    return h if isinstance(adj, G.HostAdj) else h.to_sparse(adj.device)


def _halo_lists(col: np.ndarray, rows_per: int, D: int) -> list:
    """``uniq[d][s]``: owner-local rows of shard s referenced by shard d
    (none for s == d)."""
    out = []
    for d in range(D):
        owners = col[d] // rows_per
        local_pos = col[d] % rows_per
        out.append([(np.zeros(0, np.int64) if s == d
                     else np.unique(local_pos[owners == s]))
                    for s in range(D)])
    return out


@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Row partition plus halo-exchange routing tables.

    ``send_idx[s, d, h]`` — owner-local row indices shard *s* sends to
    shard *d* (padded with 0; padded edge slots carry ``val = 0``).
    ``col_halo[s, e]`` — each edge's column in shard s's ``[receive |
    local]`` buffer: ``src_shard * H + position``, or ``S * H +
    local row`` for a locally owned column."""

    base: RowPartition
    send_idx: np.ndarray    # [S, S, H] int32 (sender-major)
    col_halo: np.ndarray    # [S, E_max] int32
    halo_size: int          # H
    _layouts: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)


def partition_rows_halo(adj, n_shards: int) -> HaloPartition:
    """Host-side halo routing: per (src, dst) the unique boundary rows."""
    base = partition_rows(adj, n_shards)
    D, rows_per = n_shards, base.rows_per_shard
    col = np.asarray(base.col)
    uniq_lists = _halo_lists(col, rows_per, D)
    H = max([1] + [len(u) for per in uniq_lists for u in per])
    send_idx = np.zeros((D, D, H), dtype=np.int32)
    col_halo = np.zeros_like(col, dtype=np.int32)
    for d in range(D):
        owners = col[d] // rows_per
        local_pos = col[d] % rows_per
        remap = np.zeros(col.shape[1], dtype=np.int32)
        for s in range(D):
            m = owners == s
            if s == d:
                remap[m] = D * H + local_pos[m]
                continue
            uniq = uniq_lists[d][s]
            send_idx[s, d, : len(uniq)] = uniq
            remap[m] = s * H + np.searchsorted(uniq, local_pos[m])
        col_halo[d] = remap
    return HaloPartition(base, send_idx, col_halo, H)


@dataclasses.dataclass(frozen=True)
class RaggedHaloPartition:
    """Halo routing with exact per-pair sizes, each shard's edges split
    into **interior** (column owned locally) and **boundary** (column in
    the receive buffer) segments.

    Each sender packs its per-destination boundary rows back to back
    (``send_flat``, chunk of destination d at ``in_offsets[s, d]``).  The
    receive buffer is **round-major**: the chunk from ``src`` lands at the
    offset of round ``r = (dst - src) mod S``, each round padded to its
    largest chunk (``round_max``), and ``col_bnd`` indexes it.  Interior
    columns are shard-local rows, so the interior product reads only the
    local block and needs nothing from the exchange."""

    base: RowPartition
    send_flat: np.ndarray     # [S, L_max] int32 owner-local rows, packed
    in_offsets: np.ndarray    # [S, S] int32: sender-local chunk starts
    send_sizes: np.ndarray    # [S, S] int32 (sender-major [src, dst])
    out_offsets: np.ndarray   # [S, S] int32: round-major remote offsets
    recv_sizes: np.ndarray    # [S, S] int32 (receiver-major [dst, src])
    row_int: np.ndarray       # [S, Ei] int32 shard-local row
    col_int: np.ndarray       # [S, Ei] int32 shard-local column
    val_int: np.ndarray       # [S, Ei] float32
    row_bnd: np.ndarray       # [S, Eb] int32 shard-local row
    col_bnd: np.ndarray       # [S, Eb] int32 into the receive buffer
    val_bnd: np.ndarray       # [S, Eb] float32
    send_max: int
    recv_len: int
    round_max: tuple          # per-round chunk sizes, len S - 1
    n_int: np.ndarray         # [S] real interior entries (they come first)
    n_bnd: np.ndarray         # [S] real boundary entries
    _layouts: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def round_offset(self, r: int) -> int:
        """Offset of round ``r`` (1 ≤ r < S) in the receive buffer."""
        return int(sum(self.round_max[: r - 1]))


def partition_rows_halo_ragged(adj, n_shards: int) -> RaggedHaloPartition:
    """Host-side ragged halo routing tables with interior/boundary split."""
    base = partition_rows(adj, n_shards)
    D, rows_per = n_shards, base.rows_per_shard
    col = np.asarray(base.col)
    row_l = np.asarray(base.row_local)
    val = np.asarray(base.val)
    uniq = _halo_lists(col, rows_per, D)
    sizes = np.array([[len(uniq[d][s]) for d in range(D)]
                      for s in range(D)], dtype=np.int32)  # [src, dst]
    L_max = max(int(sizes.sum(axis=1).max()), 1)
    round_max = tuple(
        max(int(max(sizes[s, (s + r) % D] for s in range(D))), 1)
        for r in range(1, D))
    base_off = np.zeros(D, dtype=np.int32)       # base_off[r], r=1..D-1
    acc = 0
    for r in range(1, D):
        base_off[r] = acc
        acc += round_max[r - 1]
    R_len = max(acc, 1)
    send_flat = np.zeros((D, L_max), dtype=np.int32)
    in_off = np.zeros((D, D), dtype=np.int32)
    out_off = np.zeros((D, D), dtype=np.int32)
    for s in range(D):
        pos = 0
        for d in range(D):
            c = int(sizes[s, d])
            in_off[s, d] = pos
            out_off[s, d] = base_off[(d - s) % D]
            if c:
                send_flat[s, pos:pos + c] = uniq[d][s]
            pos += c
    # split each shard's edge list into interior (column owned locally)
    # and boundary (column arrives through the exchange) segments
    ints, bnds = [], []
    for d in range(D):
        owners = col[d] // rows_per
        local_pos = col[d] % rows_per
        m_int = owners == d
        ints.append((row_l[d][m_int], local_pos[m_int], val[d][m_int]))
        m_bnd = ~m_int
        remap = np.zeros(int(m_bnd.sum()), dtype=np.int32)
        ob, rb, vb = (local_pos[m_bnd], row_l[d][m_bnd], val[d][m_bnd])
        own_b = owners[m_bnd]
        for s in range(D):
            if s == d:
                continue
            m = own_b == s
            remap[m] = base_off[(d - s) % D] + np.searchsorted(
                uniq[d][s], ob[m])
        bnds.append((rb, remap, vb))
    Ei = max(max(len(t[0]) for t in ints), 1)
    Eb = max(max(len(t[0]) for t in bnds), 1)

    def _pad(triples, width):
        r = np.zeros((D, width), dtype=np.int32)
        c = np.zeros((D, width), dtype=np.int32)
        v = np.zeros((D, width), dtype=np.float32)
        for d, (rr, cc, vv) in enumerate(triples):
            m = len(rr)
            r[d, :m], c[d, :m], v[d, :m] = rr, cc, vv
        return r, c, v

    ri, ci, vi = _pad(ints, Ei)
    rb_, cb, vb_ = _pad(bnds, Eb)
    # real entries of each segment: the padded slots of shard d's edge
    # list (column 0) fall into shard 0's interior or another's boundary,
    # after every real entry of that segment
    pad = col.shape[1] - base.counts
    n_int = np.array([len(t[0]) for t in ints]) - np.where(
        np.arange(D) == 0, pad, 0)
    n_bnd = np.array([len(t[0]) for t in bnds]) - np.where(
        np.arange(D) == 0, 0, pad)
    return RaggedHaloPartition(
        base, send_flat, in_off, sizes, out_off,
        np.ascontiguousarray(sizes.T), ri, ci, vi, rb_, cb, vb_, L_max,
        int(R_len), round_max, n_int.astype(np.int64),
        n_bnd.astype(np.int64))


# ---------------------------------------------------------------------------
# Per-rank layouts and products
# ---------------------------------------------------------------------------

def _blocked(rows, cols, vals, n_rows: int, n_cols: int,
             device) -> BlockedCOO:
    """Blocked layout of the ``[n_rows, n_cols]`` matrix whose entries are
    (rows, cols, vals) in row order."""
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(np.asarray(rows, dtype=np.int64),
                          minlength=n_rows), out=indptr[1:])
    return build_blocked(indptr, cols, vals, device=device, n_cols=n_cols)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x.contiguous()
    if x.shape[0] > rows:
        raise ValueError(f"a block of {x.shape[0]} rows in a shard of "
                         f"{rows}")
    return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])


def _shard_info(mesh, axis: str, part: RowPartition) -> tuple:
    S = axis_size(mesh, axis)
    if S != part.n_shards:
        raise ValueError(f"a partition of {part.n_shards} shards on a "
                         f"{S}-rank mesh axis {axis!r}")
    return S, mesh.get_local_rank(axis), mesh.get_group(axis)


def _check_block(x: torch.Tensor, part: RowPartition, me: int) -> None:
    """``x`` is this rank's block: its real rows, or padded to
    ``rows_per``."""
    if x.ndim != 2 or x.shape[0] not in (part.rows_of(me),
                                         part.rows_per_shard):
        raise ValueError(
            f"shard {me} takes its block of {part.rows_of(me)} rows (or "
            f"{part.rows_per_shard} padded), got {tuple(x.shape)}")


def shard_spmm(mesh, part: RowPartition, x: torch.Tensor,
               mode: str = "replicated", axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``A @ x`` → ``[rows_of(rank), d]``.

    ``replicated``: ``x`` is all of ``[n_rows, d]`` on every rank.
    ``gather``: ``x`` is this rank's block of rows (node-sharded), which
    ``all_gather_into_tensor`` reassembles before the local product."""
    S, me, group = _shard_info(mesh, axis, part)
    rows_per = part.rows_per_shard
    if mode == "replicated":
        if x.shape[0] != part.n_rows:
            raise ValueError(f"replicated x must have {part.n_rows} rows, "
                             f"got {tuple(x.shape)}")
        xs = x.contiguous()
    elif mode == "gather":
        _check_block(x, part, me)
        xs = x.new_empty((S * rows_per, x.shape[1]))
        all_gather(xs, _pad_rows(x, rows_per), group)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    key = (me, xs.shape[0], x.device)
    if key not in part._layouts:
        c = int(part.counts[me])
        part._layouts[key] = _blocked(
            part.row_local[me, :c], part.col[me, :c], part.val[me, :c],
            rows_per, xs.shape[0], x.device)
    return spmm_blocked(part._layouts[key], xs)[: part.rows_of(me)]


def shard_spmm_halo(mesh, hp: HaloPartition, x: torch.Tensor,
                    axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``A @ x`` → ``[rows_of(rank), d]``, with
    boundary-only exchange: ``x`` is this rank's block; every pair moves
    ``H`` rows (``all_to_all_single``)."""
    part = hp.base
    S, me, group = _shard_info(mesh, axis, part)
    _check_block(x, part, me)
    rows_per, H = part.rows_per_shard, hp.halo_size
    xs = _pad_rows(x, rows_per)
    sidx = torch.as_tensor(hp.send_idx[me].reshape(-1), device=x.device)
    send = gather_rows(xs, sidx)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    key = (me, x.device)
    if key not in hp._layouts:
        c = int(part.counts[me])
        hp._layouts[key] = _blocked(
            part.row_local[me, :c], hp.col_halo[me, :c], part.val[me, :c],
            rows_per, S * H + rows_per, x.device)
    return spmm_blocked(hp._layouts[key], torch.cat([recv, xs]))[
        : part.rows_of(me)]


class RankPlan:
    """One rank's device tables of a :class:`RaggedHaloPartition`: the
    interior layout, the send rows and the sizes, and (at first use) the
    boundary layout of either exchange."""

    def __init__(self, hp: RaggedHaloPartition, me: int, device):
        self.hp, self.me, self.device = hp, me, device
        rows_per = hp.base.rows_per_shard
        self.rows_per = rows_per
        ni = int(hp.n_int[me])
        self.interior = _blocked(hp.row_int[me, :ni], hp.col_int[me, :ni],
                                 hp.val_int[me, :ni], rows_per, rows_per,
                                 device)
        self.send_sizes = [int(v) for v in hp.send_sizes[me]]
        self.recv_sizes = [int(v) for v in hp.recv_sizes[me]]
        self.send_idx = torch.as_tensor(
            hp.send_flat[me, :sum(self.send_sizes)].astype(np.int64),
            device=device)
        self.n_bnd = int(hp.n_bnd[me])
        self.recv_total = sum(self.recv_sizes)
        self._bnd: dict = {}

    def send_rows(self, xs: torch.Tensor) -> torch.Tensor:
        """The send buffer: the rows of this rank's block that each peer
        reads, peer by peer (the gather kernel on the card)."""
        return gather_rows(xs, self.send_idx)

    def new_recv(self, d: int, ragged: bool, like: torch.Tensor):
        """The receive buffer of either exchange: source-major, back to
        back (``ragged``), or round-major at the rounds' offsets."""
        if ragged:
            return like.new_empty((self.recv_total, d))
        return like.new_zeros((self.hp.recv_len, d))

    def rounds(self) -> list:
        """The point-to-point exchange, round r = 1 .. S - 1:
        ``(dst, (lo, hi), src, (lo, hi))``, the send buffer's slice that
        goes to ``dst = (me + r) mod S`` and the receive buffer's slice
        that ``src = (me - r) mod S`` fills (either may be empty)."""
        hp, me = self.hp, self.me
        S = hp.base.n_shards
        out = []
        for r in range(1, S):
            dst, src = (me + r) % S, (me - r) % S
            lo_out = int(hp.in_offsets[me, dst])
            lo_in = hp.round_offset(r)
            out.append((dst, (lo_out, lo_out + self.send_sizes[dst]),
                        src, (lo_in, lo_in + self.recv_sizes[src])))
        return out

    def boundary(self, ragged: bool) -> Optional[BlockedCOO]:
        """The boundary product's ``[rows_per, buffer]`` layout (None
        without boundary entries).  The rounds land in the round-major
        buffer ``col_bnd`` indexes; the all-to-all lands the chunks
        source-major, back to back, so its columns move from their round's
        offset to their source's."""
        if not self.n_bnd:
            return None
        if ragged not in self._bnd:
            hp, me, nb = self.hp, self.me, self.n_bnd
            S = hp.base.n_shards
            col = hp.col_bnd[me, :nb].astype(np.int64)
            n_cols = hp.recv_len
            if ragged:
                src_off = np.concatenate([[0], np.cumsum(self.recv_sizes)])
                shift = np.zeros(hp.recv_len, dtype=np.int64)
                for s in range(S):
                    if s != me and self.recv_sizes[s]:
                        lo = hp.round_offset((me - s) % S)
                        shift[lo:lo + self.recv_sizes[s]] = src_off[s] - lo
                col, n_cols = col + shift[col], self.recv_total
            self._bnd[ragged] = _blocked(
                hp.row_bnd[me, :nb], col, hp.val_bnd[me, :nb],
                self.rows_per, n_cols, self.device)
        return self._bnd[ragged]

    def product(self, xs: torch.Tensor, recv: torch.Tensor, ragged: bool,
                works=()) -> torch.Tensor:
        """This rank's rows of ``A @ x`` (``rows_per`` of them) from its
        padded block ``xs`` and the receive buffer ``recv``: the interior
        (square) blocked SpMM, then, once the exchange's ``works`` are
        done, the boundary (rectangular) one added."""
        bnd = self.boundary(ragged)
        out = spmm_blocked(self.interior, xs)
        for w in works:
            w.wait()
        if bnd is not None:
            out = out + spmm_blocked(bnd, recv)
        return out


def rank_plan(hp: RaggedHaloPartition, me: int, device) -> RankPlan:
    """Rank ``me``'s :class:`RankPlan` on ``device``, built once."""
    key = (me, torch.device(device))
    if key not in hp._layouts:
        hp._layouts[key] = RankPlan(hp, me, device)
    return hp._layouts[key]


def shard_spmm_halo_ragged(mesh, hp: RaggedHaloPartition, x: torch.Tensor,
                           axis: str = "data",
                           use_ragged: Optional[bool] = None,
                           padded: bool = False) -> torch.Tensor:
    """This rank's rows of ``A @ x``, the boundary exchange overlapped
    with the interior product.

    ``x`` is this rank's block: its real rows (``padded=False``; the
    result is cut to them) or ``rows_per`` rows (``padded=True``, the
    steady state: the result keeps them).  ``use_ragged=True`` moves
    exactly ``sizes[s, d]`` rows a pair with one ``all_to_all_single`` at
    split sizes; the default (``False``, as in the JAX package) runs
    ``S - 1`` rounds of ``batch_isend_irecv``, round r sending to rank
    ``(me + r) mod S``.  Either exchange is started asynchronously; the
    interior product runs while it is in flight
    (:meth:`RankPlan.product`)."""
    part = hp.base
    S, me, group = _shard_info(mesh, axis, part)
    _check_block(x, part, me)
    if padded and x.shape[0] != part.rows_per_shard:
        raise ValueError(f"a padded block has {part.rows_per_shard} rows, "
                         f"got {tuple(x.shape)}")
    use_ragged = False if use_ragged is None else use_ragged
    plan = rank_plan(hp, me, x.device)
    xs = _pad_rows(x, plan.rows_per)
    send = plan.send_rows(xs)
    recv = plan.new_recv(xs.shape[1], use_ragged, xs)
    works = []
    if use_ragged:
        if S > 1:
            works.append(dist.all_to_all_single(
                recv, send, output_split_sizes=plan.recv_sizes,
                input_split_sizes=plan.send_sizes, group=group,
                async_op=True))
    else:
        ops = []
        for dst, (lo, hi), src, (li, hi_in) in plan.rounds():
            if hi > lo:
                ops.append(dist.P2POp(
                    dist.isend, send[lo:hi],
                    dist.get_global_rank(group, dst), group=group))
            if hi_in > li:
                ops.append(dist.P2POp(
                    dist.irecv, recv[li:hi_in],
                    dist.get_global_rank(group, src), group=group))
        if ops:
            works.extend(dist.batch_isend_irecv(ops))
    out = plan.product(xs, recv, use_ragged, works)
    return out if padded else out[: part.rows_of(me)]


# ---------------------------------------------------------------------------
# The evaluator's adjacency
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """Rows of a node-sharded output picked at given positions: the port's
    :meth:`DistAdj.remap_idx`.  ``local`` are this rank's block rows that
    are picked, ``pos`` their places in the pick; :meth:`take_rows`
    writes them into zeros and sums over the ranks, so every rank holds
    all ``n`` picked rows, equal to a local pick bit for bit (each row is
    one rank's value plus zeros)."""

    local: torch.Tensor
    pos: torch.Tensor
    n: int
    group: object
    world: int

    def take_rows(self, out: torch.Tensor) -> torch.Tensor:
        full = out.new_zeros((self.n,) + tuple(out.shape[1:]))
        full[self.pos] = out[self.local]
        if self.world > 1:
            dist.all_reduce(full, group=self.group)
        return full


def _forward_only(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "DistAdj is forward-only: nothing differentiates through the "
            "sharded product (the evaluator's validation and test forwards "
            "run under no_grad)")


@dataclasses.dataclass(frozen=True)
class DistAdj:
    """Mesh-sharded full-graph adjacency with the ``matmul`` contract of
    ``models.base.aggregate``.

    Rows are partitioned by the multilevel edge-cut order.  Two calling
    conventions, as in the JAX package:

    * **padded domain** (steady state): :meth:`pad_features` gives this
      rank's block of the features in partition order, ``rows_per`` rows;
      every layer's product goes through :meth:`padded_view` on blocks;
      rows of the output are picked through :meth:`remap_idx`;
    * **convenience**: ``matmul`` on all of ``[n, d]`` in the original
      order (on every rank) permutes in, runs, gathers the blocks and
      permutes back: ``[n, d]`` on every rank.

    Forward-only: ``matmul`` raises on an input that requires grad."""

    hp: RaggedHaloPartition
    order: np.ndarray     # new -> old node id
    inv: np.ndarray       # old -> new node id
    mesh: object
    axis: str
    nnz: int

    @property
    def n_padded(self) -> int:
        p = self.hp.base
        return p.n_shards * p.rows_per_shard

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank(self.axis)

    def _rows(self) -> tuple:
        p = self.hp.base
        lo = min(self.rank * p.rows_per_shard, p.n_rows)
        return lo, lo + p.rows_of(self.rank)

    def pad_features(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x`` [n, d] (original order) in partition
        order, zero-padded to ``rows_per`` rows (once a forward, outside
        the per-layer products)."""
        lo, hi = self._rows()
        sel = torch.as_tensor(self.order[lo:hi], device=x.device)
        return _pad_rows(x.index_select(0, sel),
                         self.hp.base.rows_per_shard)

    def remap_idx(self, idx) -> ShardedRows:
        """Original-order node indices → the picker of those rows of a
        padded-domain output (:class:`ShardedRows`)."""
        idx = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx,
                         dtype=np.int64)
        p = self.hp.base
        new = self.inv[idx]
        mine = (new // p.rows_per_shard) == self.rank
        dev = self.mesh.device_type
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dev == "cuda" else torch.device(dev)
        return ShardedRows(
            local=torch.as_tensor(new[mine] - self.rank * p.rows_per_shard,
                                  device=dev),
            pos=torch.as_tensor(np.flatnonzero(mine), device=dev),
            n=int(idx.shape[0]), group=self.mesh.get_group(self.axis),
            world=axis_size(self.mesh, self.axis))

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        _forward_only(x)
        if x.shape[0] != self.hp.base.n_rows:
            raise ValueError(
                f"DistAdj.matmul expects original-order [n_rows="
                f"{self.hp.base.n_rows}, d] features, got "
                f"{tuple(x.shape)}; for this rank's padded-domain block "
                f"use padded_view().matmul")
        out = shard_spmm_halo_ragged(self.mesh, self.hp,
                                     self.pad_features(x), axis=self.axis,
                                     padded=True)
        full = out.new_empty((self.n_padded, out.shape[1]))
        all_gather(full, out, self.mesh.get_group(self.axis))
        return full[torch.as_tensor(self.inv, device=out.device)]

    def padded_view(self) -> "PaddedDistAdj":
        """View whose ``matmul`` takes and returns this rank's padded
        block, unambiguous even when ``n_rows`` divides evenly."""
        return PaddedDistAdj(self)


@dataclasses.dataclass(frozen=True)
class PaddedDistAdj:
    """Padded-domain view of :class:`DistAdj`: ``matmul`` takes and
    returns this rank's ``[rows_per, d]`` block in partition order."""

    base: DistAdj

    @property
    def nnz(self) -> int:
        return self.base.nnz

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        _forward_only(x)
        b = self.base
        return shard_spmm_halo_ragged(b.mesh, b.hp, x, axis=b.axis,
                                      padded=True)


def build_dist_adj(adj_norm, mesh, axis: str = "data") -> DistAdj:
    """Partition a normalized full-graph adjacency (a ``SparseAdj`` or its
    ``HostAdj`` mirror) over ``mesh``: edge-cut order, reorder, ragged halo
    tables, all on the host."""
    h = _host(adj_norm)
    n_shards = axis_size(mesh, axis)
    order = edge_cut_order(h, n_shards)
    hp = partition_rows_halo_ragged(_reorder_host(h, order), n_shards)
    inv = np.empty(h.n_rows, dtype=np.int64)
    inv[order] = np.arange(h.n_rows)
    return DistAdj(hp=hp, order=order.astype(np.int64), inv=inv, mesh=mesh,
                   axis=axis, nnz=int(h.row.shape[0]))


def sharded_graph_forward(mesh, part: RowPartition, w_list,
                          x: torch.Tensor, axis: str = "data"
                          ) -> torch.Tensor:
    """Multi-layer GCN-style forward with a sharded graph: per layer
    X ← A @ (X W), relu between layers; ``x`` replicated, the result this
    rank's rows (each layer's rows gathered for the next)."""
    S, me, group = _shard_info(mesh, axis, part)
    h = x
    for i, w in enumerate(w_list):
        blk = shard_spmm(mesh, part, h @ w, mode="replicated", axis=axis)
        if i != len(w_list) - 1:
            blk = torch.relu(blk)
            full = blk.new_empty((S * part.rows_per_shard, blk.shape[1]))
            all_gather(full, _pad_rows(blk, part.rows_per_shard), group)
            h = full[: part.n_rows]
        else:
            h = blk
    return h
