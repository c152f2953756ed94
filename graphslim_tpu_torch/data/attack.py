"""Adversarial graph corruption for robustness studies.

Counterpart of ``graphslim_tpu/data/attack.py`` (reference
``graphslim/dataset/attack.py:16-95``, ``models/{prbcd,random_attack}.py``):

* ``random_adj``: add ``ptb_r·|E|/2`` random edges;
* ``random_feat``: Gaussian noise in place of the features of a ``ptb_r``
  share of the nodes;
* ``metattack`` (also ``prbcd``): PRBCD, projected randomized block
  coordinate descent ("Robustness of GNNs at Scale").

Every draw is ``np.random.default_rng(args.seed)`` on the host, in the
JAX package's order, so ``random_adj`` and ``random_feat`` give the same
graph and features in both packages.  The result is cached as the JAX
package caches it, ``save_path/corrupt_graph/<attack>/<name>_<ptb_r>.npz``
(``edge_index``, and ``feat`` for ``random_feat``); each package reads the
other's file.

The attacked dataset is built from a new host mirror of the attacked edge
list and carries none of the clean graph's caches (normalized adjacencies,
ELL layout, blocked layouts, inductive views), so every reducer and
evaluator reads the attacked graph.  The JAX package keeps the clean
``adj_host`` there, and its ``adj_norm()`` is the clean graph's.
``random_feat`` keeps the clean adjacency with its caches and replaces
the features only.

PRBCD's forward on the modified graph ``A + P`` (``P`` the candidate
block's weights, ``sign·p``, placed symmetrically) is, with
``deg = A·1 + P·1 + 1`` and ``dinv = deg^-1/2``,
``Â_p x = dinv ⊙ (A (dinv ⊙ x)) + dinv ⊙ (P (dinv ⊙ x)) + dinv² ⊙ x``.
On the card the base product goes through the blocked SpMM over ``A``'s
cached layout (its gradient reaches ``p`` through ``dinv``), and the
candidate block, rebuilt every epoch, through the gather and segment sum
of :func:`graphslim_tpu_torch.kernels.spmm.spmm_plain`, which carries the
gradient of its values (:func:`forward_split`).  The JAX package's one
gather and segment sum over all entries is the plain version
(:func:`forward_plain`), which the CPU takes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.kernels.segment import segment_sum
from graphslim_tpu_torch.kernels.spmm import spmm_plain
from graphslim_tpu_torch.models import nn

log = logging.getLogger("graphslim_tpu_torch")


def _cache_path(args, data) -> str:
    root = os.path.join(args.save_path, "corrupt_graph", args.attack)
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"{data.name}_{args.ptb_r}.npz")


def attack(data: G.Dataset, args) -> G.Dataset:
    """The dataset under ``args.attack`` at rate ``args.ptb_r``, read from
    the cache when there (else computed and cached), with the attacked
    GCN accuracy logged."""
    path = _cache_path(args, data)
    made = utils.build_once(path, lambda: _attack_and_cache(data, args,
                                                            path))
    if made is not None:
        host, feat = made
    else:
        host, feat = None, data.feat
        with np.load(path) as blob:
            if args.attack != "random_feat":
                host = G.host_from_edge_index(blob["edge_index"],
                                              data.n_nodes, dedup=True)
            if "feat" in blob:
                feat = torch.as_tensor(blob["feat"], device=data.device)
    attacked = attacked_dataset(data, host, feat)
    _report_attacked_acc(attacked, args)
    return attacked


def _attack_and_cache(data: G.Dataset, args, path: str) -> tuple:
    """(host mirror or None, features) of the attacked graph, written to
    the cache ``path``."""
    host, feat = None, data.feat
    if args.attack == "random_adj":
        host = _random_adj(data, args)
    elif args.attack == "random_feat":
        feat = _random_feat(data, args)
    elif args.attack in ("metattack", "prbcd"):
        host = prbcd_attack(data, args, block_size=args.prbcd_block,
                            epochs=args.prbcd_epochs,
                            fine_tune_epochs=args.prbcd_fine_tune)
    else:
        raise ValueError(f"unknown attack {args.attack!r}")
    payload = {"edge_index": G.to_edge_index(data.adj) if host is None
               else np.stack([host.row, host.col])}
    if args.attack == "random_feat":
        payload["feat"] = feat.cpu().numpy()
    utils.save_npz(path, **payload)
    return host, feat


def attacked_dataset(data: G.Dataset, host, feat: torch.Tensor
                     ) -> G.Dataset:
    """``data`` with the adjacency of the host mirror ``host`` (None: the
    clean one, with its caches) and the features ``feat``; in the
    inductive setting the views are induced anew."""
    dev = data.device
    if host is None:
        ds = dataclasses.replace(
            data, feat=feat, _view_norm_host=dict(data._view_norm_host),
            _view_norm=dict(data._view_norm))
    else:
        ds = G.Dataset(name=data.name, feat=feat, labels=data.labels,
                       adj=host.to_sparse(dev), idx_train=data.idx_train,
                       idx_val=data.idx_val, idx_test=data.idx_test,
                       nclass=data.nclass, setting=data.setting)
    if data.setting == "ind":
        for split in ("train", "val", "test"):
            idx = getattr(data, f"idx_{split}")
            rows = feat[torch.as_tensor(idx, device=dev)]
            if host is None:
                setattr(ds, f"feat_{split}", rows)
            else:
                ds.set_view(split, rows, getattr(data, f"labels_{split}"),
                            G.host_submatrix(host, idx))
    return ds


def _random_adj(data: G.Dataset, args) -> G.HostAdj:
    """Add ptb_r·|E|/2 random edges (reference RandomAttack 'add')."""
    rng = np.random.default_rng(args.seed)
    n = data.n_nodes
    n_add = int(args.ptb_r * data.adj.nnz / 2)
    src = rng.integers(0, n, size=n_add)
    dst = rng.integers(0, n, size=n_add)
    keep = src != dst
    ei = np.concatenate([G.to_edge_index(data.adj),
                         np.stack([src[keep], dst[keep]])], axis=1)
    return G.host_from_edge_index(ei, n, symmetrize=True)


def _random_feat(data: G.Dataset, args) -> torch.Tensor:
    rng = np.random.default_rng(args.seed)
    feat = data.feat.cpu().numpy().copy()
    n_ptb = int(args.ptb_r * feat.shape[0])
    rows = rng.choice(feat.shape[0], size=n_ptb, replace=False)
    feat[rows] = rng.normal(size=(n_ptb, feat.shape[1])).astype(
        np.float32) * feat.std()
    return torch.as_tensor(feat, device=data.device)


def _triu_pairs(rng: np.random.Generator, n: int, count: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """``count`` random upper-triangle (i<j) pairs, with replacement
    (duplicates alias one flip weight), by the closed-form linear → triu
    index map (reference ``prbcd.py:379-392``)."""
    lin = rng.integers(0, n * (n - 1) // 2, size=count, dtype=np.int64)
    # row r of pair k: largest r with r*n - r(r+1)/2 <= k
    row = (n - 2 - np.floor(
        np.sqrt(-8 * lin + 4 * n * (n - 1) - 7) / 2 - 0.5)).astype(np.int64)
    col = lin + row + 1 - (row * (2 * n - row - 1)) // 2
    return row.astype(np.int32), col.astype(np.int32)


def _edge_key_set(edge_index: np.ndarray, n: int) -> np.ndarray:
    """Sorted canonical (min, max) linear keys of an edge list."""
    lo = np.minimum(edge_index[0], edge_index[1]).astype(np.int64)
    hi = np.maximum(edge_index[0], edge_index[1]).astype(np.int64)
    return np.unique(lo * n + hi)


def _is_existing_edge(keys: np.ndarray, rows: np.ndarray,
                      cols: np.ndarray, n: int) -> np.ndarray:
    """Membership of the (rows < cols) pairs in the sorted keys."""
    q = rows.astype(np.int64) * n + cols.astype(np.int64)
    pos = np.searchsorted(keys, q)
    pos = np.minimum(pos, keys.shape[0] - 1)
    return keys[pos] == q if keys.size else np.zeros(q.shape, dtype=bool)


# ---------------------------------------------------------------------------
# PRBCD on the device
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Block:
    """A candidate block on the device: pairs ``rows < cols`` and the
    sign of their weight, -1 for an existing edge (weight ``1 - p`` after
    the flip) and +1 for an insertion."""

    rows: torch.Tensor
    cols: torch.Tensor
    sign: torch.Tensor

    @classmethod
    def of(cls, rows: np.ndarray, cols: np.ndarray, is_edge: np.ndarray,
           device) -> "Block":
        is_e = torch.as_tensor(is_edge, device=device)
        return cls(torch.as_tensor(rows.astype(np.int64), device=device),
                   torch.as_tensor(cols.astype(np.int64), device=device),
                   torch.where(is_e, -1.0, 1.0))


def forward_plain(params: dict, adj: G.SparseAdj, feat: torch.Tensor,
                  p: torch.Tensor, blk: Block) -> torch.Tensor:
    """Log-probabilities of the surrogate GCN on the modified graph: one
    gather and segment sum over the base entries and the block's, as the
    JAX package composes it."""
    n = feat.shape[0]
    w = blk.sign * p
    row = torch.cat([adj.row, blk.rows, blk.cols])
    col = torch.cat([adj.col, blk.cols, blk.rows])
    val = torch.cat([adj.values_or_ones().to(p.dtype), w, w])
    deg = segment_sum(val, row, n) + 1.0
    dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
    vn = val * dinv[row] * dinv[col]
    self_v = dinv * dinv
    x = feat
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = nn.linear_apply(layer, x)
        x = segment_sum(x[col] * vn[:, None], row, n) + self_v[:, None] * x
        if i != len(layers) - 1:
            x = torch.relu(x)
    return torch.log_softmax(x, dim=-1)


def forward_split(params: dict, adj: G.SparseAdj, feat: torch.Tensor,
                  p: torch.Tensor, blk: Block) -> torch.Tensor:
    """:func:`forward_plain` with the product split: ``A`` through
    ``adj.matmul`` (on the card the blocked SpMM over its cached layout),
    the block through :func:`spmm_plain` with the gradient of its
    weights."""
    n = feat.shape[0]
    w = blk.sign * p
    prow = torch.cat([blk.rows, blk.cols])
    pcol = torch.cat([blk.cols, blk.rows])
    pw = torch.cat([w, w])
    deg = (adj.sum_rows() + segment_sum(w, blk.rows, n)
           + segment_sum(w, blk.cols, n) + 1.0)
    dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))[:, None]
    x = feat
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = nn.linear_apply(layer, x)
        xs = dinv * x
        x = dinv * (adj.matmul(xs) + spmm_plain(prow, pcol, pw, xs, n)) \
            + dinv * xs
        if i != len(layers) - 1:
            x = torch.relu(x)
    return torch.log_softmax(x, dim=-1)


def forward(params, adj, feat, p, blk) -> torch.Tensor:
    """The split on the card, the plain version on the CPU."""
    fn = forward_split if feat.is_cuda else forward_plain
    return fn(params, adj, feat, p, blk)


def tanh_margin_loss(log_probs: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """tanh of the negative classification margin, mean over the nodes
    (reference ``loss_attack`` type 'tanhMargin')."""
    true_lp = log_probs.gather(1, labels[:, None])[:, 0]
    masked = log_probs.scatter(1, labels[:, None], float("-inf"))
    return torch.tanh(masked.max(dim=1).values - true_lp).mean()


def project(p: torch.Tensor, budget: int, eps: float) -> torch.Tensor:
    """Clamp-shift projection onto {Σp ≤ budget, p ∈ [eps, 1 - eps]}, the
    shift found by 40 rounds of bisection (reference ``bisection``)."""
    a, b = p.min() - 1.0, p.max()
    for _ in range(40):
        mid = (a + b) / 2.0
        f = torch.clamp(p - mid, 0.0, 1.0).sum() - budget
        a, b = torch.where(f > 0, mid, a), torch.where(f > 0, b, mid)
    needs = torch.clamp(p, 0.0, 1.0).sum() > budget
    mu = torch.where(needs, (a + b) / 2.0, torch.zeros_like(a))
    return torch.clamp(p - mu, eps, 1.0 - eps)


def loss_and_grad(params, adj, feat, labels, p, blk) -> tuple:
    """The attack loss and its gradient with respect to ``p``."""
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        loss = tanh_margin_loss(forward(params, adj, feat, q, blk), labels)
        g, = torch.autograd.grad(loss, q)
    return loss.detach(), g


def epoch_step(params, adj, feat, labels, p, blk, budget: int,
               lr: float, eps: float) -> tuple:
    """One ascent epoch: the first step of a fresh Adam, which is the
    sign-scaled step, a clamp at ``eps`` and the projection → (p, loss)."""
    loss, g = loss_and_grad(params, adj, feat, labels, p, blk)
    p = p + lr * g / (g.abs() + 1e-12)
    return project(torch.clamp(p, min=eps), budget, eps), loss


def surrogate_init(model, gen: torch.Generator) -> dict:
    """Initial parameters of the surrogate GCN, drawn from ``gen`` (the
    one seam through which a test hands in the JAX package's draw)."""
    return model.init(gen)


def train_surrogate(data: G.Dataset, gen: torch.Generator) -> tuple:
    """The surrogate GCN (hidden 64, 200 epochs) trained on the clean graph
    and its self-training labels: its predictions, the train rows' own
    labels → (params, labels)."""
    model = M.get_model("GCN", M.ModelConfig(
        nfeat=data.n_feat, nhid=64, nclass=data.nclass, nlayers=2,
        dropout=0.0))
    norm = data.adj_norm()
    tr = torch.as_tensor(data.idx_train, device=data.device)
    va = torch.as_tensor(data.idx_val, device=data.device)
    params, _, _ = M.fit_with_val(
        model, gen, train=(data.feat, norm, data.labels[tr], tr),
        val=(data.feat, norm, data.labels[va], va),
        cfg=M.TrainConfig(epochs=200), params0=surrogate_init(model, gen))
    params = utils.tree_map(lambda t: t.detach(), params)
    with torch.no_grad():
        labels = model.apply(params, data.feat, norm).argmax(dim=-1)
    labels[tr] = data.labels[tr]
    return params, labels


def prbcd_attack(data: G.Dataset, args, block_size: int = 250_000,
                 epochs: int = 120, fine_tune_epochs: int = 30,
                 lr_adj: float = 0.2, eps: float = 1e-7,
                 max_final_samples: int = 20) -> G.HostAdj:
    """PRBCD structure attack (reference ``models/prbcd.py:65-440``) → the
    host mirror of the attacked adjacency.

    A surrogate GCN with self-training labels; a random block of
    ``block_size`` upper-triangle candidate pairs; each epoch the
    tanh-margin loss on all nodes, a sign-scaled ascent step, a clamp at
    ``eps`` and the projection onto the budget ``ptb_r·|E|/2``; until
    ``epochs - fine_tune_epochs - 1`` the block keeps its top half by
    weight and is refilled with fresh pairs on the host; finally the
    top-``budget`` pairs, then up to ``max_final_samples - 1`` Bernoulli
    draws under the budget, keeping the draw of the worst surrogate
    validation loss, applied as flips to the host edge list.  The
    surrogate, the epochs and the final draws log their seconds (the
    record's ``prbcd`` attribute)."""
    n = data.n_nodes
    budget = int(args.ptb_r * data.adj.nnz / 2)
    host = G.host_of(data.adj)
    if budget == 0:
        return host
    dev = data.device
    t0 = time.perf_counter()
    utils.seed_everything(args.seed)
    params, st_labels = train_surrogate(
        data, utils.make_generator(args.seed, dev))
    va = torch.as_tensor(data.idx_val, device=dev)
    adj, feat = data.adj, data.feat

    rng = np.random.default_rng(args.seed)
    B = min(block_size, n * (n - 1) // 2)
    ei_base = np.stack([host.row, host.col])
    edge_keys = _edge_key_set(ei_base, n)

    def sample_block(count):
        r, c = _triu_pairs(rng, n, count)
        return r, c, _is_existing_edge(edge_keys, r, c, n)

    rows, cols, is_edge = sample_block(B)
    blk = Block.of(rows, cols, is_edge, dev)
    p = torch.full((B,), eps, dtype=torch.float32, device=dev)
    t1 = time.perf_counter()
    resample_until = epochs - fine_tune_epochs
    for it in range(epochs):
        p, _ = epoch_step(params, adj, feat, st_labels, p, blk, budget,
                          lr_adj, eps)
        if it < resample_until - 1:
            # keep the top half by weight, refill with fresh pairs
            p_np = p.cpu().numpy()
            keep = np.argsort(-p_np)[:B // 2]
            keep = keep[p_np[keep] > eps]
            r2, c2, e2 = sample_block(B - keep.shape[0])
            rows = np.concatenate([rows[keep], r2])
            cols = np.concatenate([cols[keep], c2])
            is_edge = np.concatenate([is_edge[keep], e2])
            p_np = np.concatenate([p_np[keep],
                                   np.full(r2.shape[0], eps,
                                           dtype=np.float32)])
            blk = Block.of(rows, cols, is_edge, dev)
            p = torch.as_tensor(p_np, device=dev)

    # the final discrete sample: top-k, then Bernoulli draws; keep the
    # draw with the WORST surrogate validation loss
    p_np = p.cpu().numpy().copy()
    t2 = time.perf_counter()
    p_np[p_np <= eps] = 0.0
    best_loss, best_mask = -np.inf, None
    with torch.no_grad():
        for _ in range(max_final_samples):
            if best_mask is None:
                mask = np.zeros(B, dtype=np.float32)
                mask[np.argsort(-p_np)[:budget]] = 1.0
                mask[p_np == 0.0] = 0.0
            else:
                mask = (rng.random(B) < p_np).astype(np.float32)
                if mask.sum() > budget:
                    continue
            out = forward(params, adj, feat,
                          torch.as_tensor(mask, device=dev), blk)
            lv = float(utils.nll_loss(out[va], st_labels[va]))
            if lv > best_loss:
                best_loss, best_mask = lv, mask

    sel = best_mask.astype(bool)
    add = sel & ~is_edge
    remove = sel & is_edge
    # apply the flips to the host edge list
    ei = ei_base
    if remove.any():
        rm_keys = np.unique(rows[remove].astype(np.int64) * n
                            + cols[remove].astype(np.int64))
        lo = np.minimum(ei[0], ei[1]).astype(np.int64)
        hi = np.maximum(ei[0], ei[1]).astype(np.int64)
        ei = ei[:, ~np.isin(lo * n + hi, rm_keys)]
    if add.any():
        ei = np.concatenate([ei, np.stack([rows[add], cols[add]])], axis=1)
    stats = dict(budget=budget, applied=int(sel.sum()), add=int(add.sum()),
                 remove=int(remove.sum()), best_val_loss=best_loss,
                 surrogate_s=t1 - t0, epochs_s=t2 - t1,
                 final_s=time.perf_counter() - t2, epochs=epochs, block=B)
    log.info("PRBCD: budget=%d applied=%d (add=%d remove=%d) "
             "best_val_loss=%.4f; surrogate %.2f s, %d epochs %.2f s, "
             "final draws %.2f s", budget, stats["applied"], stats["add"],
             stats["remove"], best_loss, stats["surrogate_s"], epochs,
             stats["epochs_s"], stats["final_s"], extra={"prbcd": stats})
    return G.host_from_edge_index(ei, n, symmetrize=True)


def _report_attacked_acc(data: G.Dataset, args) -> float:
    """Train a GCN (``args.hidden``) on the dataset's graph and log its
    test accuracy (reference ``attack.py:69-95``) → the accuracy."""
    dev = data.device
    model = M.get_model("GCN", M.ModelConfig(
        nfeat=data.n_feat, nhid=args.hidden, nclass=data.nclass,
        nlayers=2, dropout=0.0))
    norm = data.adj_norm()
    tr, va, te = (torch.as_tensor(i, device=dev)
                  for i in (data.idx_train, data.idx_val, data.idx_test))
    params, _, _ = M.fit_with_val(
        model, utils.make_generator(args.seed, dev),
        train=(data.feat, norm, data.labels[tr], tr),
        val=(data.feat, norm, data.labels[va], va),
        cfg=M.TrainConfig(epochs=min(args.eval_epochs, 300)))
    acc = float(M.evaluate(model, params, data.feat, norm, data.labels[te],
                           te))
    log.info("attacked GCN accuracy (%s, ptb=%.2f): %.4f", args.attack,
             args.ptb_r, acc)
    return acc
