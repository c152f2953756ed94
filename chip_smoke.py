#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``graphslim_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
line of output each, any failed check raises (non-zero exit):

1. the card's name and power limit; build of the kernels (one nvcc for
   each source under ``graphslim_tpu_torch/csrc``, all started together);
2. the PGE forward kernel against its plain version on the card (both
   with bf16 matmul operands, the kernels' only precision), at the
   slice's shapes (n = 1354, H = 256, L2 = 1), the inductive twins'
   (n = 713 and 186 at H = 256, 36 at H = 128; timed beside their
   bounds) and smaller ragged ones; at the slice's shape both
   launch kinds (keeping the workspace the backward reads, and without
   it, as under no_grad), equal bit for bit, each timed with the bytes of
   workspace it allocates;
3. the PGE backward kernel against autograd of the plain version, on all
   seven gradients, and against a float64 plain version with float32
   operands; at the slice's shape its time beside the bytes of
   device-memory scratch a launch allocates;
4. GCond on the full-width ``ogbn-arxiv`` twin (n_syn 1354, hidden 256,
   PGE nhid 256, 3 epochs × 20 outer steps, a checkpoint evaluation) through
   ``create_reducer(...).reduce()``, with the kernels' launch counts and a
   torch.profiler breakdown of one epoch;
5. SGC evaluation of ``benchmark/artifacts/arxiv_gcond_r0.01.npz``
   (3 seeds × 300 epochs, accuracy ≥ 0.80) and of the graph from phase 4;
6. the shared-memory row gather against ``torch.index_select`` (exact), at
   the TPU probe's shape (x 4096 × 128, 32,768 indices) for the source
   tile sizes the blocked SpMM considers, staged and direct, with its
   rates, at the shapes the coreset path gives it (every class's pool
   of the twin's training nodes out of 40- and 128-wide embeddings, then
   the 1336 selected rows), and at a width that is no multiple of 4 (the
   largest pool out of a 129-wide matrix, int32 and int64 indices);
7. the blocked SpMM kernel against its plain version and a float64
   product: (a) n = 500, d = 16, td = ts = 128; (b) the arxiv twin's
   normalized adjacency at d = 128, 256, 40, 129, 64 and 192, forward and
   backward, timed beside its bound and ``torch.sparse.mm``; (c) ragged
   graphs with
   empty rows and a row heavier than a tile; each result must repeat bit
   for bit; (d) the train subgraphs' Â of the inductive twins at the
   widths phase 12 gives them (``IND_SPMM_WIDTHS``: flickr 500, 501, 7;
   reddit 602, 603, 256, 41; yelp 2, 33), against the plain version and
   float64 on column slabs, timed beside ``torch.sparse.mm`` and its byte
   bound: in phase 12, on each twin as it is loaded (``--only kernels``
   loads them here);
8. the coreset path at full width through ``train_all.run`` on
   ``ogbn-arxiv`` (r = 0.01, hidden 256, 300 epochs): ``kcenter`` with
   GCN, ``herding`` with ``agg`` and SGC, ``cent_p`` with GCN, 3 seeds
   each, with the kernels' launch counts (the SpMM's by width), a check of
   the GCN that KCenter
   trains (validation ≥ 0.60; logits through the kernel and through its
   plain version agree) and a torch.profiler breakdown of one epoch; then
   the blocked SpMM against its plain version, a float64 product and
   ``torch.sparse.mm`` on the subgraphs that kcenter and cent_p selected;
9. the other condensation methods at full width on the twin, at their
   ogbn-arxiv paper configs (``method_configs.py``) cut in depth, through
   ``create_reducer(...).reduce()`` and the default evaluator (GCN,
   ``ARXIV_EVAL_SEEDS`` = 1 seed × 300 epochs, as in phases 10 and 11).
   ``doscond``, ``gcondx`` and ``gcdm`` run 7 epochs with a checkpoint
   at epoch 1: epoch 0 warms up, epochs 1-5 give the mean epoch wall of
   the idle-share estimate, epoch 6 is profiled.  ``doscond``: one PGE
   forward keeping the workspace and one backward an outer step, no-grad
   forwards only at checkpoints and the end; a torch.profiler split of
   one epoch; then
   ``--resume`` from the saved state, which must start at epoch 2 with the
   saved state bit for bit.  ``gcondx``: no PGE launch.  ``gcdm``: one
   blocked-SpMM launch at d = 256 an outer step and none at d = 40; the
   SpMM's share of an epoch's device time.  ``sgdd``: 1 epoch of 20 outer
   steps with IGNR at n = 1354; peak device memory, the ``eigh``, its
   backward and ``eigvalsh`` of step 11;
10. k-means, the clustering coarseners, VNG, MSGC, Mirage and GECC at
   full width on the twin at r = 0.01, through
   ``create_reducer(...).reduce()`` and the default evaluator (GCN, 1
   seed × 300 epochs), each with its reduce and evaluate seconds, its
   accuracy and the blocked SpMM's launches by width: ``clustering``,
   ``clustering --agg`` (its ``Â²X``: two launches at d = 128) and
   ``averaging``; ``vng`` with a GCN at hidden 256 (the k-means's shape
   and seconds); MSGC's edge scorer kernels against their plain version
   at the MSGC arxiv cell's shapes (n 909, 16 skeletons from
   ``build_skeletons``, 2d = H = 256; forward and backward, bit-equal on
   a repeat, timed beside the plain version and their bounds); ``msgc``
   at its ogbn-arxiv paper config (init
   clustering, 16 skeletons, outer 20, inner 3, SGC ntrans 2) cut to 3 of
   500 epochs with a checkpoint at epoch 1 (the skeleton build's host
   seconds, peak device memory, the scorer's launches counted from 0:
   one backward chain an outer step, at least two forward chains an
   outer step, and ``generator.scored_entries`` equal to the forward
   chains times the skeletons' entries; a torch.profiler split of epoch
   2);
   ``mirage`` at
   its defaults (the quantizing k-means's seconds); ``gecc`` at its
   ogbn-arxiv config (two hops: two launches at d = 128).  Every result
   must be finite; clustering, its agg variant, averaging and gecc must
   score above the test split's largest-class share;
11. the blocked SpMM on the twin's Â at d = 1100 (GDEM's eigensolve block)
   against its plain version and a float64 product, timed beside its
   plain version, ``torch.sparse.mm`` and its bound; then GCSNTK,
   SimGC, SFGC, GEOM and GDEM at full width on the twin at r = 0.01
   (n_syn 1354, GCSNTK 1355; hidden 256, PGE nhid 256), each from a fresh
   ``save_path`` through ``create_reducer(...).reduce()`` and the default
   evaluator (GCN, 1 seed × 300 epochs), with reduce and evaluate
   seconds, peak device memory, the SpMM's launches by width and the
   accuracy (reported, not gated).  Depth is cut: ``simgc`` runs its
   600-epoch teacher, then 60 steps (both sides of the ``it % 50``
   switch, a checkpoint at step 30) and must launch exactly one PGE
   forward keeping the workspace and one backward a step, plus one
   no-grad forward a checkpoint; ``sfgc`` and ``geom`` build a buffer of
   2 experts × 40 epochs (expert and start epochs, and GEOM's curriculum
   length, scaled by 40 / the config's teacher epochs), then run 3 outer
   steps at the paper's ``syn_steps`` (1000, 2100), the buffer written in
   this run; GEOM's soft labels must be float [n_syn, 40] rows that sum to
   1 and read back equal from the artifact; ``gcsntk`` runs 2 epochs over
   its k-means batches (their count and the largest printed) and its
   soft-label artifact must read back equal; ``gdem`` solves for 1000
   eigenpairs on the card, which must stay there (no ARPACK) with a
   residual below 1e-2, 26 SpMM launches at d = 1100 a sweep and its
   cache written in this run, then runs 12 epochs;
12. the inductive setting at full width, depth cut: the flickr twin
   (r = 0.01), after 7 (d): GCond at its paper config (n_syn 713, PGE nhid 256,
   fanouts [15, 8]) for 3 epochs with SGC on the test subgraph (3 seeds ×
   300 epochs), kcenter with GCN (pools local to the train subgraph,
   gathers on the card), then every other ported reducer once (phases
   9-11's cuts, one GCN seed, every training of the run at
   ``FLICKR_EVAL_EPOCHS`` = 100 epochs); the reddit twin (r = 0.001;
   kept loaded for phase 17): GCond (n_syn
   186) for 2 of its 1000 epochs with SGC; the yelp twin: GCond (n_syn 36,
   PGE nhid 128) with GCN scored by macro F1.  Each run prints n_syn,
   reduce seconds, launches by kind and SpMM width, peak memory and the
   idle share of a profiled epoch, step or (device-traced) reduce; GCond
   must keep the PGE launch rule.  Each run's launches are counted from 0
   (the counters are reset just before it and read just after);
13. edge sparsification and structural coarsening through
   ``train_all.run`` (each twin loaded once and handed to it) and the
   default evaluator (GCN, ``COARSEN_EVAL_EPOCHS`` = 100 epochs), at
   each twin's representative rate (``COARSEN_RUNS``): (a) the cora twin,
   all 14 methods with 1 seed, and heavy_edge and variation_edges with
   ``--coarsen_strategy optimal`` (the blossom); (b) the arxiv twin,
   random_edge, g_spar, scan, local_degree, spanning_forest and
   rank_degree, then heavy_edge (reported, not gated); (c) the pubmed
   twin, t_spanner, the variation
   family, algebraic_jc and affinity_gs; (d) the flickr twin
   (inductive), random_edge, g_spar and heavy_edge.  Each run prints
   n_syn, the entries kept, reduce seconds with the share of the dense
   ``eigh`` on the card, evaluate seconds, the accuracy, the SpMM's
   launches by width (counted from 0) and peak memory; every result must
   be finite and read back equal from its artifact, and in (a), (c) and
   (d) every method but spanning_forest and t_spanner must score above
   the test split's largest-class share.  Then the blocked SpMM on the
   normalized Â of the graphs ``HELD`` names (the arxiv twin after
   random_edge; the cora twin after kron, with nearly full tiles, and
   after random_edge) and of the pubmed coarse graph with the most
   entries, at the widths their evaluations launched (cora 7 and 1434,
   the references on slabs of 256 columns), against its plain version
   and float64, bit for bit on a repeat;
14. the model zoo: (a) ``Evaluator.train_cross`` over the eight models
   (MLP, GCN, SGC, APPNP, Cheby, GraphSage, GAT, SGFormer) on the shipped
   arxiv artifact at the evaluator's width (hidden 256, GAT 8 heads of
   32, SGFormer 2 transformer layers; 1 seed × ``ZOO_EPOCHS`` = 100
   epochs, as every training of (b) and (d)), each above
   the test split's largest-class share, with its evaluate seconds, ms an
   epoch, SpMM launches by width, peak memory and idle share; (b) APPNP's
   16-combination ``grid_search`` and its choice; (c) one GAT layer on
   the arxiv twin's ELL layout (buckets, heavy rows, padded slots, build
   seconds and bytes), timed with bf16 messages and in float32 beside its
   byte bound and the segment path, held against the segment path, a
   float64 layer on sampled rows, and as a whole model (float32 within 2e-3
   / 2e-4; bf16 argmax agreement ≥ 0.99, within 0.05); (d) ``random`` on
   the flickr twin, then ``train_cross`` over the eight (GAT through the
   segment path on the val and test subgraphs), each finite; then the
   blocked SpMM at every (graph, width) the phase launched
   (``ZOO_HELD``: the arxiv Â at 40, 128, 129, 256; flickr's selected
   subgraph and its val and test subgraphs at 500, 501, 7, 256) against
   its plain version and float64, bit for bit on a repeat;
15. the attacks, dataset files and the large loader: (a) PRBCD
   (``attack``, metattack) on the cora twin at ptb_r 0.25 and (b) on the
   arxiv twin at 0.05, at the JAX defaults (block 250,000, 120 epochs, 30
   fine-tune, surrogate hidden 64, report GCN hidden 256), each with the
   seconds of its surrogate, epochs and final draws, its budget met (the
   pairs flipped counted from the edge sets) and its attacked GCN
   accuracy below the clean one; (b) also holds the split PRBCD forward
   and its gradient with respect to ``p`` against the plain gather and
   segment-sum version at one block of 250,000 pairs, both against
   float64, and times an epoch's parts and one host resampling; (c)
   ``random_adj`` and ``random_feat`` on arxiv, their caches read back
   equal; (d) GCond (3 epochs, SGC) and kcenter (GCN) on the attacked
   arxiv twin through ``train_all.run``, which must read the attacked
   graph (``adj_norm()`` with the attacked entry count), their triples
   read back by ``run_eval --attack`` from ``corrupt_graph/metattack/``;
   (e) the ``saint-small`` and ``raw-ogb`` fixtures through
   ``load(data_dir=)`` on the card, kcenter / GCN on the first, and
   ``LargeDataLoader`` on arxiv's train rows (batch 3000, 2 GCF hops),
   its hops and k-means timed; then the blocked SpMM against its plain
   version and float64 on the raw adjacencies PRBCD multiplies (cora at
   d = 64, 7; arxiv at 64, 40), the attacked arxiv Â at the widths (d)
   launched and the train subgraph's Â at 128.  Launches by kernel,
   each run's counted from 0, and peak memory;
16. the rest of evaluation, compat, visualization, tracking and
   profiling on the arxiv twin and the shipped artifact: (a)
   ``NasEvaluator.correlation`` over ``QUICK_SPACE`` (16 APPNP
   architectures, ``NAS_EPOCHS`` = 100 epochs a side), every
   original-graph accuracy above the validation split's largest class;
   (b) ``mia_attack`` on an
   SGC and a GCN fitted on the artifact, in [0.5, 1]; (c) the artifact's
   ``PropertyEvaluator.properties``, kcenter on the cora twin (r = 0.5)
   through ``train_all.run --wandb`` and ``compare`` on it; (d)
   ``tsne_vis`` and ``draw_graph_pair`` (PNGs over 1 kB) where matplotlib
   and scikit-learn are installed, else the pair's networkx graphs; (e)
   ``to_torch`` / ``from_torch`` of the arxiv twin and the reference
   layout's round trip of the artifact, equal; (f) GCond (1 epoch, one
   checkpoint evaluation) + SGC through ``train_all.run --profile
   --wandb``, whose trace must name ``pge_fwd_kernel``,
   ``pge_bwd_kernel`` and ``spmm_blocked_kernel``, and ``Throughput`` of
   20 blocked-SpMM launches at d = 128.  WandB's import is blocked (no
   network), so both tracked runs must fall back to ``NullTracker`` with
   its warning and log the reduced graph's stored entries.  Then the
   blocked SpMM at the widths the phase launched that no earlier phase
   holds (the cora twin's Â);
17. the distributed layer (``graphslim_tpu_torch/dist``) at world size 1
   (the machine has one card; the multi-rank paths are held on the CPU by
   ``tests/test_torch_dist.py``): (a) the edge-cut order and the ragged
   halo tables of the arxiv twin's Â at 4 and 8 shards, built twice
   (equal), with host seconds, the parts' balance, the cut and the
   exchanged halo rows; (b) every shard's products in this one process at
   d = 128 and 40 through the port's ``RankPlan``: its receive buffer
   filled from the owners' send buffers (the gather kernel) as the rounds
   deliver them, then ``RankPlan.product``, the interior (square) and
   boundary (rectangular) blocked SpMMs that ``shard_spmm_halo_ragged``
   runs, the shards stacked and permuted
   back against the one-card blocked SpMM, its plain version and float64,
   each shard's ms beside its bound; (c) GCond on the arxiv twin (n_syn
   1354, hidden 256, PGE nhid 256, 2 epochs × 20 outer steps) with its
   matching sharded over a mesh of one rank on NCCL
   (``enable_distributed(1)``), features replicated and sharded: the first
   match loss against the unsharded engine's from the same draws (1e-5
   relative), the PGE launch rule; (d) the
   evaluator's mesh path (``Evaluator.enable_distributed``): SGC on the
   arxiv artifact (3 seeds × 300 epochs, ≥ 0.80), one GCN fit, and the
   reddit twin's gcondx artifact with its val and test subgraphs sharded
   (SGC, 3 seeds, ≥ 0.9569, the random coreset's), each within two test
   nodes of the local evaluation, with seconds and SpMM launches by
   width.  Launches of (c) and (d) are counted from 0; the process group
   is destroyed at the end.

Every profiled window goes through ``profiled`` on
``graphslim_tpu_torch.profiling.session``, which fails when the window
recorded no device time and logs a window whose trace lacks entries of a
port kernel that its launch counter saw.

Phases 6 and 7 run before phase 4.  The line before the last is the
``kernels`` JSON (launches: phases 4 and 8 to 17);
the last line is ``{"ok": true, "device": {...}}``.  ``--only kernels``
stops after the kernel comparisons (phases 2, 3, 6, 7); ``--only
condense`` runs phase 9 alone (after the build), ``--only cluster`` phase
10, ``--only distill`` phase 11, ``--only ind`` phase 12, ``--only
coarsen`` phase 13, ``--only zoo`` phase 14, ``--only attack`` phase
15, ``--only analysis`` phase 16 and ``--only dist`` phase 17, and none
of them prints a result.
Without a CUDA card, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances of the kernel/plain comparisons, max|Δ| ≤ rtol·max|ref| + atol.
# Forward: both versions round the matmul operands to bf16 (relative error
# 2^-9 each); a rounding flip of one operand moves a product by that much.
TOL_FWD = (2e-2, 1e-4)
# Backward: 1.5e-2, 1.7 times the largest reading on the H100 (8.8e-3
# of max|grad|, dwmid at n = 1354): the kernel rounds dz to bf16 before its
# matmuls where autograd of the plain version rounds the matmul results
# instead.  A per-channel sum over all pairs (dbeta, dgamma) can cancel to
# a small result, and there the two roundings differ by more (4.7e-2 of
# max|dbeta| at n = 500, beta + 4); such a gradient passes only where the
# kernel is nearer float64 than the plain version.  Both gradients are
# held to the float64 gradient with fp32 operands (the exact function):
# |kernel - f64| ≤ 2·|plain bf16 - f64| + 1e-4·max|f64|.
TOL_BWD = (1.5e-2, 1e-4)
GRAD_NAMES = ("da", "db", "dwmid", "dbmid", "dgamma", "dbeta", "dwlast")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median over ``reps`` launches, each between its own CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one launch where a launch is shorter than the host
    code that makes it: the card is kept busy (``torch.cuda._sleep``) while
    the host queues ``reps`` launches, which then run back to back between
    one pair of events.  :func:`median_ms` would read the host's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)      # ≈ 20 ms of device time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, ref) -> float:
    return float((got - ref).abs().max()) if ref.numel() else 0.0


def check_close(name: str, got, ref, tol, bad: list, scale=None) -> float:
    """max|got - ref|; a message goes to ``bad`` when it exceeds
    rtol·max|scale| + atol (``scale`` defaults to ``ref``)."""
    rtol, atol = tol
    scale = ref if scale is None else scale
    err = max_err(got, ref)
    lim = rtol * float(scale.abs().max()) + atol if ref.numel() else atol
    if not (err <= lim):
        bad.append(f"{name}: max|Δ| {err:.3e} > {lim:.3e}")
    return err


def pge_inputs(n: int, H: int, L2: int, seed: int, beta_shift: float):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    return [r(n, H), r(n, H), r(L2, H, H, scale=H ** -0.5),
            r(L2, H, scale=0.1), 1.0 + r(L2 + 1, H, scale=0.1),
            beta_shift + r(L2 + 1, H, scale=0.1), r(1, H, scale=H ** -0.5)]


def pge_bounds(n: int, H: int, L2: int) -> dict:
    """Least times of the forward and backward on the card, the larger of
    two: operations of the n² valid pairs' matmuls (forward 2·n²·H²·L2;
    backward twice that, dW and dX) over the bf16 tensor-core peak, and
    bytes over HBM bandwidth, each input read once and each output written
    once.  The forward's function is the scores alone: the workspace it
    also writes is a choice of this design, so it is not counted.  The
    backward reads that workspace as an input (the valid pairs' pre-
    BatchNorm activations, n²·H·L2 floats) instead of recomputing it."""
    flops = {"fwd": 2.0 * n * n * H * H * L2}
    flops["bwd"] = 2 * flops["fwd"]
    params = (L2 * H * H + L2 * H + 2 * (L2 + 1) * H + H) * 4
    ab, scores, ws = 2 * n * H * 4, n * n * 4, n * n * H * L2 * 4
    nbytes = {"fwd": ab + params + scores,
              "bwd": ab + params + scores + ws + ab + params}
    out = {}
    for k in ("fwd", "bwd"):
        t_ops, t_bytes = flops[k] / PEAK_BF16, nbytes[k] / PEAK_BYTES
        out[k] = 1e3 * max(t_ops, t_bytes)
        out[k + "_by"] = "operations" if t_ops > t_bytes else "bytes"
    return out


# ---------------------------------------------------------------------------
# Phases 2-3: kernels against their plain version
# ---------------------------------------------------------------------------

def plain_grads(K, args, R, n: int, bf16: bool, dtype=None) -> list:
    """The seven gradients of sum(plain(args) * R) by autograd."""
    import torch

    leaves = [(a if dtype is None else a.to(dtype)).clone()
              .requires_grad_(True) for a in args]
    with torch.enable_grad():
        s = K.pair_scores_plain(*leaves, n, bf16)
        gs = torch.autograd.grad((s * R.to(s.dtype)).sum(), leaves,
                                 allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)]


def plain_vjp_ms(K, args, R, n: int) -> float:
    """Time of the plain version's backward alone (autograd through a
    graph built once), the counterpart of the backward kernel."""
    import torch

    leaves = [a.clone().requires_grad_(True) for a in args]
    with torch.enable_grad():
        loss = (K.pair_scores_plain(*leaves, n) * R).sum()
        ms = timed_ms(lambda: torch.autograd.grad(
            loss, leaves, retain_graph=True, allow_unused=True), 2)
    del loss
    return ms


# (n, H, L2, BatchNorm beta shift: 4 keeps pre-activations off the ReLU
# kink, 0 is generic).  The first case is the slice's shape and times the
# kernels; at H = 320 a backward block holds one pair of operand tiles,
# not two.  n = 713 (flickr, r = 0.01), n = 186 (reddit, r = 0.001: a
# partial second column tile of 58) and n = 36 at H = 128 (yelp,
# r = 0.001) are the inductive twins' shapes (phase 12).
KERNEL_CASES = [(1354, 256, 1, 0.0), (1354, 256, 1, 4.0),
                (713, 256, 1, 4.0), (500, 256, 1, 4.0), (500, 256, 1, 0.0),
                (200, 256, 2, 4.0), (186, 256, 1, 4.0), (150, 320, 1, 4.0),
                (45, 64, 0, 0.0), (36, 128, 1, 4.0)]
# (n, H, L2) of the inductive twins' PGE, timed beside the slice's shape
IND_PGE_SHAPES = {(713, 256, 1), (186, 256, 1), (36, 128, 1)}


def f64_distances(grads, gref, g64, bad: list, tag: str) -> dict:
    """Each gradient's distance to float64, the kernel's beside the plain
    version's, the kernel's held to twice the plain version's (see
    TOL_BWD)."""
    out = {}
    for i, name in enumerate(GRAD_NAMES):
        if not g64[i].numel():
            continue
        # dbmid is analytically 0: its scale is that of dbeta
        top = float((g64[5] if name == "dbmid" else g64[i]).abs().max())
        e_k = max_err(grads[i].double(), g64[i])
        e_p = max_err(gref[i].double(), g64[i])
        lim = 2 * e_p + 1e-4 * top
        if not e_k <= lim:
            bad.append(f"bwd {name} {tag}: |kernel - f64| {e_k:.3e} > "
                       f"{lim:.3e}")
        out[name] = (e_k, e_p)
    return out


def compare_kernels(K, stats: dict) -> None:
    import torch

    bad: list = []
    for case in KERNEL_CASES:
        n, H, L2, shift = case
        main_shape = case == KERNEL_CASES[0]
        args = pge_inputs(n, H, L2, seed=n + L2, beta_shift=shift)
        R = torch.randn(n, n, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
        # the exact function's gradient: fp32 operands, float64 arithmetic
        g64 = plain_grads(K, args, R, n, False, torch.float64)
        tag = f"n={n} H={H} L2={L2} beta+{shift:g}"
        out, ws, stat = K.pge_fwd(*args, n)
        torch.cuda.synchronize()
        with torch.no_grad():
            ref = K.pair_scores_plain(*args, n)
        e_f = check_close(f"fwd {tag}", out, ref, TOL_FWD, bad)
        if main_shape:   # the launch kind without the workspace
            bare, _, _ = K.pge_fwd(*args, n, keep=False)
            torch.cuda.synchronize()
            check_close(f"fwd no-grad {tag}", bare, ref, TOL_FWD, bad)
            if not torch.equal(bare, out):
                bad.append(f"fwd {tag}: the two launch kinds differ")
        grads = K.pge_bwd(*args, R, ws, stat, n)
        torch.cuda.synchronize()
        gref = plain_grads(K, args, R, n, True)
        e64 = f64_distances(grads, gref, g64, bad, tag)
        errs, rel = {}, {}
        for name, got, want in zip(GRAD_NAMES, grads, gref):
            # dbmid is analytically 0 (BatchNorm shift invariance): its
            # scale is that of dbeta, the same kind of sum
            scale = gref[5] if name == "dbmid" else want
            off: list = []
            errs[name] = check_close(f"bwd {name} {tag}", got, want,
                                     TOL_BWD, off, scale)
            if off and name in ("dgamma", "dbeta") and \
                    e64[name][0] <= e64[name][1]:
                off = []       # a cancelling sum, kernel nearer f64
            bad += off
            if scale.numel():
                rel[name] = errs[name] / max(float(scale.abs().max()), 1e-30)
        e_b = max(errs.values())
        worst = max(rel, key=rel.get)
        line = (f"pge {tag}: fwd max|Δ| {e_f:.2e}; bwd max|Δ| "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (largest / max|ref|: {rel[worst]:.2e}, {worst})"
                + "; |kernel - f64| / |plain - f64|: "
                + ", ".join(f"{k} {a:.3g}/{b:.3g}"
                            for k, (a, b) in e64.items()))
        if main_shape:
            b = pge_bounds(n, H, L2)
            fwd_ms = timed_ms(lambda: K.pge_fwd(*args, n), 10)
            ws_bytes = K.LAST_FWD["workspace_bytes"]
            bare_ms = timed_ms(lambda: K.pge_fwd(*args, n, keep=False), 10)
            bare_bytes = K.LAST_FWD["workspace_bytes"]
            # the kept workspace's z writes alone (every padded pair of
            # every tile), at the HBM rate
            ws_bound = 1e3 * 4 * K._workspace_sizes(n, H, L2)[0] / \
                PEAK_BYTES
            bwd_ms = timed_ms(lambda: K.pge_bwd(*args, R, ws, stat, n), 5)
            with torch.no_grad():
                plain_fwd = timed_ms(
                    lambda: K.pair_scores_plain(*args, n), 3)
            plain_bwd = plain_vjp_ms(K, args, R, n)
            lib = K.build()
            line += (f"; fwd keeping the workspace {fwd_ms:.3f} ms "
                     f"({ws_bytes} bytes of workspace; its z writes "
                     f"alone {ws_bound:.3f} ms at the HBM rate), without "
                     f"{bare_ms:.3f} ms ({bare_bytes} bytes), equal bit "
                     f"for bit (plain {plain_fwd:.3f}, "
                     f"bound {b['fwd']:.3f} by {b['fwd_by']}); bwd "
                     f"{bwd_ms:.3f} ms (plain vjp {plain_bwd:.3f}, "
                     f"bound {b['bwd']:.3f} by {b['bwd_by']}; "
                     f"{K.LAST_BWD['scratch_bytes']} bytes of "
                     f"device-memory scratch a launch, "
                     f"{K.LAST_BWD['grid']} blocks of "
                     f"{lib.pge_bwd_smem_bytes(H)} bytes of "
                     f"shared memory, "
                     f"{K.blocks_per_sm(lib, True, H)} an SM)")
            stats["pge_fwd"] = dict(
                max_abs_err=e_f, ms=fwd_ms, plain_ms=plain_fwd,
                bound_ms=b["fwd"], bound_by=b["fwd_by"],
                ms_nograd=bare_ms, workspace_bound_ms=ws_bound)
            stats["pge_bwd"] = dict(
                max_abs_err=e_b, ms=bwd_ms, plain_ms=plain_bwd,
                bound_ms=b["bwd"], bound_by=b["bwd_by"])
        elif (n, H, L2) in IND_PGE_SHAPES:
            # an inductive twin's shape
            b = pge_bounds(n, H, L2)
            fwd_ms = timed_ms(lambda: K.pge_fwd(*args, n), 10)
            bwd_ms = timed_ms(lambda: K.pge_bwd(*args, R, ws, stat, n), 10)
            with torch.no_grad():
                plain_fwd = timed_ms(
                    lambda: K.pair_scores_plain(*args, n), 3)
            plain_bwd = plain_vjp_ms(K, args, R, n)
            line += (f"; fwd keeping the workspace {fwd_ms:.4f} ms "
                     f"(plain {plain_fwd:.4f}, bound {b['fwd']:.4f} by "
                     f"{b['fwd_by']}); bwd {bwd_ms:.4f} ms (plain vjp "
                     f"{plain_bwd:.4f}, bound {b['bwd']:.4f} by "
                     f"{b['bwd_by']})")
            stats.setdefault("pge_ind", {})[f"n{n}_H{H}"] = dict(
                fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd,
                plain_bwd_ms=plain_bwd, fwd_bound_ms=b["fwd"],
                bwd_bound_ms=b["bwd"])
        log(line)
        del grads, gref, out, ref, ws, stat, g64
        torch.cuda.empty_cache()
    if bad:
        fail("kernels disagree with their plain version:\n  "
             + "\n  ".join(bad))


# ---------------------------------------------------------------------------
# Phase 4: GCond on the arxiv twin
# ---------------------------------------------------------------------------

class Counter:
    """Wraps a bound method of one engine and counts its calls."""

    def __init__(self, obj, name: str):
        self.n = 0
        self.fn = getattr(obj, name)
        setattr(obj, name, self)

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


class EpochTimer:
    """Wraps a reducer's ``_epoch``: wall seconds of each epoch, the PGE
    and SpMM launches inside it, and a torch.profiler breakdown of the
    epoch numbered ``profile_at``."""

    def __init__(self, eng, K, SB, profile_at=None):
        self.eng, self.K, self.SB = eng, K, SB
        self.fn, self.profile_at = eng._epoch, profile_at
        self.seconds, self.pge, self.spmm, self.kernels = [], [], [], None
        self.first_state = None
        eng._epoch = self

    def __call__(self, *a, **kw):
        import torch

        if self.first_state is None:     # copies: epochs update in place
            from graphslim_tpu_torch.utils import tree_leaves

            self.first_state = [
                x.detach().clone() if isinstance(x, torch.Tensor) else x
                for x in tree_leaves(a)] + [self.eng.gen.get_state()]
        torch.cuda.synchronize()
        pge0, spmm0 = dict(self.K.LAUNCHES), dict(self.SB.LAUNCHES_BY_WIDTH)
        t0 = time.perf_counter()
        if len(self.seconds) == self.profile_at:
            out, wall, self.kernels = profiled(lambda: self.fn(*a, **kw),
                                               host=True)
        else:
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        self.seconds.append(wall)
        self.pge.append({k: v - pge0[k] for k, v in self.K.LAUNCHES.items()})
        self.spmm.append({d: c - spmm0.get(d, 0) for d, c in
                          self.SB.LAUNCHES_BY_WIDTH.items()
                          if c > spmm0.get(d, 0)})
        return out

    def mean_wall_ms(self) -> float:
        """Mean wall ms of the ``TIMED`` epochs after the warm-up epoch 0
        (each synchronized at both ends)."""
        secs = self.seconds[1:1 + TIMED]
        if len(secs) != TIMED:
            fail(f"{len(self.seconds)} epochs timed, {1 + TIMED} needed")
        return 1e3 * sum(secs) / TIMED


def device_time_by_kernel(prof) -> tuple:
    """({kernel name: device ms}, {kernel name: entries}) of a
    torch.profiler run, the session's preamble spins left out."""
    from torch.autograd import DeviceType

    from graphslim_tpu_torch.profiling import PREAMBLE_KERNEL

    ms, entries = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or PREAMBLE_KERNEL in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms[e.key] = ms.get(e.key, 0.0) + us / 1e3
        entries[e.key] = entries.get(e.key, 0) + e.count
    return ms, entries


# The port's kernels by the names their entries carry in a trace, and the
# launch counters that count them (kernel module, key).
TRACED = {"pge_fwd": (("pge_fwd_kernel",), "K",
                      ("pge_fwd_ws", "pge_fwd_nows")),
          "pge_bwd": (("pge_bwd_kernel",), "K", ("pge_bwd",)),
          "spmm_blocked": (("spmm_blocked_kernel",), "SB",
                           ("spmm_blocked",)),
          "smem_gather": (("gather_direct_kernel", "smem_gather_kernel"),
                          "SG", ("smem_gather",))}
# Across the run's profiled windows: their number, the earliest device
# event of each against the host's clock at the start of its body (µs;
# negative where the device's timestamps run ahead of the host's), and
# the port-kernel entries each short window's trace lacks.
WINDOWS = {"n": 0, "skew_us": [], "short": []}


def log_windows() -> None:
    skew, short = WINDOWS["skew_us"], WINDOWS["short"]
    if skew:
        log(f"profiled windows: {WINDOWS['n']}, {len(short)} short of "
            f"{sum(short)} port-kernel entries in all; earliest device "
            f"event against the host's clock at the body's start: "
            f"{min(skew):.1f} to {max(skew):.1f} us")


def profiled(fn, host: bool = False, tag: str = "") -> tuple:
    """(result, wall s, {kernel: device ms}) of ``fn()`` in one
    ``graphslim_tpu_torch.profiling.session`` window: the card's work, and
    with ``host`` the host's operators too (a whole reduce has host loops
    of thousands of operators, which a host trace slows severalfold).  The
    wall is taken inside the window, around ``fn`` and a synchronize.
    Fails when the window recorded no device time; a window whose trace
    holds fewer or more entries of a port kernel than its counter saw
    launches is logged and counted (``log_windows``)."""
    import torch

    from graphslim_tpu_torch import profiling
    from graphslim_tpu_torch.kernels import pge as K
    from graphslim_tpu_torch.kernels import smem_gather as SG
    from graphslim_tpu_torch.kernels import spmm_blocked as SB

    mods = {"K": K, "SB": SB, "SG": SG}

    def counts() -> dict:
        return {f: sum(mods[m].LAUNCHES[k] for k in keys)
                for f, (_, m, keys) in TRACED.items()}

    before = counts()
    with profiling.session("cuda", host=host) as prof:
        t_ns = time.time_ns()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {f: c - before[f] for f, c in counts().items()}
    kernels, entries = device_time_by_kernel(prof)
    if not sum(kernels.values()) > 0:
        fail(f"{tag}torch.profiler recorded no device time")
    traced = {f: sum(c for k, c in entries.items()
                     if any(name in k for name in names))
              for f, (names, _, _) in TRACED.items()}
    if traced != launched:
        WINDOWS["short"].append(sum(launched.values())
                                - sum(traced.values()))
        log(f"{tag}profiled window short: its trace holds {traced} "
            f"entries of the port's kernels against {launched} launches "
            f"counted (PERF.md §7)")
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and profiling.PREAMBLE_KERNEL not in e.name()]
    WINDOWS["n"] += 1
    WINDOWS["skew_us"].append((min(starts) - t_ns) / 1e3)
    return out, wall, kernels


def run_gcond(K, SB, ds, save_path: str) -> tuple:
    """GCond through create_reducer(...).reduce(): epoch 0 warms up,
    epoch 1's wall feeds the idle-share estimate (then the checkpoint
    evaluation), epoch 2 runs under torch.profiler for the device-time
    breakdown."""
    import torch

    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.reduce import create_reducer

    args = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                         init="random", epochs=3, save_path=save_path,
                         run_inter_eval=1, device="cuda"),
                    explicit={"epochs", "run_inter_eval"})
    args = args.replace(checkpoints=(1,))
    eng = create_reducer("gcond", ds, args)
    if (eng.n_syn, args.hidden, eng.pge.cfg.nhid) != (1354, 256, 256):
        fail(f"not the full width: n_syn {eng.n_syn}, hidden "
             f"{args.hidden}, PGE nhid {eng.pge.cfg.nhid}")
    steps = Counter(eng, "match_loss_total")
    inference = Counter(eng, "inference_adj")
    inner = Counter(eng, "inner_adj")
    timer = EpochTimer(eng, K, SB, profile_at=2)
    K.reset_launches()
    t0 = time.perf_counter()
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    denom = eng.nclass * args.outer_loop
    losses = [float(x) / denom for x in eng.epoch_loss_sums]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite epoch loss {losses}")
    outer = steps.n
    if outer != args.epochs * args.outer_loop or inner.n != outer:
        fail(f"outer steps {outer}, inner_adj calls {inner.n}")
    extra = inference.n - inner.n   # checkpoint + final inference_adj
    if launches["pge_bwd"] != outer:
        fail(f"pge_bwd launches {launches['pge_bwd']} != {outer}")
    # syn_adj_norm feeds the backward; inner_adj and inference_adj do not
    if (launches["pge_fwd_ws"], launches["pge_fwd_nows"]) != \
            (outer, outer + extra):
        fail(f"pge_fwd launches {launches['pge_fwd_ws']} keeping the "
             f"workspace, {launches['pge_fwd_nows']} without != {outer}, "
             f"{outer} + {extra}")
    launches["pge_fwd"] = launches["pge_fwd_ws"] + launches["pge_fwd_nows"]
    feat = red.feat
    if feat.shape != (1354, 128) or not torch.isfinite(feat).all() or \
            not torch.isfinite(red.adj).all():
        fail("condensed graph not finite or of the wrong shape")
    log(f"gcond ogbn-arxiv: n_syn {eng.n_syn}, {outer} outer steps "
        f"(epochs {[round(s, 3) for s in timer.seconds]} s, reduce() "
        f"{wall:.1f} s), "
        f"epoch losses {[round(x, 5) for x in losses]}, launches "
        f"{launches} (fwd = {outer} keeping the workspace + {outer} "
        f"inner_adj + {extra} inference_adj without)")
    kern = timer.kernels
    busy = sum(kern.values())
    pge = {name: sum(v for k, v in kern.items() if f"pge::{name}_kernel" in k)
           for name in ("pge_fwd", "pge_bwd")}
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
    # the profiler's own host overhead stretches the profiled epoch's wall
    # time, so the idle share is an estimate across two epochs of the same
    # work: device busy of the profiled epoch 2 over the wall time of the
    # unprofiled epoch 1
    log(f"gcond profile (epoch 2, {args.outer_loop} outer steps, "
        f"torch.profiler): wall {timer.seconds[2] * 1e3:.1f} ms under the "
        f"profiler, device busy {busy:.1f} ms (idle share estimated as "
        f"1 - busy(epoch 2) / wall(unprofiled epoch 1): "
        f"{1 - busy / (timer.seconds[1] * 1e3):.3f}); "
        f"pge_fwd {pge['pge_fwd']:.1f} ms, pge_bwd {pge['pge_bwd']:.1f} ms "
        f"({(pge['pge_fwd'] + pge['pge_bwd']) / busy:.3f} of busy); top: "
        + "; ".join(f"{k[:48]} {v:.1f} ms" for k, v in top))
    return red, launches


# ---------------------------------------------------------------------------
# Phase 6: the shared-memory row gather
# ---------------------------------------------------------------------------

# SpMM tolerance, max|Δ| ≤ rtol·max|ref| + atol: the kernel and the plain
# version sum the same float32 products in another order.
TOL_SPMM = (1e-5, 1e-6)
PROBE_SHAPE = (4096, 128, 32768)     # source rows, width, gathered rows
PROBE_TS = (64, 128, 256, 448)       # source tiles the SpMM considers


def gather_bound_ms(n_src: int, d: int, n_idx: int, idx_bytes: int) -> float:
    """Bytes over HBM bandwidth: the gathered rows written once, the
    indices read once, and the rows of x that the indices can name read
    once (at most all of x)."""
    nbytes = n_idx * d * 4 + n_idx * idx_bytes + min(n_idx, n_src) * d * 4
    return 1e3 * nbytes / PEAK_BYTES


def probe_gather(SG, stats: dict, ds) -> None:
    import numpy as np
    import torch

    from graphslim_tpu_torch.reduce.base import class_budgets

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_src, d, n_idx = PROBE_SHAPE
    x = torch.randn(n_src, d, generator=gen, device="cuda")
    idx = torch.randint(0, n_src, (n_idx,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx64 = idx.long()
    ref = SG.gather_rows_plain(x, idx64)
    lib_ms = queued_ms(lambda: torch.index_select(x, 0, idx64))
    bound = gather_bound_ms(n_src, d, n_idx, 4)
    gbytes = bound * 1e-3 * PEAK_BYTES / 1e9

    def rate(ms):
        return f"{ms:.4f} ms = {n_idx / ms / 1e3:.1f} Mrows/s = " \
               f"{gbytes / ms * 1e3:.0f} GB/s"

    parts = []
    for ts in PROBE_TS + (None,):
        kw = dict(staged=ts is not None, ts=ts)
        out = SG.gather_rows_cuda(x, idx, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"gather {kw} differs from index_select")
        ms = queued_ms(lambda: SG.gather_rows_cuda(x, idx, **kw))
        parts.append((f"staged ts={ts} " if ts else "direct ") + rate(ms))
    log(f"gather probe x [{n_src}, {d}] f32, idx [{n_idx}] (source warm in "
        f"L2; device time of launches queued back to back), exact; bound "
        f"{bound:.4f} ms; index_select {rate(lib_ms)}; "
        + "; ".join(parts))

    # The calls a coreset run makes (reduce/coreset.py): every class's pool
    # of training nodes out of the embeddings (KCenter: the full-graph
    # GCN's logits, [n, nclass]; the agg variants: Â²X, [n, n_feat]), then
    # the selected rows out of the features.  The pools are the twin's own;
    # the selection here is each pool's first rows at the reducers' budgets.
    labels = ds.labels.cpu().numpy()[ds.idx_train]
    budgets, _, _ = class_budgets(labels, 0.01)
    pools = [np.asarray(ds.idx_train)[labels == c] for c in budgets]
    picked = np.concatenate([p[:min(int(k), len(p))]
                             for p, k in zip(pools, budgets.values())])
    largest = max(pools, key=len)
    logits = torch.randn(ds.n_nodes, ds.nclass, generator=gen, device="cuda")
    calls = [(f"class pool of {ds.nclass}-wide logits", logits, p)
             for p in pools]
    calls += [(f"class pool of {ds.n_feat}-wide features", ds.feat, p)
              for p in pools]
    calls.append(("selected rows of the features", ds.feat, picked))
    for what, src, rows in calls:
        rows = torch.as_tensor(rows, device="cuda")
        out = SG.gather_rows(src, rows)
        torch.cuda.synchronize()
        if not torch.equal(out, SG.gather_rows_plain(src, rows)) or \
                not torch.equal(out, SG.gather_rows(src, rows)):
            fail(f"gather of a {what} ({rows.shape[0]} rows) differs from "
                 f"index_select")
    parts = []
    for what, src, rows in ((calls[0][0], logits, largest),
                            (calls[-2][0], ds.feat, largest),
                            calls[-1]):
        rows = torch.as_tensor(rows, device="cuda")
        ms = queued_ms(lambda: SG.gather_rows(src, rows))
        lib_ms = queued_ms(lambda: torch.index_select(src, 0, rows))
        host = median_ms(lambda: SG.gather_rows(src, rows))
        host_lib = median_ms(lambda: torch.index_select(src, 0, rows))
        bound = gather_bound_ms(src.shape[0], src.shape[1], rows.shape[0],
                                rows.element_size())
        parts.append(f"{what}, x {list(src.shape)}, idx [{rows.shape[0]}]: "
                     f"{ms:.4f} ms (index_select {lib_ms:.4f} ms, bound "
                     f"{bound:.5f} ms by bytes; with the host's share of "
                     f"one call {host:.4f} against {host_lib:.4f} ms)")
        if src is logits:      # KCenter's shape goes into the kernels line
            stats["smem_gather"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=lib_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms)
    # a width that is no multiple of 4 (4-byte pieces): the evaluator's
    # hoisted [X | 1] is 129 wide
    wide = torch.randn(ds.n_nodes, 129, generator=gen, device="cuda")
    rows = torch.as_tensor(largest, device="cuda")
    for r in (rows, rows.to(torch.int32)):
        out = SG.gather_rows(wide, r)
        torch.cuda.synchronize()
        if not torch.equal(out, SG.gather_rows_plain(wide, rows)) or \
                not torch.equal(out, SG.gather_rows(wide, r)):
            fail(f"gather at d = 129 ({r.dtype}) differs from index_select")
    ms = queued_ms(lambda: SG.gather_rows(wide, rows))
    lib_ms = queued_ms(lambda: torch.index_select(wide, 0, rows))
    bound = gather_bound_ms(wide.shape[0], 129, rows.shape[0], 8)
    parts.append(f"largest pool out of a 129-wide matrix (4-byte pieces), "
                 f"idx [{rows.shape[0]}] int64 and int32 exact: {ms:.4f} ms "
                 f"(index_select {lib_ms:.4f} ms, bound {bound:.5f} ms by "
                 f"bytes)")
    del wide
    log(f"gather at the coreset path's shapes ({len(calls)} calls: "
        f"{len(pools)} class pools of {min(map(len, pools))} to "
        f"{len(largest)} rows at each width, {picked.shape[0]} selected "
        f"rows), direct, all exact; device time of launches queued back "
        f"to back, largest pool and selection: "
        + "; ".join(parts))


# ---------------------------------------------------------------------------
# Phase 7: the blocked SpMM
# ---------------------------------------------------------------------------

def spmm_bound(nnz: int, n_rows: int, n_cols: int, d: int) -> tuple:
    """(ms, "bytes" or "operations"), the larger of two times: the bytes
    over HBM bandwidth (stored entries × (index + value), one read of x,
    one write of out) and the 2·nnz·d float32 operations over the fp32
    peak, which is the larger where rows hold about 80 entries or more."""
    by_bytes = 1e3 * (nnz * 8 + (n_rows + n_cols) * d * 4) / PEAK_BYTES
    by_ops = 1e3 * 2 * nnz * d / PEAK_FP32
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def check_spmm(SB, tag: str, adj, layout, x, bad: list,
               slab: int = 0) -> float:
    """Kernel against the plain version over the same layout and against
    a float64 product, and twice for bit-equality → max|kernel - plain|.
    With ``slab`` the references are computed on column slabs of that
    width (the float64 product gathers one row of x per stored entry)."""
    import torch

    from graphslim_tpu_torch.kernels.spmm import spmm_plain

    out = SB.spmm_blocked(layout, x)
    torch.cuda.synchronize()
    d = x.shape[1]
    slab = slab or d
    vals = adj.values_or_ones().double()
    err = 0.0
    for a in range(0, d, slab):
        xs = x[:, a:a + slab].contiguous()
        ref = SB.spmm_blocked_plain(layout, xs)
        f64 = spmm_plain(adj.row, adj.col, vals, xs.double(), adj.n_rows)
        part = f" cols {a}:{a + xs.shape[1]}" if slab < d else ""
        got = out[:, a:a + slab]
        err = max(err, check_close(f"spmm {tag}{part} vs plain", got, ref,
                                   TOL_SPMM, bad, f64))
        check_close(f"spmm {tag}{part} vs float64", got.double(), f64,
                    TOL_SPMM, bad)
        check_close(f"spmm plain {tag}{part} vs float64", ref.double(), f64,
                    TOL_SPMM, bad)
        del xs, ref, f64
    if not torch.equal(out, SB.spmm_blocked(layout, x)):
        bad.append(f"spmm {tag}: two runs differ")
    return err


def ragged_graph(G, n: int, e: int, seed: int):
    """Random weighted digraph with rows n//3..n//2 empty and one row that
    points at every column (heavier than any tile)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = (row < n // 3) | (row >= n // 2)
    row = np.concatenate([row[keep], np.full(n, n - 1)])
    col = np.concatenate([col[keep], np.arange(n)])
    w = rng.normal(size=row.shape[0]).astype(np.float32)
    return G.from_edge_index(np.stack([row, col]), n, edge_weight=w,
                             device="cuda")


def compare_spmm_small(SB, G) -> None:
    import numpy as np
    import torch

    bad: list = []
    # (a) the shape of the JAX package's own test of its kernel
    rng = np.random.default_rng(3)
    n, e, d = 500, 3000, 16
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    adj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                       device="cuda"))
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                        device="cuda")
    layout = adj.blocked(td=128, ts=128, chunk=256, stage_min=128)
    err = check_spmm(SB, "(a) n=500 d=16 td=ts=128", adj, layout, x, bad)
    log(f"spmm (a) n={n} d={d} {layout.describe()}: max|Δ| {err:.2e}")
    # (c) ragged: empty rows, a row heavier than a tile, staged and direct
    # blocks mixed, runs cut into pieces
    n, d = 3000, 40
    adj = ragged_graph(G, n, 40000, 11)
    x = torch.randn(n, d, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    for sizes in (dict(stage_min=64),
                  dict(td=32, ts=448, chunk=50, stage_min=8),
                  dict(td=128, ts=256, chunk=4096, stage_min=10 ** 9)):
        layout = adj.blocked(**sizes)
        err = check_spmm(SB, f"(c) ragged {sizes}", adj, layout, x, bad)
        out = SB.spmm_blocked(layout, x)
        if not (out[n // 3: n // 2] == 0).all():
            bad.append(f"spmm (c) {sizes}: empty rows are not zero")
        log(f"spmm (c) ragged n={n} d={d} nnz={adj.nnz} "
            f"{layout.describe()}: max|Δ| {err:.2e}")
    if bad:
        fail("blocked SpMM disagrees:\n  " + "\n  ".join(bad))


def compare_spmm_arxiv(SB, ds, stats: dict) -> None:
    """(b): the arxiv twin's normalized adjacency, forward and backward at
    the widths the coreset path uses."""
    import torch

    adj = ds.adj_norm()
    layout = adj.blocked()
    layout_t = adj.blocked(transpose=True)
    n, nnz = adj.n_rows, adj.nnz
    log(f"spmm (b) arxiv twin: {n} rows, {nnz} stored entries "
        f"({nnz / n:.2f} a row); layout {layout.describe()}; transposed "
        f"layout {'shared (symmetric)' if layout_t is layout else 'built'}")
    csr = adj.to_csr()
    bad: list = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    # features, hidden, classes, [X | 1] of the evaluator's hoist (not a
    # multiple of 4: floats, not float4s), and two widths between
    for d in (128, 256, 40, 129, 64, 192):
        x = torch.randn(n, d, generator=gen, device="cuda")
        g = torch.randn(n, d, generator=gen, device="cuda")
        err = check_spmm(SB, f"(b) arxiv d={d} fwd", adj, layout, x, bad)
        # backward through the autograd Function: A^T g on the transposed
        # layout, against the plain version and a float64 A^T g
        leaf = x.clone().requires_grad_(True)
        with torch.enable_grad():
            (gx,) = torch.autograd.grad(adj.matmul(leaf), leaf, g)
        g64 = adj.rmatmul(g.double(), n)
        ref_t = SB.spmm_blocked_plain(layout_t, g)
        err_b = check_close(f"spmm (b) arxiv d={d} bwd vs plain", gx, ref_t,
                            TOL_SPMM, bad, g64)
        check_close(f"spmm (b) arxiv d={d} bwd vs float64", gx.double(),
                    g64, TOL_SPMM, bad)
        ms = median_ms(lambda: SB.spmm_blocked(layout, x))
        ms_b = median_ms(lambda: SB.spmm_blocked(layout_t, g))
        plain = median_ms(lambda: SB.spmm_blocked_plain(layout, x), 5, 1)
        lib = median_ms(lambda: torch.sparse.mm(csr, x))
        bound, by = spmm_bound(nnz, n, n, d)
        moved = (nnz * (8 + d * 4) + layout.bounds.numel() * 4
                 + n * d * 4) / 1e9
        plan = SB.launch_plan(d, d % 4 == 0)
        log(f"spmm (b) arxiv d={d} ({plan['n_slabs']} walk(s) of the "
            f"entries, {plan['lpr']} lanes a row group x {plan['nv']} "
            f"items, {plan['busy']} of 32 lanes busy): fwd max|Δ| "
            f"{err:.2e}, bwd max|Δ| "
            f"{err_b:.2e}; kernel {ms:.4f} ms (transposed layout "
            f"{ms_b:.4f} ms; plain {plain:.3f} ms; torch.sparse.mm "
            f"{lib:.4f} ms; bound {bound:.4f} ms by {by}); the kernel "
            f"requests {moved:.3f} GB (every entry's row of x, through "
            f"L2), {moved / ms * 1e3:.0f} GB/s")
        stats[f"spmm_blocked_d{d}"] = dict(
            max_abs_err=max(err, err_b), ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib)
        del x, g, leaf, gx, g64, ref_t
        torch.cuda.empty_cache()
    if bad:
        fail("blocked SpMM disagrees on the arxiv twin:\n  "
             + "\n  ".join(bad))


def compare_spmm_subgraphs(SB, G, subgraphs: dict) -> None:
    """The other shape the coreset path gives the kernel: the normalized
    adjacency of the selected nodes' subgraph, on which a GCN evaluation
    trains (a hoisted first aggregation of [X | 1], then one forward and
    one backward launch an epoch at the class count).  Runs after phase 8,
    on the subgraphs it selected."""
    import torch

    bad: list = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for method, raw in subgraphs.items():
        adj = G.gcn_norm(raw)
        layout = adj.blocked()
        wide = adj.blocked(td=64)     # the tile a large matrix gets
        csr = adj.to_csr()
        n, nnz = adj.n_rows, adj.nnz
        heaviest = int(torch.diff(adj.indptr).max())
        parts = []
        for d in (128, 256, 40, 129):
            x = torch.randn(n, d, generator=gen, device="cuda")
            tag = f"{method} subgraph n={n} d={d}"
            err = check_spmm(SB, tag, adj, layout, x, bad)
            check_spmm(SB, tag + " td=64", adj, wide, x, bad)
            ms = queued_ms(lambda: SB.spmm_blocked(layout, x))
            ms64 = queued_ms(lambda: SB.spmm_blocked(wide, x))
            plain = queued_ms(lambda: SB.spmm_blocked_plain(layout, x))
            lib = queued_ms(lambda: torch.sparse.mm(csr, x))
            bound, by = spmm_bound(nnz, n, n, d)
            parts.append(
                f"d={d}: max|Δ| {err:.2e}, kernel {ms:.4f} ms (td=64 "
                f"{ms64:.4f} ms; plain {plain:.4f} ms; torch.sparse.mm "
                f"{lib:.4f} ms; bound {bound:.5f} ms by {by})")
        log(f"spmm on the {method} subgraph: {n} rows, {nnz} stored "
            f"entries, heaviest row {heaviest}; layout {layout.describe()} "
            f"({-(-n // layout.td)} destination tiles); device time of "
            f"launches queued back to back; "
            + "; ".join(parts))
    if bad:
        fail("blocked SpMM disagrees on a selected subgraph:\n  "
             + "\n  ".join(bad))


# ---------------------------------------------------------------------------
# Phase 8: the coreset path
# ---------------------------------------------------------------------------

def run_coresets(SB, SG, G) -> tuple:
    """kcenter / herding+agg / cent_p through train_all.run at full width;
    returns the kernels' launch counts over the three runs and the selected
    subgraphs that the GCN evaluations trained on."""
    import torch

    from graphslim_tpu_torch import models as M
    from graphslim_tpu_torch import train_all as TA
    from graphslim_tpu_torch import utils
    from graphslim_tpu_torch.config import Args, finalize

    seen: dict = {}
    create, evaluator = TA.create_reducer, TA.Evaluator

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            before = SB.LAUNCHES["spmm_blocked"]
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            seen[key] = (time.perf_counter() - t0,
                         SB.LAUNCHES["spmm_blocked"] - before)
            seen[key + " result"] = out
            return out
        return wrapper

    def create_timed(method, data, args, **kw):
        agent = create(method, data, args, **kw)
        agent.reduce = timed(agent.reduce, "reduce")
        seen["agent"], seen["data"] = agent, data
        return agent

    class TimedEvaluator(evaluator):
        def evaluate(self, *a, **kw):
            # the full graph's normalization and layout, where the reducer
            # did not need them, would otherwise count as evaluation
            t0 = time.perf_counter()
            self.data.adj_norm().blocked()
            torch.cuda.synchronize()
            seen["setup"] = time.perf_counter() - t0
            return timed(super().evaluate, "evaluate")(*a, **kw)

    TA.create_reducer, TA.Evaluator = create_timed, TimedEvaluator
    SB.reset_launches()
    SG.reset_launches()
    kcenter, subgraphs = None, {}
    with tempfile.TemporaryDirectory() as tmp:
        for method, agg, model in (("kcenter", False, "GCN"),
                                   ("herding", True, "SGC"),
                                   ("cent_p", False, "GCN")):
            args = finalize(Args(
                dataset="ogbn-arxiv", method=method, agg=agg,
                reduction_rate=0.01, hidden=256, eval_epochs=300,
                run_eval=3, eval_model=model, save_path=tmp,
                device="cuda"), explicit={"run_eval", "eval_epochs"})
            before = dict(SB.LAUNCHES, **SG.LAUNCHES)
            by_width = dict(SB.LAUNCHES_BY_WIDTH)
            mean, std = TA.run(args)
            widths = {d: c - by_width.get(d, 0)
                      for d, c in sorted(SB.LAUNCHES_BY_WIDTH.items())
                      if c > by_width.get(d, 0)}
            agent = seen["agent"]
            n_sel = int(agent.labels_syn.shape[0])
            if not (math.isfinite(mean) and math.isfinite(std)):
                fail(f"{method}: accuracy {mean} ± {std}")
            # per-class budgets max(int(n_c * r), 1) of the 90,941 train
            # nodes: 1336 without GCond's remainder absorption
            if (n_sel, args.hidden, args.eval_epochs) != (1336, 256, 300):
                fail(f"{method}: not the full width ({n_sel} nodes, hidden "
                     f"{args.hidden}, {args.eval_epochs} epochs)")
            la = SB.LAUNCHES["spmm_blocked"] - before["spmm_blocked"]
            lb = SG.LAUNCHES["smem_gather"] - before["smem_gather"]
            if la <= 0 or lb <= 0:
                fail(f"{method}: spmm_blocked launched {la} times, "
                     f"smem_gather {lb} times")
            log(f"coreset {method}{'+agg' if agg else ''} / {model} on "
                f"ogbn-arxiv r=0.01: {n_sel} nodes, reduce "
                f"{seen['reduce'][0]:.2f} s ({seen['reduce'][1]} SpMM "
                f"launches), full-graph normalization and layout left to "
                f"the evaluator {seen['setup']:.2f} s, evaluate 3 seeds x "
                f"300 epochs {seen['evaluate'][0]:.2f} s "
                f"({seen['evaluate'][1]} SpMM "
                f"launches), gather launches {lb}, accuracy {mean:.4f} ± "
                f"{std:.4f}; SpMM launches by width (d: count) {widths}")
            if method == "kcenter":
                kcenter = (agent, seen["data"], args, seen["reduce"][1])
            if model == "GCN":    # trained on the selected nodes' subgraph
                subgraphs[method] = seen["reduce result"].adj
    launches = dict(SB.LAUNCHES, **SG.LAUNCHES)
    TA.create_reducer, TA.Evaluator = create, evaluator

    # the full-graph GCN that KCenter trained
    agent, ds, args, reduce_launches = kcenter
    model, params, norm, best_val = agent.embed_model
    if reduce_launches != 6 * args.eval_epochs + 2:
        fail(f"kcenter reduce launched the SpMM {reduce_launches} times, "
             f"expected 6 an epoch (forward 2, backward 2, validation 2) "
             f"+ 2 for the embeddings")
    best_val = float(best_val)
    if not best_val >= 0.60:
        fail(f"KCenter's full-graph GCN validates at {best_val:.4f} < 0.60")

    class PlainAdj(G.SparseAdj):
        def matmul(self, x):
            return SB.spmm_blocked_plain(self.blocked(), x)

    plain_adj = PlainAdj(norm.indptr, norm.row, norm.col, norm.val,
                         norm._layouts)
    with torch.no_grad():
        logits = model.apply(params, ds.feat, norm)
        logits_plain = model.apply(params, ds.feat, plain_adj)
    gap = max_err(logits, logits_plain)
    top = float(logits_plain.abs().max())
    if not gap <= 1e-4 * top:
        fail(f"GCN logits through the kernel and through its plain version "
             f"differ by {gap:.3e} > 1e-4 x {top:.3e}")

    # one training epoch of that GCN under the profiler
    idx = torch.as_tensor(ds.idx_train, device="cuda")
    vidx = torch.as_tensor(ds.idx_val, device="cuda")
    batches = dict(train=(ds.feat, norm, ds.labels[idx], idx),
                   val=(ds.feat, norm, ds.labels[vidx], vidx))

    def fit(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.fit_with_val(model, utils.make_generator(0, "cuda"), **batches,
                       cfg=M.TrainConfig(epochs=epochs, lr=0.01))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fit(2)
    epoch_ms = (fit(12) - fit(2)) / 10
    _, _, kern = profiled(lambda: fit(1), host=True)
    busy = sum(kern.values())
    spmm_ms = sum(v for k, v in kern.items() if "spmm_blocked_kernel" in k)
    top4 = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
    log(f"kcenter full-graph GCN: best validation {best_val:.4f}; logits "
        f"kernel vs plain max|Δ| {gap:.2e} (max|logit| {top:.2f}); one "
        f"training epoch (6 SpMM launches) {epoch_ms:.2f} ms unprofiled "
        f"(difference of a 12- and a 2-epoch fit); profiled epoch: device "
        f"busy {busy:.2f} ms, blocked SpMM {spmm_ms:.2f} ms "
        f"({spmm_ms / busy:.3f} of busy), idle share estimated as 1 - "
        f"busy / unprofiled epoch: {1 - busy / epoch_ms:.3f}; top: "
        + "; ".join(f"{k[:48]} {v:.2f} ms" for k, v in top4))
    return launches, subgraphs


# ---------------------------------------------------------------------------
# Phase 9: DosCond, GCondX, GCDM and SGDD on the arxiv twin
# ---------------------------------------------------------------------------

# Phase 9's DosCond, GCondX and GCDM runs: epoch 0 warms up, the TIMED
# epochs after it give the mean wall of the idle-share estimate, the last
# is profiled.
TIMED = 5
EPOCHS = TIMED + 2


# the evaluation seeds of phases 9-11: 3 cut to 1 (the first seed's
# training, repeated twice more with other draws) to keep the whole smoke
# inside its time limit (PERF.md §6)
ARXIV_EVAL_SEEDS = 1


def condense_args(method: str, save_path: str, epochs: int,
                  checkpoints: tuple, **kw):
    """The method's ogbn-arxiv paper config (``method_configs.py``), cut
    in depth only: ``epochs`` epochs, one quick training at each
    checkpoint; evaluation ``ARXIV_EVAL_SEEDS`` seed × 300 epochs."""
    from graphslim_tpu_torch.config import Args, finalize

    args = finalize(Args(dataset="ogbn-arxiv", method=method,
                         init="random", epochs=epochs, save_path=save_path,
                         run_inter_eval=1, run_eval=ARXIV_EVAL_SEEDS,
                         eval_epochs=300,
                         device="cuda", **kw),
                    explicit={"epochs", "run_inter_eval", "run_eval",
                              "eval_epochs", *kw})
    return args.replace(checkpoints=checkpoints)


def evaluate_result(ds, args, red, eng) -> tuple:
    """The default evaluator on a condensed graph; fails on a non-finite
    epoch loss or accuracy."""
    import torch

    from graphslim_tpu_torch.eval import Evaluator

    losses = [float(x) for x in eng.epoch_loss_sums]
    if not all(math.isfinite(x) for x in losses) or \
            not torch.isfinite(red.feat).all():
        fail(f"{args.method}: non-finite epoch loss {losses} or features")
    t0 = time.perf_counter()
    (acc, std), _ = Evaluator(ds, args).evaluate(red, args.eval_model)
    if not (math.isfinite(acc) and math.isfinite(std)):
        fail(f"{args.method}: accuracy {acc} ± {std}")
    return acc, std, time.perf_counter() - t0, losses


def run_condensers(K, SB, ds, tmp: str) -> dict:
    """DosCond (with a resume), GCondX, GCDM and SGDD at full width on the
    arxiv twin through create_reducer(...).reduce(), each result through
    the default evaluator; returns each kernel's launches over the
    phase."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphslim_tpu_torch.reduce import create_reducer

    K.reset_launches()
    SB.reset_launches()

    def pge_since(before: dict) -> dict:
        return {k: v - before[k] for k, v in K.LAUNCHES.items()}

    # --- DosCond: 7 epochs, a checkpoint at epoch 1, then a resume -----
    # (epoch 0 warms up, epochs 1-5 the mean wall, epoch 6 is profiled)
    args = condense_args("doscond", tmp, EPOCHS, (1,))
    eng = create_reducer("doscond", ds, args)
    if (eng.n_syn, args.hidden, eng.pge.cfg.nhid, eng.args.inner_loop) != \
            (1354, 256, 256, 0):
        fail(f"doscond: not the paper config at full width (n_syn "
             f"{eng.n_syn}, hidden {args.hidden}, PGE nhid "
             f"{eng.pge.cfg.nhid}, inner_loop {eng.args.inner_loop})")
    inference = Counter(eng, "inference_adj")
    timer = EpochTimer(eng, K, SB, profile_at=EPOCHS - 1)
    before = dict(K.LAUNCHES)
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    launches = pge_since(before)
    steps = args.epochs * args.outer_loop
    if (launches["pge_fwd_ws"], launches["pge_bwd"],
            launches["pge_fwd_nows"]) != (steps, steps, inference.n):
        fail(f"doscond: PGE launches {launches}; expected {steps} forward "
             f"keeping the workspace, {steps} backward, {inference.n} "
             f"without (checkpoints and the final adjacency)")
    if any(e["pge_fwd_nows"] for e in timer.pge):
        fail(f"doscond: a no-grad PGE forward inside an epoch {timer.pge}")
    kern = timer.kernels
    busy = sum(kern.values())
    fwd = sum(v for k, v in kern.items() if "pge::pge_fwd_kernel" in k)
    bwd = sum(v for k, v in kern.items() if "pge::pge_bwd_kernel" in k)
    acc, std, t_eval, losses = evaluate_result(ds, args, red, eng)
    wall = timer.mean_wall_ms()
    log(f"doscond ogbn-arxiv (SGC, ours, lr_adj 0.02, lr_feat 0.01, outer "
        f"5, inner 0): n_syn {eng.n_syn}, {steps} outer steps (epochs "
        f"{[round(x, 3) for x in timer.seconds]} s), PGE "
        f"launches {launches} ({inference.n} inference_adj), epoch losses "
        f"{[round(x, 5) for x in losses]}; profiled epoch {EPOCHS - 1}: "
        f"device busy {busy:.2f} ms (idle share estimated as 1 - busy / "
        f"mean wall of the timed epochs: {1 - busy / wall:.3f}), pge_fwd "
        f"{fwd:.2f} ms, pge_bwd {bwd:.2f} ms, the rest "
        f"{busy - fwd - bwd:.2f} ms; evaluate GCN {args.run_eval} seed(s) "
        f"x 300 epochs {acc:.4f} ± {std:.4f} ({t_eval:.1f} s)")

    # the resume, from the state saved at the checkpoint (epoch 1 done)
    with np.load(eng.state_path()) as blob:
        saved = {k: blob[k] for k in blob.files}
    resumed = create_reducer("doscond", ds, args.replace(resume=True))
    rtimer = EpochTimer(resumed, K, SB)
    resumed.reduce(ds)
    torch.cuda.synchronize()
    if int(saved["__epoch__"]) != 2 or \
            len(rtimer.seconds) != args.epochs - 2:
        fail(f"doscond resume: saved epoch {int(saved['__epoch__'])}, "
             f"{len(rtimer.seconds)} epochs run (expected epochs 2-"
             f"{args.epochs - 1})")
    state = rtimer.first_state
    host = [x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in state]
    mismatch = [i for i, x in enumerate(host)
                if not np.array_equal(x, saved[f"leaf_{i}"])]
    if mismatch or len(state) != int(saved["__n_leaves__"]):
        fail(f"doscond resume: leaves {mismatch} of the resumed state "
             f"differ from the saved ones")
    log(f"doscond resume: started at epoch 2 ({len(rtimer.seconds)} "
        f"epochs run, {sum(rtimer.seconds):.3f} s); the {len(state)} "
        f"leaves of its first "
        f"state (features, PGE parameters, both Adam states, the "
        f"generator's state) equal the saved ones bit for bit")
    del eng, resumed, red

    # --- GCondX: 7 epochs ----------------------------------------------
    args = condense_args("gcondx", tmp, EPOCHS, (1,))
    eng = create_reducer("gcondx", ds, args)
    timer = EpochTimer(eng, K, SB)
    before = dict(K.LAUNCHES)
    red = eng.reduce(ds)
    if any(pge_since(before).values()) or eng.pge is not None:
        fail(f"gcondx launched the PGE: {pge_since(before)}")
    if len(timer.seconds) != EPOCHS:
        fail(f"gcondx: {len(timer.seconds)} epochs run, {EPOCHS} expected")
    acc, std, t_eval, losses = evaluate_result(ds, args, red, eng)
    log(f"gcondx ogbn-arxiv (SGC ntrans 2, mse, lr_feat 0.1, outer 5, "
        f"inner {args.inner_loop}): {args.epochs * args.outer_loop} outer "
        f"steps (epochs {[round(x, 3) for x in timer.seconds]} s), PGE "
        f"launches 0, "
        f"epoch losses {[round(x, 5) for x in losses]}; evaluate GCN "
        f"{acc:.4f} ± {std:.4f} ({t_eval:.1f} s)")
    del eng, red

    # --- GCDM: 7 epochs -------------------------------------------------
    args = condense_args("gcdm", tmp, EPOCHS, (1,), hidden=256)
    eng = create_reducer("gcdm", ds, args)
    eng.adj_norm_full.blocked()
    timer = EpochTimer(eng, K, SB, profile_at=EPOCHS - 1)
    before = SB.LAUNCHES["spmm_blocked"]
    red = eng.reduce(ds)
    in_reduce = SB.LAUNCHES["spmm_blocked"] - before
    want = {args.hidden: args.outer_loop}
    if any(e != want for e in timer.spmm) or \
            (args.condense_model, args.nlayers) != ("GCN", 2):
        fail(f"gcdm: SpMM launches by width per epoch {timer.spmm}, "
             f"expected {want} (one at d = {args.hidden} an outer step)")
    kern = timer.kernels
    busy = sum(kern.values())
    spmm_ms = sum(v for k, v in kern.items() if "spmm_blocked_kernel" in k)
    acc, std, t_eval, losses = evaluate_result(ds, args, red, eng)
    wall = timer.mean_wall_ms()
    log(f"gcdm ogbn-arxiv (GCN, l1, lr_feat 0.01, outer 5, inner 1, hidden "
        f"256): {args.epochs * args.outer_loop} outer steps (epochs "
        f"{[round(x, 3) for x in timer.seconds]} s), SpMM "
        f"launches by width an epoch {timer.spmm[0]} ({in_reduce} in "
        f"reduce() with the checkpoint's evaluation), epoch losses "
        f"{[round(x, 3) for x in losses]}; profiled epoch {EPOCHS - 1}: "
        f"device busy {busy:.2f} ms (idle share estimated as 1 - busy / "
        f"mean wall of the timed epochs: {1 - busy / wall:.3f}), blocked "
        f"SpMM {spmm_ms:.2f} ms ({spmm_ms / busy:.3f} of busy); evaluate "
        f"GCN {acc:.4f} ± {std:.4f} ({t_eval:.1f} s)")
    del eng, red
    torch.cuda.empty_cache()

    # --- SGDD: 1 epoch of 20 outer steps, step 11 profiled --------------
    torch.cuda.reset_peak_memory_stats()
    args = condense_args("sgdd", tmp, 1, ())
    eng = create_reducer("sgdd", ds, args)
    if (eng.n_syn, eng.pge.cfg.mx_size, args.opt_scale, args.inner_loop,
            args.outer_loop) != (1354, 1000, 1e-12, 3, 20):
        fail(f"sgdd: not the paper config (n_syn {eng.n_syn}, mx_size "
             f"{eng.pge.cfg.mx_size}, opt_scale {args.opt_scale})")
    timer = EpochTimer(eng, K, SB)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    gen_fwd, marks = eng.generator_forward, []

    def generator_forward(*a, **kw):     # called once at each step's start
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if len(marks) in (11, 12):
            (prof.start if len(marks) == 11 else prof.stop)()
        return gen_fwd(*a, **kw)

    eng.generator_forward = generator_forward
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(marks) != args.outer_loop:
        fail(f"sgdd: {len(marks)} outer steps, expected {args.outer_loop}")
    linalg = {}
    for e in prof.key_averages():
        key = e.key.lower()
        if any(w in key for w in ("svd", "eig", "sympinv")) and \
                (key.startswith(("aten::", "autograd::"))
                 or "sympinv" in key):
            dev = getattr(e, "device_time_total", None)
            dev = e.cuda_time_total if dev is None else dev
            linalg[e.key] = (e.cpu_time_total / 1e3, dev / 1e3, e.count)
    acc, std, t_eval, losses = evaluate_result(ds, args, red, eng)
    log(f"sgdd ogbn-arxiv (SGC ntrans 2, ours, outer 20, inner 3, mx_size "
        f"1000, opt_scale 1e-12; IGNR n {eng.n_syn}): the epoch, with "
        f"step 1's warm-up and the profiled step, {timer.seconds[0]:.2f} "
        f"s, peak device memory {peak:.2f} GiB, "
        f"epoch loss {losses}; step 11 under the profiler "
        f"{1e3 * (marks[11] - marks[10]):.1f} ms, its decomposition ops "
        f"(host ms / device ms / calls): "
        + "; ".join(f"{k} {c:.1f} / {d:.1f} / {n}"
                    for k, (c, d, n) in sorted(linalg.items()))
        + f"; evaluate GCN {acc:.4f} ± {std:.4f} ({t_eval:.1f} s)")
    return {"pge_fwd": K.LAUNCHES["pge_fwd_ws"] + K.LAUNCHES["pge_fwd_nows"],
            "pge_bwd": K.LAUNCHES["pge_bwd"],
            "spmm_blocked": SB.LAUNCHES["spmm_blocked"]}


# ---------------------------------------------------------------------------
# Phase 10: k-means, the clustering coarseners, VNG, MSGC, Mirage and GECC
# ---------------------------------------------------------------------------

def cluster_args(method: str, save_path: str, **kw):
    """The method's ogbn-arxiv config (``method_configs.py``, where it has
    one) at r = 0.01; evaluation ``ARXIV_EVAL_SEEDS`` seed × 300 epochs
    with GCN."""
    from graphslim_tpu_torch.config import Args, finalize

    return finalize(Args(dataset="ogbn-arxiv", method=method,
                         reduction_rate=0.01, save_path=save_path,
                         run_eval=ARXIV_EVAL_SEEDS, eval_epochs=300,
                         device="cuda", **kw),
                    explicit={"reduction_rate", "run_eval", "eval_epochs",
                              *kw})


# MSGC's edge scorer at the MSGC arxiv cell's shapes: n_syn 909 with the
# twin's class shares, 16 skeletons, d = 128 (2d = 256), hidden 256.
ES_N, ES_BATCH = 909, 16
# Tolerances against the plain version, float32 on both sides, max|Δ| ≤
# rtol·max|ref| + atol (``tests/test_torch_msgc_scorer_cuda.py`` says why):
# the forward sums 2d and H terms in another order than cuBLAS, with the
# statistics from float64 partial sums on both sides: a few ulp of z, 1e-5
# after the sigmoid.  The backward, on the same saved tensors and z1, sums
# about 1e6 entries' float32 terms in another order: 1e-4 relative, plus
# 1e-6 of the largest gradient entry (the biases in front of a BatchNorm,
# 0 analytically).  A wrong index, mask or statistic moves an entry by
# orders of magnitude more.
ES_TOL_SCORE, ES_TOL_Z = (0.0, 1e-5), (1e-5, 0.0)
ES_GRAD_RTOL, ES_GRAD_FLOOR = 1e-4, 1e-6
ES_GRADS = ["feat", "W1", "b1", "W2", "b2", "w3", "b3", "bn1.scale",
            "bn1.bias", "bn2.scale", "bn2.bias"]


def edge_scorer_bounds(E: int, n: int, d: int, H: int) -> dict:
    """Least ms at the float32 peak (operations bind at these shapes).
    ``fwd``: the benchmark's count (``gsbench/arith_msgc.py``: the first
    layer a product over the gathered rows, 2·E·(2d·H + H² + H));
    ``fwd_folded``: the function's own least, the first layer folded
    through linearity (X·W1[:d] and X·W1[d:] once a node, then a gather
    and add an entry); ``bwd``: dW2 and dz2·W2ᵀ over the entries, the
    segment sums' adds and the first layer's four [n, d]×[n, H] products,
    without recomputing z1."""
    ms = 1e3 / PEAK_FP32
    return dict(fwd=ms * 2 * E * (2 * d * H + H * H + H),
                fwd_folded=ms * (4 * n * d * H + E * H + 2 * E * (H * H + H)),
                bwd=ms * (4 * E * H * H + 2 * E * H + 8 * n * d * H))


def compare_edge_scorer(ds, stats: dict) -> None:
    """MSGC's edge scorer kernels (``kernels/edge_scorer.py``) against
    their plain version on the card at the MSGC arxiv cell's shapes (the
    skeletons ``build_skeletons`` gives 909 synthetic nodes with the
    twin's class shares): the forward's scores, z1, z2 and statistics;
    the backward kernels against the plain backward on the same saved
    tensors and z1, gradient by gradient; a second forward and backward
    equal bit for bit; each timed beside its plain version and bounds."""
    import torch

    from graphslim_tpu_torch.kernels import edge_scorer as ES
    from graphslim_tpu_torch.reduce import msgc as MS

    if torch.backends.cuda.matmul.allow_tf32:
        fail("edge scorer: TF32 is on; the port keeps float32 products")
    y = MS.proportional_labels(ds.labels_for_reduction(), ES_N, ds.nclass)
    rows, cols, batches = MS.build_skeletons(y, ds.nclass, ES_BATCH, 0)
    scorer = MS.EdgeScorer(ds.n_feat, ES_N, ES_BATCH, rows, cols, batches,
                           torch.device("cuda"))
    ent = scorer.entries
    E, d, H = ent.E, ds.n_feat, MS.SCORER_HIDDEN
    g = torch.Generator(device="cuda").manual_seed(5)
    (l1, l2, l3), (n1, n2) = (lambda p: (p["layers"], p["bns"]))(
        scorer.init(g))

    def r(t, scale, shift=0.0):     # biases and affines off their init
        return shift + scale * torch.randn(t.shape, generator=g,
                                           device="cuda")

    flat = [torch.randn(ES_N, d, generator=g, device="cuda"), l1["w"],
            r(l1["b"], 0.1), l2["w"], r(l2["b"], 0.1), l3["w"],
            r(l3["b"], 0.1), r(n1["scale"], 0.2, 1.0), r(n1["bias"], 0.2),
            r(n2["scale"], 0.2, 1.0), r(n2["bias"], 0.2)]
    flat = [t.detach().contiguous() for t in flat]
    w = torch.zeros(E, device="cuda")          # the scattered entries' weights
    w[scorer.last] = torch.randn(scorer.last.shape[0], generator=g,
                                 device="cuda")
    bad: list = []
    s, z1, z2, st = ES.forward(ent, *flat)
    sp, z1p, z2p, stp = ES.forward_plain(ent, *flat)
    e_s = check_close("edge scorer scores", s, sp, ES_TOL_SCORE, bad)
    e_z = max(check_close(f"edge scorer {name}", a, b, ES_TOL_Z, bad)
              / max(float(b.abs().max()), 1e-30)
              for name, a, b in (("z1", z1, z1p), ("z2", z2, z2p),
                                 ("statistics", st, stp)))
    del sp, z1p, z2p, stp
    # the plain backward on the kernels' saved tensors and z1; the kernels'
    # backward writes over its z2, so it gets a copy
    first = ES.first_layer
    ES.first_layer = lambda *_: z1
    try:
        gp = ES.backward_plain(ent, ES._saved(flat, z2, st, s), w)
    finally:
        ES.first_layer = first
    gk = ES.backward(ent, ES._saved(flat, z2.clone(), st, s), w)
    scale = max(float(t.abs().max()) for t in gp)
    errs, rel = {}, {}
    for name, a, b in zip(ES_GRADS, gk, gp):
        errs[name] = check_close(f"edge scorer d{name}", a, b,
                                 (ES_GRAD_RTOL, ES_GRAD_FLOOR * scale), bad)
        rel[name] = errs[name] / (ES_GRAD_RTOL * float(b.abs().max())
                                  + ES_GRAD_FLOOR * scale)
    del gp
    s2, _, z2b, st2 = ES.forward(ent, *flat)
    gk2 = ES.backward(ent, ES._saved(flat, z2b, st2, s2), w)
    if not (torch.equal(s2, s) and all(torch.equal(a, b)
                                       for a, b in zip(gk2, gk))):
        bad.append("edge scorer: two runs differ")
    del z1, z2, z2b, gk, gk2
    torch.cuda.empty_cache()
    if bad:
        fail("edge scorer kernels disagree with their plain version:\n  "
             + "\n  ".join(bad))

    def kernels_both():
        sk, _, zk, stk = ES.forward(ent, *flat)
        ES.backward(ent, ES._saved(flat, zk, stk, sk), w)

    def plain_both():
        sk, _, zk, stk = ES.forward_plain(ent, *flat)
        ES.backward_plain(ent, ES._saved(flat, zk, stk, sk), w)

    fwd_ms = median_ms(lambda: ES.forward(ent, *flat), reps=10)
    both_ms = median_ms(kernels_both, reps=10)
    plain_fwd = median_ms(lambda: ES.forward_plain(ent, *flat), reps=5)
    plain_both_ms = median_ms(plain_both, reps=5)
    torch.cuda.empty_cache()
    b = edge_scorer_bounds(E, ES_N, d, H)
    worst = max(rel, key=rel.get)
    log(f"edge scorer n={ES_N} 2d={2 * d} H={H} E={E} ({ES_BATCH} "
        f"skeletons): scores max|Δ| {e_s:.2e}, z and statistics "
        f"{e_z:.2e} of max|ref|; backward gaps / tolerance "
        + ", ".join(f"{k} {v:.3f}" for k, v in rel.items())
        + f" (largest {worst}); two runs bit-equal; forward {fwd_ms:.3f} ms "
        f"(plain {plain_fwd:.3f}; bound {b['fwd']:.3f} by operations as "
        f"the benchmark counts them, {100 * b['fwd'] / fwd_ms:.1f} %; "
        f"{b['fwd_folded']:.3f} with the first layer folded, "
        f"{100 * b['fwd_folded'] / fwd_ms:.1f} %), forward and backward "
        f"{both_ms:.3f} ms (plain {plain_both_ms:.3f}; backward bound "
        f"{b['bwd']:.3f} by operations)")
    stats["edge_scorer_fwd"] = dict(
        max_abs_err=e_s, ms=fwd_ms, plain_ms=plain_fwd, bound_ms=b["fwd"],
        bound_by="operations (the benchmark's count)",
        bound_ms_folded=b["fwd_folded"])
    stats["edge_scorer_bwd"] = dict(
        max_abs_err=max(errs.values()), share_of_tolerance=rel[worst],
        ms=both_ms - fwd_ms,
        plain_ms=plain_both_ms - plain_fwd, bound_ms=b["bwd"],
        bound_by="operations")


def run_clusterers(SB, ds, tmp: str, stats: dict) -> dict:
    """clustering, clustering --agg, averaging, vng, msgc, mirage and gecc
    at full width on the arxiv twin through create_reducer(...).reduce()
    and the default evaluator, MSGC's edge scorer checked first
    (:func:`compare_edge_scorer`); returns each kernel's launches over the
    phase, the scorer's over the MSGC run."""
    import numpy as np
    import torch

    from graphslim_tpu_torch import profiling as P
    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.kernels import edge_scorer as ES
    from graphslim_tpu_torch.reduce import create_reducer
    from graphslim_tpu_torch.reduce import msgc as MS
    from graphslim_tpu_torch.reduce import vng as VN

    ds.adj_norm().blocked()
    SB.reset_launches()
    labels_test = ds.labels.cpu().numpy()[ds.idx_test]
    majority = float(np.bincount(labels_test).max() / labels_test.shape[0])
    log(f"phase 10: the test split's largest class holds {majority:.4f} "
        f"of its {labels_test.shape[0]} nodes")

    def widths_since(before: dict) -> dict:
        return {d: c - before.get(d, 0)
                for d, c in sorted(SB.LAUNCHES_BY_WIDTH.items())
                if c > before.get(d, 0)}

    def run(method, args, setup=None, gate=True):
        torch.cuda.synchronize()
        eng = create_reducer(method, ds, args)
        if setup is not None:
            setup(eng)
        before = dict(SB.LAUNCHES_BY_WIDTH)
        t0 = time.perf_counter()
        red = eng.reduce(ds)
        torch.cuda.synchronize()
        t_red = time.perf_counter() - t0
        w_red = widths_since(before)
        adj = red.adj if isinstance(red.adj, torch.Tensor) else None
        if not torch.isfinite(red.feat).all() or \
                (adj is not None and not torch.isfinite(adj).all()):
            fail(f"{method}: non-finite reduced graph")
        if red.labels.shape[0] != red.feat.shape[0] * (
                1 if adj is None or adj.ndim == 2 else adj.shape[0]):
            fail(f"{method}: {red.labels.shape[0]} labels for "
                 f"{red.feat.shape[0]} rows")
        before = dict(SB.LAUNCHES_BY_WIDTH)
        t0 = time.perf_counter()
        (acc, std), _ = Evaluator(ds, args).evaluate(red, args.eval_model)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        if not (math.isfinite(acc) and math.isfinite(std)):
            fail(f"{method}: accuracy {acc} ± {std}")
        if gate and not acc > majority:
            fail(f"{method}: accuracy {acc:.4f} is not above the largest "
                 f"class share {majority:.4f}")
        summary = (f"n_syn {red.feat.shape[0]}, reduce {t_red:.2f} s (SpMM "
                   f"launches by width {w_red}), evaluate GCN "
                   f"{args.run_eval} seed(s) x 300 epochs {t_eval:.2f} s "
                   f"(SpMM launches by width "
                   f"{widths_since(before)}), accuracy {acc:.4f} ± "
                   f"{std:.4f}")
        return eng, red, w_red, summary

    # --- clustering, clustering --agg, averaging ------------------------
    for method, agg in (("clustering", False), ("clustering", True),
                        ("averaging", False)):
        args = cluster_args(method, tmp, agg=agg)
        eng, red, w_red, summary = run(method, args)
        if agg and w_red.get(ds.n_feat, 0) < 2:
            fail(f"clustering --agg: SpMM launches by width {w_red}, "
                 f"expected 2 at d = {ds.n_feat} for its A^2 X")
        log(f"{method}{' --agg' if agg else ''} ogbn-arxiv r=0.01 "
            f"({type(eng).__name__}): {summary}")
        del eng, red

    # --- vng: GCN at hidden 256 -----------------------------------------
    kmeans, seen = VN.kmeans, {}

    def timed_kmeans(x, k, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = kmeans(x, k, **kw)
        torch.cuda.synchronize()
        seen.update(shape=tuple(x.shape), k=k,
                    seconds=time.perf_counter() - t0)
        return out

    VN.kmeans = timed_kmeans
    try:
        args = cluster_args("vng", tmp, condense_model="GCN", hidden=256)
        eng, red, _, summary = run("vng", args, gate=False)
    finally:
        VN.kmeans = kmeans
    log(f"vng ogbn-arxiv r=0.01 (GCN, hidden 256, {args.eval_epochs} "
        f"epochs): degree-weighted k-means k {seen['k']} over "
        f"{list(seen['shape'])} embeddings {seen['seconds']:.2f} s; "
        f"{summary} (reported, not gated)")
    del eng, red
    torch.cuda.empty_cache()

    # --- msgc: the ogbn-arxiv paper config, 2 of 500 epochs -------------
    build, built = MS.build_skeletons, {}

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        built.update(seconds=time.perf_counter() - t0, entries=len(out[0]))
        return out

    class K0:                   # the PGE counters EpochTimer reads
        LAUNCHES: dict = {}

    compare_edge_scorer(ds, stats)
    timers = {}
    torch.cuda.reset_peak_memory_stats()
    ES.reset_launches()
    counted = dict(P.counters())
    MS.build_skeletons = timed_build
    try:
        args = cluster_args("msgc", tmp, epochs=3).replace(checkpoints=(1,))
        if (args.init, args.batch_adj, args.outer_loop, args.inner_loop,
                args.condense_model, args.ntrans, args.threshold) != \
                ("clustering", 16, 20, 3, "SGC", 2, 0.01):
            fail(f"msgc: not the ogbn-arxiv paper config ({args})")
        eng, red, _, summary = run(
            "msgc", args, gate=False,
            setup=lambda e: timers.update(t=EpochTimer(e, K0, SB,
                                                       profile_at=2)))
    finally:
        MS.build_skeletons = build
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    scorer = dict(ES.LAUNCHES)
    scored = P.counters().get("generator.scored_entries", 0) - \
        counted.get("generator.scored_entries", 0)
    timer = timers["t"]
    if len(timer.seconds) != 3 or tuple(red.adj.shape) != \
            (16, eng.n_syn, eng.n_syn):
        fail(f"msgc: {len(timer.seconds)} epochs, adjacency "
             f"{tuple(red.adj.shape)}")
    # one backward chain an outer step; a forward chain for the step's
    # generator, one for the inner loop's, one a checkpoint
    steps = len(timer.seconds) * args.outer_loop
    if scorer["edge_scorer_bwd"] != steps or \
            scorer["edge_scorer_fwd"] < 2 * steps + 1:
        fail(f"msgc: edge scorer launches {scorer} over {steps} outer "
             f"steps")
    # every generator call scored the skeletons' entries through a
    # forward chain of the kernels
    if not 0 < scored == scorer["edge_scorer_fwd"] * eng.rows.shape[0]:
        fail(f"msgc: {scored} entries scored, {scorer['edge_scorer_fwd']} "
             f"forward chains over {eng.rows.shape[0]} entries")
    kern = timer.kernels
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    losses = [float(x) for x in eng.epoch_loss_sums]
    log(f"msgc ogbn-arxiv (SGC ntrans 2, ours, init clustering, batch_adj "
        f"16, outer 20, inner 3, threshold 0.01; 3 of 500 epochs, a "
        f"checkpoint at epoch 1, epoch 2 profiled): skeletons "
        f"{built['entries']} entries built on the host in "
        f"{built['seconds']:.2f} s (epochs "
        f"{[round(x, 3) for x in timer.seconds]} s), peak device memory "
        f"{peak:.2f} GiB, epoch losses {[round(x, 4) for x in losses]}, "
        f"edge scorer launches {scorer['edge_scorer_fwd']} forward / "
        f"{scorer['edge_scorer_bwd']} backward chains, "
        f"{scored} entries scored by them; "
        f"profiled epoch: device busy {busy:.1f} ms (idle share estimated "
        f"as 1 - busy / epoch 1's wall: "
        f"{1 - busy / (1e3 * timer.seconds[1]):.3f}), top: "
        + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top)
        + f"; {summary} (reported, not gated)")
    del eng, red, timers
    torch.cuda.empty_cache()

    # --- mirage: defaults -----------------------------------------------
    quant = {}

    def time_quantization(eng):
        node_labels = eng.node_labels

        def timed(feat, k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = node_labels(feat, k)
            quant.update(seconds=time.perf_counter() - t0, k=k)
            return out

        eng.node_labels = timed

    args = cluster_args("mirage", tmp)
    eng, red, _, summary = run("mirage", args, setup=time_quantization,
                               gate=False)
    log(f"mirage ogbn-arxiv r=0.01 (hops 2, fanout 5, support 0.1, 32 "
        f"labels): k-means of {quant['k']} labels over {ds.n_nodes} nodes "
        f"{quant['seconds']:.2f} s, the rest of reduce (hashing, mining, "
        f"trees) on the host; {red.adj.nnz} tree-edge entries; {summary} "
        f"(reported, not gated)")
    del eng, red

    # --- gecc: the ogbn-arxiv config ------------------------------------
    args = cluster_args("gecc", tmp)
    if (args.depth, args.agg_gamma, args.agg_alpha, args.agg_beta,
            args.fuzziness) != (2, 0.6, 0.5, 0.0, 1.0):
        fail(f"gecc: not the ogbn-arxiv config ({args})")
    eng, red, w_red, summary = run("gecc", args)
    if w_red.get(ds.n_feat, 0) < 2:
        fail(f"gecc: SpMM launches by width {w_red}, expected 2 at d = "
             f"{ds.n_feat} (one a hop)")
    log(f"gecc ogbn-arxiv r=0.01 (depth 2, gamma/alpha/beta 0.6/0.5/0.0, "
        f"k-means): {summary}")
    return {"spmm_blocked": SB.LAUNCHES["spmm_blocked"], **scorer}


# ---------------------------------------------------------------------------
# Phase 11: GCSNTK, SimGC, SFGC, GEOM and GDEM
# ---------------------------------------------------------------------------

WIDE = 1100     # GDEM's eigensolve block: k + q = 1000 + 100 columns


def compare_spmm_wide(SB, ds, stats: dict) -> None:
    """The blocked SpMM on the twin's Â at d = 1100 (GDEM's eigensolve),
    forward: against its plain version and a float64 product on column
    slabs of 275 (a whole-width float64 gather would take 40 GB), timed
    beside its plain version, torch.sparse.mm and its bound."""
    import torch

    adj = ds.adj_norm()
    layout = adj.blocked()
    n, nnz = adj.n_rows, adj.nnz
    x = torch.randn(n, WIDE, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    bad: list = []
    err = check_spmm(SB, f"d={WIDE}", adj, layout, x, bad, slab=275)
    torch.cuda.empty_cache()
    ms = median_ms(lambda: SB.spmm_blocked(layout, x))
    plain = median_ms(lambda: SB.spmm_blocked_plain(layout, x), 3, 1)
    torch.cuda.empty_cache()
    lib = median_ms(lambda: torch.sparse.mm(adj.to_csr(), x))
    bound, by = spmm_bound(nnz, n, n, WIDE)
    plan = SB.launch_plan(WIDE, True)
    log(f"spmm arxiv twin d={WIDE} ({plan['n_slabs']} walks of the entries "
        f"of {plan['slab']} columns): max|Δ| {err:.2e} against the plain "
        f"version; kernel {ms:.4f} ms (plain {plain:.3f} ms; "
        f"torch.sparse.mm {lib:.4f} ms; bound {bound:.4f} ms by {by})")
    if bad:
        fail("blocked SpMM disagrees at d = 1100:\n  " + "\n  ".join(bad))
    stats[f"spmm_blocked_d{WIDE}"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
        bound_by=by, library_ms=lib)
    del x
    torch.cuda.empty_cache()


def distill_args(method: str, save_path: str, checkpoints: tuple, **kw):
    """The method's ogbn-arxiv config (``method_configs.py``) at r = 0.01,
    cut in depth by ``kw``; one quick training at each checkpoint;
    evaluation ``ARXIV_EVAL_SEEDS`` seed × 300 epochs with GCN."""
    from graphslim_tpu_torch.config import Args, finalize

    args = finalize(Args(dataset="ogbn-arxiv", method=method,
                         reduction_rate=0.01, save_path=save_path,
                         run_inter_eval=1, run_eval=ARXIV_EVAL_SEEDS,
                         eval_epochs=300, device="cuda", **kw),
                    explicit={"reduction_rate", "run_inter_eval", "run_eval",
                              "eval_epochs", *kw})
    return args.replace(checkpoints=checkpoints)


class Stamps:
    """Wraps a reducer method: the wall clock (after a device sync) at
    each call, the seconds each call took, and a torch.profiler breakdown
    (device ms by kernel) of the call numbered ``profile_at`` (with
    ``device_only``, a trace of the card's work without the host's
    operators, for a call of many thousand launches)."""

    def __init__(self, eng, name: str, profile_at=None,
                 device_only: bool = False):
        self.fn, self.at, self.seconds = getattr(eng, name), [], []
        self.profile_at, self.kernels = profile_at, None
        self.device_only = device_only   # trace the card's work alone
        setattr(eng, name, self)

    def __call__(self, *a, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.at.append(t0)
        if len(self.seconds) == self.profile_at:
            out, wall, self.kernels = profiled(
                lambda: self.fn(*a, **kw), host=not self.device_only)
        else:
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        self.seconds.append(wall)
        return out


def run_distillers(K, SB, SG, ds, tmp: str, stats: dict) -> dict:
    """GCSNTK, SimGC, SFGC, GEOM and GDEM at full width on the arxiv twin
    at r = 0.01 through create_reducer(...).reduce() and the default
    evaluator, each from a fresh save_path; returns each kernel's launches
    over the phase (the d = 1100 comparison's excepted)."""
    import numpy as np
    import torch

    from graphslim_tpu_torch.data import load_reduced
    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.reduce import create_reducer

    compare_spmm_wide(SB, ds, stats)
    ds.adj_norm().blocked()
    ds.adj_norm().blocked(transpose=True)
    K.reset_launches()
    SB.reset_launches()
    SG.reset_launches()

    def widths_since(before: dict) -> dict:
        return {d: c - before.get(d, 0)
                for d, c in sorted(SB.LAUNCHES_BY_WIDTH.items())
                if c > before.get(d, 0)}

    def run(method, setup, **kw):
        save = os.path.join(tmp, method)
        args = distill_args(method, save, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.time()
        eng = create_reducer(method, ds, args)
        timers = setup(eng)
        before = dict(SB.LAUNCHES_BY_WIDTH)
        t0 = time.perf_counter()
        red = eng.reduce(ds)
        torch.cuda.synchronize()
        t_red = eng.reduce_seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        w_red = widths_since(before)
        adj = red.adj if isinstance(red.adj, torch.Tensor) else None
        losses = [float(x) for x in getattr(eng, "losses", [])]
        if not torch.isfinite(red.feat).all() or \
                not torch.isfinite(red.labels.float()).all() or \
                (adj is not None and not torch.isfinite(adj).all()) or \
                not all(math.isfinite(x) for x in losses):
            fail(f"{method}: non-finite result (losses {losses[:5]} ...)")
        before = dict(SB.LAUNCHES_BY_WIDTH)
        t0 = time.perf_counter()
        (acc, std), _ = Evaluator(ds, args).evaluate(red, "GCN")
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        if not (math.isfinite(acc) and math.isfinite(std)):
            fail(f"{method}: accuracy {acc} ± {std}")
        summary = (f"n_syn {red.feat.shape[0]}, reduce {t_red:.2f} s (SpMM "
                   f"launches by width {w_red}), peak device memory "
                   f"{peak:.2f} GiB, evaluate GCN {args.run_eval} seed(s) x "
                   f"300 epochs {t_eval:.2f} s (SpMM {widths_since(before)}), "
                   f"accuracy "
                   f"{acc:.4f} ± {std:.4f} (reported, not gated)")
        return eng, red, args, timers, t_start, w_red, summary

    def written(path: str, t_start: float, what: str) -> None:
        if not (os.path.exists(path) and os.path.getmtime(path) >= t_start):
            fail(f"{what}: {path} was not written in this run")

    def soft_artifact(method, eng, red, args, classes) -> str:
        lab = red.labels
        if lab.dtype != torch.float32 or tuple(lab.shape) != \
                (red.feat.shape[0], classes):
            fail(f"{method}: labels {lab.dtype} {tuple(lab.shape)}")
        back = load_reduced(args.save_path, method, ds.name,
                            args.reduction_rate, args.seed, device="cuda")
        if back.labels.dtype != torch.float32 or \
                not torch.equal(back.labels, lab) or \
                not torch.equal(back.feat, red.feat):
            fail(f"{method}: the saved artifact does not read back equal")
        return f"labels float32 {list(lab.shape)} read back equal"

    # --- simgc: the 600-epoch teacher, then 60 steps --------------------
    def simgc_setup(eng):
        return dict(teacher=Stamps(eng, "train_teacher"),
                    step=Stamps(eng, "step", profile_at=40))

    k0 = dict(K.LAUNCHES)
    eng, red, args, tm, _, _, summary = run("simgc", simgc_setup,
                                            epochs=59, checkpoints=(30,))
    steps = len(tm["step"].seconds)
    pge = {k: v - k0[k] for k, v in K.LAUNCHES.items()}
    final = 0 if eng._best_reduced is not None else 1
    want = {"pge_fwd_ws": steps, "pge_bwd": steps,
            "pge_fwd_nows": len(args.checkpoints) + final}
    if steps != 60 or pge != want:
        fail(f"simgc: {steps} steps, PGE launches {pge}, expected {want}")
    # steps 2-59 less the profiled step 40 and step 41 after it
    timed = [x for i, x in enumerate(tm["step"].seconds)
             if i >= 2 and i not in (40, 41)]
    wall = 1e3 * sum(timed) / len(timed)
    kern = tm["step"].kernels
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
    log(f"simgc ogbn-arxiv r=0.01 (SGC teacher: 3 propagations, ntrans 2, "
        f"BN, dropout 0.5, {min(1000, max(2 * args.eval_epochs, 200))} "
        f"epochs; PGE nhid {eng.pge.cfg.nhid}; 60 of 3001 steps, a "
        f"checkpoint at step 30): teacher {tm['teacher'].seconds[0]:.2f} s, "
        f"PGE launches {pge} (one "
        f"forward keeping the workspace and one backward a step, one "
        f"no-grad forward a checkpoint); profiled step 40: device busy "
        f"{busy:.2f} ms (idle share estimated as 1 - busy / mean wall of "
        f"steps 2-59 less 40-41: {1 - busy / wall:.3f}), top: "
        + "; ".join(f"{k[:50]} {v:.2f} ms" for k, v in top)
        + f"; {summary}")
    del eng, red

    # --- sfgc and geom: 2 experts of 40 epochs, 3 outer steps ----------
    for method, cfg_teacher in (("sfgc", 2000), ("geom", 2400)):
        scale = 40 / cfg_teacher
        base = distill_args(method, tmp, ())
        cut = dict(num_experts=2, teacher_epochs=40,
                   expert_epochs=max(round(base.expert_epochs * scale), 10))
        if method == "sfgc":
            cut["start_epoch"] = max(round(base.start_epoch * scale), 10)
        else:
            cut.update(T=max(round(base.T * scale), 1),
                       max_start_epoch=max(round(base.max_start_epoch
                                                 * scale), 1),
                       max_start_epoch_s=max(round(base.max_start_epoch_s
                                                   * scale), 1))

        def traj_setup(eng):
            return dict(buffer=Stamps(eng, "build_buffer"),
                        draw=Stamps(eng, "draw"))

        g0 = SG.LAUNCHES["smem_gather"]
        eng, red, args, tm, t_start, w_red, summary = run(
            method, traj_setup, epochs=3, checkpoints=(2,), **cut)
        written(eng.buf_path, t_start, f"{method} expert buffer")
        at = tm["draw"].at
        per_step = [b - a for a, b in zip(at, at[1:])]
        extra = ""
        if method == "geom":
            extra = "; " + soft_artifact(method, eng, red, args, ds.nclass)
            if not torch.allclose(red.labels.sum(1),
                                  torch.ones_like(red.labels[:, 0]),
                                  atol=1e-5):
                fail("geom: soft-label rows do not sum to 1")
        log(f"{method} ogbn-arxiv r=0.01 (depth cut to {cut}; syn_steps "
            f"{args.syn_steps}, hidden {args.hidden}, soft_label "
            f"{args.soft_label}, init {args.init}): buffer "
            f"{tm['buffer'].seconds[0]:.2f} s for 2 experts x "
            f"{args.teacher_epochs} epochs, outer steps "
            f"{[round(x, 3) for x in per_step]} s (the first on the "
            f"kcenter graph; the last, with its "
            f"checkpoint, not shown), gather launches "
            f"{SG.LAUNCHES['smem_gather'] - g0}, losses "
            f"{[round(x, 5) for x in eng.losses]}{extra}; {summary}")
        del eng, red

    # --- gcsntk: 2 epochs over every k-means batch -----------------------
    seen = {}

    def ntk_setup(eng):
        batches = Stamps(eng, "train_batches")
        build = batches.fn

        def keep(data):
            out = build(data)
            seen["rows"] = [int(b[0].shape[0]) for b in out]
            return out

        batches.fn = keep
        return dict(batches=batches,
                    ckpt=Stamps(eng, "intermediate_evaluation"))

    eng, red, args, tm, _, _, summary = run("gcsntk", ntk_setup, epochs=2,
                                            checkpoints=(1,))
    rows = seen["rows"]
    big = max(rows)
    t_build, t_ckpt = tm["batches"].seconds[0], sum(tm["ckpt"].seconds)
    epoch_s = (eng.reduce_seconds - t_build - t_ckpt) / args.epochs
    extra = soft_artifact("gcsntk", eng, red, args, ds.nclass)
    log(f"gcsntk ogbn-arxiv r=0.01 (K {args.K}, L {args.L}, scale "
        f"{args.scale}, ridge {args.ridge}, lr {args.lr}; 2 of 200 epochs, "
        f"a checkpoint at epoch 1): {len(rows)} k-means batches of "
        f"{sum(rows)} train rows built in {t_build:.2f} s, largest {big} "
        f"rows ({big * big * 4 / 2 ** 20:.1f} MiB dense; all blocks "
        f"{sum(r * r for r in rows) * 4 / 2 ** 30:.2f} GiB), "
        f"{epoch_s:.2f} s an epoch (reduce less the batches and the "
        f"checkpoint's {t_ckpt:.2f} s); {extra}; {summary}")
    del eng, red

    # --- gdem: the eigensolve at k = 1000, then 12 epochs ---------------
    def gdem_setup(eng):
        return dict(eig=Stamps(eng, "lcc_eigen"))

    spmm0 = dict(SB.LAUNCHES_BY_WIDTH)
    eng, red, args, tm, t_start, w_red, summary = run(
        "gdem", gdem_setup, epochs=12, checkpoints=(11,))
    info = eng.eigen_info
    for f in ("eigenvalues.npy", "eigenvectors.npy", "idx_lcc.npy"):
        written(os.path.join(args.save_path, "eigen", ds.name, f), t_start,
                "gdem eigen cache")
    if info.get("backend") != "device" or info.get("arpack") or \
            not info.get("residual", 1.0) < 1e-2:
        fail(f"gdem: the eigensolve did not stay on the card with a "
             f"residual below 1e-2 ({info})")
    wide = widths_since(spmm0).get(WIDE, 0)
    if wide != 26 * info["sweeps"]:
        fail(f"gdem: {wide} SpMM launches at d = {WIDE}, expected 26 a "
             f"sweep for {info['sweeps']} sweeps")
    log(f"gdem ogbn-arxiv r=0.01 (eigen_k {eng.eigen_k}, ratio "
        f"{args.ratio}, e1/e2 {args.e1}/{args.e2}; 12 of {1000} epochs, a "
        f"checkpoint at epoch 11): eigensolve of the LCC's {info['n']} "
        f"nodes at k {info['k']}: {info['sweeps']} sweeps, max residual "
        f"{info['residual']:.3e}, {info['device_seconds']:.2f} s on the "
        f"card ({tm['eig'].seconds[0]:.2f} s with the LCC and the cache), "
        f"{wide} SpMM launches at d = {WIDE}, no ARPACK; {summary}")
    del eng, red
    torch.cuda.empty_cache()
    launches = {"pge_fwd": K.LAUNCHES["pge_fwd_ws"]
                + K.LAUNCHES["pge_fwd_nows"],
                "pge_bwd": K.LAUNCHES["pge_bwd"],
                "spmm_blocked": SB.LAUNCHES["spmm_blocked"],
                "smem_gather": SG.LAUNCHES["smem_gather"]}
    log(f"phase 11 kernel launches: {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the inductive setting on the flickr, reddit and yelp twins
# ---------------------------------------------------------------------------

SLAB = 64       # column slabs of the plain and float64 reddit-twin SpMMs


def load_ind_twin(name: str) -> tuple:
    """(dataset, seconds): the twin synthesized (or read from the cache
    under ``build/cache``), then loaded with its inductive views; each
    subgraph's host normalization and blocked layout built once, timed."""
    import torch

    from graphslim_tpu_torch.data import load, loader

    spec = loader.DATASET_SPECS[name]
    t0 = time.perf_counter()
    loader._synth_cached(name, spec)
    secs = {"synthesis": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ds = load(name, seed=0, device="cuda")
    torch.cuda.synchronize()
    secs["load and views"] = time.perf_counter() - t0
    if ds.setting != "ind":
        fail(f"{name}: setting {ds.setting}, expected ind")
    for split in ("train", "val", "test"):
        t0 = time.perf_counter()
        ds.view_norm_host(split)
        secs[f"{split} norm"] = time.perf_counter() - t0
        layout = ds.view_norm(split).blocked()
        if ds.view_norm(split).blocked(transpose=True) is not layout:
            fail(f"{name}: the {split} subgraph's Â is not symmetric")
        secs[f"{split} layout"] = layout.build_seconds
    sizes = ", ".join(
        f"{s} {getattr(ds, 'feat_' + s).shape[0]} rows / "
        f"{getattr(ds, 'adj_' + s).nnz} entries" for s in
        ("train", "val", "test"))
    log(f"{name} twin: {ds.n_nodes} nodes, {ds.adj.nnz} entries, d "
        f"{ds.n_feat}, {ds.nclass} classes; views: {sizes}; seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return ds, secs


# The widths phase 12 gives the blocked SpMM on each twin's train subgraph:
# the features (and the hoisted ``[X | 1]``), the hidden width on reddit
# and the class counts (yelp's 33: its 32 features hoisted)
IND_SPMM_WIDTHS = {"flickr": (500, 501, 7), "reddit": (602, 603, 256, 41),
                   "yelp": (2, 33)}


def compare_spmm_ind(SB, ds, stats: dict) -> None:
    """The blocked SpMM on the twin's train subgraph Â at each of its
    ``IND_SPMM_WIDTHS``, against its plain version and a float64 product
    on column slabs of 64 (whole-width gathers of the reddit twin's
    entries would take 67 GB), timed beside the plain version (summed
    over the slabs), ``torch.sparse.mm`` and its bound; at d = 256
    the backward too."""
    import torch

    name = ds.name
    adj = ds.view_norm("train")
    layout = adj.blocked()
    n, nnz = adj.n_rows, adj.nnz
    csr = adj.to_csr()
    gen = torch.Generator(device="cuda").manual_seed(6)
    bad: list = []
    for d in IND_SPMM_WIDTHS[name]:
        x = torch.randn(n, d, generator=gen, device="cuda")
        err = check_spmm(SB, f"{name} train d={d}", adj, layout, x, bad,
                         slab=SLAB)
        torch.cuda.empty_cache()
        plain = sum(median_ms(lambda xs=x[:, a:a + SLAB].contiguous():
                              SB.spmm_blocked_plain(layout, xs), 3, 1)
                    for a in range(0, d, SLAB))
        extra = ""
        if d == 256:
            g = torch.randn(n, d, generator=gen, device="cuda")
            leaf = x.clone().requires_grad_(True)
            with torch.enable_grad():
                (gx,) = torch.autograd.grad(adj.matmul(leaf), leaf, g)
            err_b = 0.0
            for a in range(0, d, SLAB):
                gs = g[:, a:a + SLAB].contiguous()
                g64 = adj.rmatmul(gs.double(), n)
                err_b = max(err_b, check_close(
                    f"spmm {name} train d={d} bwd cols {a} vs float64",
                    gx[:, a:a + SLAB].double(), g64, TOL_SPMM, bad))
                del g64
            err = max(err, err_b)
            extra = f", bwd max|Δ| against float64 {err_b:.2e}"
            del g, leaf, gx
        ms = median_ms(lambda: SB.spmm_blocked(layout, x))
        lib = median_ms(lambda: torch.sparse.mm(csr, x))
        bound, by = spmm_bound(nnz, n, n, d)
        plan = SB.launch_plan(d, d % 4 == 0)
        log(f"spmm {name} twin train subgraph d={d} ({n} rows, {nnz} "
            f"entries, layout {layout.describe()}; {plan['n_slabs']} "
            f"walk(s) of the entries): max|Δ| {err:.2e}{extra}; kernel "
            f"{ms:.4f} ms (plain {plain:.3f} ms over {-(-d // SLAB)} slabs; "
            f"torch.sparse.mm {lib:.4f} ms; bound {bound:.4f} ms by {by})")
        stats[f"spmm_blocked_{name}_d{d}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib)
        del x
        torch.cuda.empty_cache()
    del csr
    torch.cuda.empty_cache()
    if bad:
        fail(f"blocked SpMM disagrees on the {name} twin's train subgraph:"
             "\n  " + "\n  ".join(bad))


def ind_args(name: str, method: str, save_path: str, run_eval: int,
             checkpoints: tuple = (), eval_epochs: int = 300, **kw):
    """The method's paper config for the twin (``method_configs.py``) at
    the twin's representative rate, cut in depth by ``kw``; one quick
    training at each checkpoint; evaluation ``run_eval`` seeds ×
    ``eval_epochs``."""
    from graphslim_tpu_torch.config import Args, finalize

    args = finalize(Args(dataset=name, method=method, save_path=save_path,
                         run_inter_eval=1, run_eval=run_eval,
                         eval_epochs=eval_epochs, device="cuda", **kw),
                    explicit={"run_inter_eval", "run_eval", "eval_epochs",
                              *kw})
    if args.setting != "ind":
        fail(f"{method} on {name}: setting {args.setting}")
    return args.replace(checkpoints=checkpoints)


class Launches:
    """Sets the kernels' launch counters to 0 just before a run; ``since``
    reads them just after, by kind and SpMM width."""

    def __init__(self, K, SB, SG):
        self.mods = (K, SB, SG)
        for mod in self.mods:
            mod.reset_launches()

    def since(self) -> dict:
        K, SB, SG = self.mods
        out = dict(K.LAUNCHES, gather=SG.LAUNCHES["smem_gather"])
        out.update({f"spmm d={d}": c
                    for d, c in SB.LAUNCHES_BY_WIDTH.items()})
        return {k: v for k, v in sorted(out.items()) if v > 0}


def busy_ms(fn) -> tuple:
    """(result, wall s, device-busy ms) of ``fn()`` in a device-only
    profiled window (``profiled``)."""
    out, wall, kernels = profiled(fn)
    return out, wall, sum(kernels.values())


def pge_rule(launches: dict, outer: int, nograd: int) -> None:
    """One PGE forward keeping the workspace and one backward an outer
    step; ``nograd`` forwards without it (every ``inference_adj``: the
    inner loops', the checkpoints' and the end's)."""
    got = (launches.get("pge_fwd_ws", 0), launches.get("pge_bwd", 0),
           launches.get("pge_fwd_nows", 0))
    if got != (outer, outer, nograd):
        fail(f"PGE launches (fwd keeping the workspace, bwd, fwd without) "
             f"{got}, expected {(outer, outer, nograd)}")


def run_ind_gcond(K, SB, SG, ds, tmp: str, epochs: int, n_syn: int,
                  nhid: int, model: str, run_eval: int) -> tuple:
    """GCond at the twin's paper config through create_reducer, ``epochs``
    epochs (the last profiled, a checkpoint at the one before), then the
    ``model`` evaluation on the test subgraph.  Returns the result line
    and the launches of the reduce and the evaluation."""
    import torch

    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.reduce import create_reducer

    args = ind_args(ds.name, "gcond", os.path.join(tmp, ds.name), run_eval,
                    checkpoints=(epochs - 2,), init="random", epochs=epochs,
                    eval_model=model)
    torch.cuda.reset_peak_memory_stats()
    eng = create_reducer("gcond", ds, args)
    if (eng.n_syn, args.hidden, eng.pge.cfg.nhid) != (n_syn, 256, nhid) \
            or eng.fanouts != ((15, 8) if ds.name in ("flickr", "reddit")
                               else (10, 5)):
        fail(f"gcond {ds.name}: n_syn {eng.n_syn}, hidden {args.hidden}, "
             f"PGE nhid {eng.pge.cfg.nhid}, fanouts {eng.fanouts}")
    if int(eng.real.pools.max()) >= len(ds.idx_train):
        fail(f"gcond {ds.name}: a pool id is not local to the train "
             f"subgraph")
    steps = Stamps(eng, "match_loss_total")
    inference = Counter(eng, "inference_adj")
    inner = Counter(eng, "inner_adj")
    timer = EpochTimer(eng, K, SB, profile_at=epochs - 1)
    count = Launches(K, SB, SG)
    t0 = time.perf_counter()
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    t_red = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = count.since()
    outer = len(steps.seconds)
    if outer != epochs * args.outer_loop or inner.n != outer:
        fail(f"gcond {ds.name}: {outer} outer steps, {inner.n} inner_adj")
    pge_rule(launches, outer, inference.n)
    losses = [float(x) for x in eng.epoch_loss_sums]
    if not all(math.isfinite(x) for x in losses) or \
            not torch.isfinite(red.feat).all() or \
            not torch.isfinite(red.adj).all():
        fail(f"gcond {ds.name}: non-finite result (losses {losses})")
    # the outer steps of the unprofiled epochs past the first two steps
    ol = args.outer_loop
    at = steps.at[2:(epochs - 1) * ol]
    busy = sum(timer.kernels.values())
    wall_unprof = ol * (at[-1] - at[0]) / (len(at) - 1)
    count = Launches(K, SB, SG)
    t0 = time.perf_counter()
    (acc, std), _ = Evaluator(ds, args).evaluate(red, model)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    if not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
        fail(f"gcond {ds.name}: {args.metric} {acc}")
    line = (f"gcond {ds.name} (ind, r={args.reduction_rate}, {args.outer_loop}"
            f" outer x {args.inner_loop} inner, ntrans {args.ntrans}, lr "
            f"{args.lr_feat}/{args.lr_adj}, fanouts {list(eng.fanouts)}, "
            f"{epochs} epochs): n_syn {eng.n_syn}, PGE nhid "
            f"{eng.pge.cfg.nhid}, reduce {t_red:.2f} s, launches "
            f"{launches}, peak {peak:.2f} GiB, profiled epoch "
            f"{epochs - 1}: busy {busy:.1f} ms, idle share "
            f"{1 - busy / (1e3 * wall_unprof):.3f} (1 - busy / an epoch's "
            f"wall over the unprofiled steps 2-{(epochs - 1) * ol - 1}); "
            f"losses "
            f"{[round(x / (eng.nclass * ol), 5) for x in losses]}; evaluate "
            f"{model} {args.run_eval} seeds x 300 epochs on the test "
            f"subgraph {t_eval:.2f} s (launches {count.since()}), "
            f"{args.metric} {acc:.4f} ± {std:.4f}")
    return line, launches, count.since()


# Phase 12's other reducers on the flickr twin, with their depth cuts and
# the hook whose call is profiled: ``_epoch`` (the last epoch; the idle
# share against the others' mean wall), a named call of each outer step
# (SimGC's whole step; SFGC's and GEOM's unrolled forward, under a
# device-only trace), the call numbered profiled; or None (the whole
# reduce).  A checkpoint runs after the last epoch.
FLICKR_RUNS = [
    ("random", {}, None), ("kcenter_sample", {}, None),
    ("herding", {}, None), ("herding", {"agg": True}, None),
    ("cent_d", {}, None), ("cent_p", {}, None),
    ("doscond", {"epochs": 3}, "_epoch"),
    ("gcondx", {"epochs": 3}, "_epoch"),
    ("doscondx", {"epochs": 3}, "_epoch"),
    ("gcdm", {"epochs": 3}, "_epoch"), ("gcdmx", {"epochs": 3}, "_epoch"),
    ("sgdd", {"epochs": 2}, "_epoch"),
    ("clustering", {}, None), ("clustering", {"agg": True}, None),
    ("averaging", {}, None), ("vng", {"condense_model": "GCN"}, None),
    ("msgc", {"epochs": 3}, "_epoch"), ("mirage", {}, None),
    ("gecc", {}, None), ("gcsntk", {"epochs": 2}, None),
    ("simgc", {"epochs": 19}, ("step", 10)),
    ("sfgc", {"epochs": 3}, ("match_loss", 1)),
    ("geom", {"epochs": 3}, ("geom_loss", 1)),
    ("gdem", {"epochs": 4}, None),
]


# the epochs of every training those runs make (the coresets' and VNG's
# GCN, SimGC's teacher, the checkpoint's and the final evaluation): 300
# cut to 100 to keep the whole smoke inside its time limit (PERF.md §6)
FLICKR_EVAL_EPOCHS = 100


def expert_cut(args) -> dict:
    """SFGC's and GEOM's buffer cut to 2 experts of 40 epochs, the expert,
    start and curriculum epochs scaled alike (phase 11's rule)."""
    scale = 40 / args.teacher_epochs
    cut = dict(num_experts=2, teacher_epochs=40,
               expert_epochs=max(round(args.expert_epochs * scale), 10))
    if args.method == "sfgc":
        cut["start_epoch"] = max(round(args.start_epoch * scale), 10)
    else:
        cut.update(T=max(round(args.T * scale), 1),
                   max_start_epoch=max(round(args.max_start_epoch * scale),
                                       1),
                   max_start_epoch_s=max(round(args.max_start_epoch_s
                                               * scale), 1))
    return cut


def run_ind(K, SB, SG, tmp: str, stats: dict, keep=None) -> dict:
    """Phase 12: the inductive setting at full width.  Each twin's train
    subgraph first holds the blocked SpMM at the phase's widths
    (``compare_spmm_ind``).  flickr: GCond at its paper config (3 epochs)
    with SGC evaluation on the test subgraph, kcenter with GCN, then every
    other ported reducer once at cut depth; reddit: GCond (2 of its 1000
    epochs) with SGC evaluation; yelp: GCond with GCN evaluation scored by
    macro F1.  Every run's launches are counted from 0 (``Launches``);
    returns each kernel's launches over the phase's runs.  With ``keep``
    (a dict) the reddit twin stays loaded in ``keep["reddit"]`` for phase
    17."""
    import numpy as np
    import torch

    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.reduce import create_reducer

    totals = {"pge_fwd": 0, "pge_bwd": 0, "spmm_blocked": 0,
              "smem_gather": 0}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            if k.startswith("pge_fwd"):
                totals["pge_fwd"] += v
            elif k == "pge_bwd":
                totals["pge_bwd"] += v
            elif k == "gather":
                totals["smem_gather"] += v
            else:
                totals["spmm_blocked"] += v

    for mod in (K, SB, SG):
        mod.reset_launches()

    # --- flickr ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    flickr, _ = load_ind_twin("flickr")
    compare_spmm_ind(SB, flickr, stats)
    n_train = len(flickr.idx_train)
    line, red_l, ev_l = run_ind_gcond(K, SB, SG, flickr, tmp, 3, 713, 256,
                                      "SGC", 3)
    add(red_l)
    add(ev_l)
    log(line)

    def reduce_once(method, cut, hook, run_eval=1, epochs=300):
        save = os.path.join(tmp, "flickr", method + ("_agg" if cut.get("agg")
                                                    else ""))
        base = ind_args("flickr", method, save, run_eval)
        if method in ("sfgc", "geom"):
            cut = dict(cut, **expert_cut(base))
        ckpt = (cut["epochs"] - 1,) if "epochs" in cut else ()
        args = ind_args("flickr", method, save, run_eval, ckpt,
                        eval_epochs=epochs, **cut)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = create_reducer(method, flickr, args)
        timer = stamps = None
        if hook == "_epoch":
            timer = EpochTimer(eng, K, SB, profile_at=args.epochs - 1)
        elif hook is not None:
            stamps = Stamps(eng, hook[0], profile_at=hook[1],
                            device_only=hook[0] != "step")
        count = Launches(K, SB, SG)
        t0 = time.perf_counter()
        if hook is None:
            red, wall, busy = busy_ms(lambda: eng.reduce(flickr))
        else:
            red = eng.reduce(flickr)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t_red = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = count.since()
        adj = red.adj if isinstance(red.adj, torch.Tensor) else None
        if not torch.isfinite(red.feat).all() or \
                not torch.isfinite(red.labels.float()).all() or \
                (adj is not None and not torch.isfinite(adj).all()):
            fail(f"{method} flickr: non-finite reduced graph")
        if timer is not None:
            busy = sum(timer.kernels.values())
            unprof = timer.seconds[:-1]
            idle = 1 - busy / (1e3 * sum(unprof) / len(unprof))
            how = f"profiled epoch {args.epochs - 1}"
        elif stamps is not None:
            busy = sum(stamps.kernels.values())
            idle = 1 - busy / (1e3 * stamps.seconds[hook[1]])
            how = f"profiled {hook[0]} call {hook[1]} (its own wall)"
        else:
            idle = 1 - busy / (1e3 * wall)
            how = "profiled reduce (device trace; wall under it)"
        count = Launches(K, SB, SG)
        t0 = time.perf_counter()
        (acc, std), _ = Evaluator(flickr, args).evaluate(red, "GCN")
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t0
        if not math.isfinite(acc):
            fail(f"{method} flickr: accuracy {acc}")
        ev = count.since()
        add(launches)
        add(ev)
        tag = method + (" --agg" if cut.get("agg") else "")
        return eng, red, (
            f"{tag} flickr (ind, r={args.reduction_rate}, cut "
            f"{ {k: v for k, v in cut.items() if k != 'agg'} }): n_syn "
            f"{red.feat.shape[0]}, reduce {t_red:.2f} s, launches "
            f"{launches}, peak {peak:.2f} GiB, {how}: busy {busy:.1f} ms, "
            f"idle share {idle:.3f}; evaluate GCN {args.run_eval} seed(s) "
            f"x {args.eval_epochs} epochs {t_eval:.2f} s (launches {ev}), "
            f"accuracy {acc:.4f}")

    # kcenter: a GCN fit on the train subgraph, gathers on local pools
    eng, red, line = reduce_once("kcenter", {}, None, run_eval=3)
    if int(eng.pool_idx.max()) >= n_train or eng.embed_model[2] is not \
            flickr.view_norm("train"):
        fail("kcenter flickr: pools not local to the train subgraph")
    if "gather" not in line:
        fail("kcenter flickr: no row gather launched")
    log(line + f"; embedding GCN best val (on the train subgraph) "
        f"{float(eng.embed_model[3]):.4f}")
    del eng, red
    for method, cut, hook in FLICKR_RUNS:
        eng, red, line = reduce_once(method, cut, hook,
                                     epochs=FLICKR_EVAL_EPOCHS)
        log(line)
        del eng, red
    peak_flickr = torch.cuda.max_memory_allocated() / 2 ** 30
    del flickr
    torch.cuda.empty_cache()

    # --- reddit ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reddit, _ = load_ind_twin("reddit")
    compare_spmm_ind(SB, reddit, stats)
    line, red_l, ev_l = run_ind_gcond(K, SB, SG, reddit, tmp, 2, 186, 256,
                                      "SGC", 3)
    add(red_l)
    add(ev_l)
    log(line + f"; peak device memory of the reddit twin's phase "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if keep is not None:
        keep["reddit"] = reddit
    del reddit
    torch.cuda.empty_cache()

    # --- yelp: macro F1 ---------------------------------------------------
    yelp, _ = load_ind_twin("yelp")
    compare_spmm_ind(SB, yelp, stats)
    line, red_l, ev_l = run_ind_gcond(K, SB, SG, yelp, tmp, 2, 36, 128,
                                      "GCN", 3)
    if "f1_macro" not in line:
        fail("yelp: not scored by macro F1")
    add(red_l)
    add(ev_l)
    labels = yelp.labels_test.cpu().numpy()
    log(line + f"; the test subgraph's largest class holds "
        f"{np.bincount(labels).max() / labels.shape[0]:.4f} of its rows")
    del yelp
    torch.cuda.empty_cache()
    log(f"phase 12 kernel launches: {totals}; flickr peak device memory "
        f"{peak_flickr:.2f} GiB")
    return totals


# ---------------------------------------------------------------------------
# Phase 13: edge sparsification and structural coarsening
# ---------------------------------------------------------------------------

EDGE_SPARSIFIERS = ("random_edge", "g_spar", "scan", "local_degree",
                    "spanning_forest", "rank_degree", "t_spanner")
COARSENERS = ("variation_neighborhoods", "variation_edges",
              "variation_cliques", "heavy_edge", "algebraic_jc",
              "affinity_gs", "kron")
# reported without a gate, as the JAX package reports them
# (EFFICIENCY.md:89)
UNGATED = {"spanning_forest", "t_spanner"}
# (twin, method, flags, evaluation seeds, gate), each at the twin's
# representative rate: (a) cora, every method (the blossom strategy for
# two); (b) the arxiv twin, six sparsifiers (reported, not gated) and
# heavy_edge (n_syn and entries only); (c) pubmed; (d) flickr, inductive
COARSEN_RUNS = (
    [("cora", m, {}, 1, m not in UNGATED)
     for m in EDGE_SPARSIFIERS + COARSENERS]
    + [("cora", m, {"coarsen_strategy": "optimal"}, 1, True)
       for m in ("heavy_edge", "variation_edges")]
    + [("ogbn-arxiv", m, {}, 1, False) for m in EDGE_SPARSIFIERS[:6]]
    + [("ogbn-arxiv", "heavy_edge", {}, 1, False)]
    + [("pubmed", m, {}, 1, m not in UNGATED)
       for m in ("t_spanner",) + COARSENERS[:3]
       + ("algebraic_jc", "affinity_gs")]
    + [("flickr", m, {}, 1, True)
       for m in ("random_edge", "g_spar", "heavy_edge")])


# the epochs of every evaluation of the phase: the default evaluator's 300
# cut to 100 to keep the whole smoke inside its time limit (PERF.md §6)
COARSEN_EVAL_EPOCHS = 100

# the reduced graphs the blocked SpMM is held on after the runs, at the
# widths their evaluation launched, beside the pubmed coarse graph with
# the most entries: the arxiv Â after keeping 1% of the edges (nearly
# every row only its self loop); Kron's cora graph (979 rows, nearly full
# tiles) and a cora sparsifier's, both at d = 7 and 1434
HELD = (("ogbn-arxiv", "random_edge", {}), ("cora", "kron", {}),
        ("cora", "random_edge", {}))


def same_triple(a, b) -> bool:
    import torch

    return (torch.equal(a.feat, b.feat) and torch.equal(a.labels, b.labels)
            and a.adj.n_rows == b.adj.n_rows
            and torch.equal(a.adj.row, b.adj.row)
            and torch.equal(a.adj.col, b.adj.col)
            and torch.equal(a.adj.values_or_ones(), b.adj.values_or_ones()))


def compare_spmm_reduced(SB, G, tag: str, raw, widths, stats: dict,
                         normalized: bool = False) -> None:
    """The blocked SpMM on a reduced graph's normalized Â (what the
    evaluator trains on; ``raw`` itself when ``normalized``) at the widths
    its evaluation launched, against the plain version and float64, bit
    for bit on a repeat; timed beside the plain version,
    ``torch.sparse.mm`` and its bound."""
    import torch

    adj = raw if normalized else G.gcn_norm(raw)
    layout = adj.blocked()
    csr = adj.to_csr()
    n, nnz = adj.n_rows, adj.nnz
    gen = torch.Generator(device="cuda").manual_seed(13)
    bad: list = []
    parts = []
    for d in widths:
        x = torch.randn(n, d, generator=gen, device="cuda")
        # above 256 columns the references are made on slabs of 256
        err = check_spmm(SB, f"{tag} d={d}", adj, layout, x, bad,
                         slab=256 if d > 256 else 0)
        ms = queued_ms(lambda: SB.spmm_blocked(layout, x))
        plain = queued_ms(lambda: SB.spmm_blocked_plain(layout, x), 5)
        lib = queued_ms(lambda: torch.sparse.mm(csr, x))
        bound, by = spmm_bound(nnz, n, n, d)
        parts.append(f"d={d}: max|Δ| {err:.2e}, kernel {ms:.4f} ms (plain "
                     f"{plain:.4f} ms; torch.sparse.mm {lib:.4f} ms; bound "
                     f"{bound:.5f} ms by {by})")
        stats[f"spmm_blocked_{tag}_d{d}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib)
        del x
    diag = int((adj.row == adj.col).sum())
    log(f"spmm on the {tag}: {n} rows, {nnz} stored entries "
        f"({nnz - diag} off the diagonal, {nnz / max(n, 1):.1f} a row), "
        f"layout {layout.describe()}; device "
        f"time of launches queued back to back; " + "; ".join(parts))
    if bad:
        fail(f"blocked SpMM disagrees on the {tag} Â:\n  "
             + "\n  ".join(bad))


def run_coarsen(SB, G, arxiv, tmp: str, stats: dict) -> dict:
    """Phase 13: the seven edge sparsifiers and the seven structural
    coarseners through ``train_all.run`` (the twin loaded once, handed to
    it) and the default evaluator (GCN, ``COARSEN_EVAL_EPOCHS`` epochs),
    ``COARSEN_RUNS``.
    Each run's SpMM launches are counted from 0; returns the phase's."""
    import numpy as np
    import torch

    from graphslim_tpu_torch import train_all as TA
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load_reduced

    t_phase = time.perf_counter()
    # each twin is loaded once, with the options train_all.run asks for
    # (the arxiv twin of the earlier phases was loaded with the same)
    twins = {"ogbn-arxiv": arxiv}
    options = {"ogbn-arxiv": dict(setting="trans", split="fixed", seed=0,
                                  data_dir=None, pre_norm=True,
                                  device="cuda")}
    majority = {}
    real_load = TA.load

    def load_twin(name, **kw):
        if name not in twins:
            t0 = time.perf_counter()
            twins[name], options[name] = real_load(name, **kw), kw
            torch.cuda.synchronize()
            log(f"phase 13: load the {name} twin "
                f"{time.perf_counter() - t0:.2f} s")
        if kw != options[name]:
            fail(f"phase 13: load({name!r}) with options {kw}, the twin was "
                 f"loaded with {options[name]}")
        ds = twins[name]
        if name not in majority:
            # the evaluator's graphs: normalization and layout built once
            t0 = time.perf_counter()
            if ds.setting == "ind":
                ds.view_norm("val").blocked()
                ds.view_norm("test").blocked()
                labels = ds.labels_test.cpu().numpy()
            else:
                ds.adj_norm().blocked()
                labels = ds.labels.cpu().numpy()[ds.idx_test]
            torch.cuda.synchronize()
            majority[name] = float(np.bincount(labels).max()
                                   / labels.shape[0])
            log(f"phase 13: {name} twin ({ds.setting}): {ds.n_nodes} nodes, "
                f"{ds.adj.nnz} entries, {ds.nclass} classes; the evaluator's "
                f"normalization and layouts {time.perf_counter() - t0:.2f} "
                f"s; the test split's largest class holds "
                f"{majority[name]:.4f}")
        return ds

    seen: dict = {}
    create, evaluator = TA.create_reducer, TA.Evaluator

    def create_timed(method, data, args, **kw):
        agent = create(method, data, args, **kw)
        reduce = agent.reduce
        if hasattr(agent, "basis"):
            basis = agent.basis

            def timed_basis(W):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = basis(W)
                torch.cuda.synchronize()
                seen.setdefault("basis", []).append(
                    (W.shape[0], time.perf_counter() - t0))
                return out
            agent.basis = timed_basis

        def timed_reduce(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = reduce(*a, **k)
            torch.cuda.synchronize()
            seen["reduce"] = (time.perf_counter() - t0, out)
            seen["widths_reduce"] = dict(SB.LAUNCHES_BY_WIDTH)
            return out
        agent.reduce = timed_reduce
        return agent

    class TimedEvaluator(evaluator):
        def evaluate(self, reduced, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().evaluate(reduced, *a, **kw)
            torch.cuda.synchronize()
            seen["evaluate"] = time.perf_counter() - t0
            return out

    TA.create_reducer, TA.Evaluator, TA.load = \
        create_timed, TimedEvaluator, load_twin
    SB.reset_launches()
    total = 0
    coarse_c = None
    held = [None] * len(HELD)
    for name, method, flags, seeds, gate in COARSEN_RUNS:
        args = finalize(Args(dataset=name, method=method, seed=0,
                             run_eval=seeds, eval_epochs=COARSEN_EVAL_EPOCHS,
                             save_path=os.path.join(tmp, name),
                             device="cuda", **flags),
                        explicit={"seed", "run_eval", "eval_epochs",
                                  *flags})
        seen.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        SB.reset_launches()
        t0 = time.perf_counter()
        acc, std = TA.run(args)
        t_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t_red, red = seen["reduce"]
        w_red = seen["widths_reduce"]
        w_all = dict(SB.LAUNCHES_BY_WIDTH)
        w_eval = {d: c - w_red.get(d, 0) for d, c in sorted(w_all.items())
                  if c > w_red.get(d, 0)}
        total += SB.LAUNCHES["spmm_blocked"]
        tag = method + "".join(f" --{k} {v}" for k, v in flags.items())
        if not torch.isfinite(red.feat).all() or \
                not torch.isfinite(red.adj.values_or_ones()).all():
            fail(f"{tag} {name}: non-finite reduced graph")
        back = load_reduced(args.save_path, method, twins[name].name,
                            args.reduction_rate, args.seed, device="cuda")
        if not same_triple(back, red):
            fail(f"{tag} {name}: the artifact reads back another triple")
        bases = seen.get("basis", [])
        dense = [s for n, s in bases if n <= 3000]
        arpack = [s for n, s in bases if n > 3000]
        if not (math.isfinite(acc) and math.isfinite(std)):
            fail(f"{tag} {name}: accuracy {acc} ± {std}")
        if gate and not acc > majority[name]:
            fail(f"{tag} {name}: accuracy {acc:.4f} is not above the "
                 f"largest class share {majority[name]:.4f}")
        ds = twins[name]
        log(f"{tag} {name} ({ds.setting}, r={args.reduction_rate}): n_syn "
            f"{red.n_syn} of {ds.train_graph()[0].shape[0]}, entries "
            f"{red.adj.nnz} of {ds.train_graph()[1].nnz}; reduce "
            f"{t_red:.2f} s (dense eigh on the card: {len(dense)} call(s), "
            f"{sum(dense):.3f} s = {sum(dense) / t_red:.3f} of it; ARPACK "
            f"{len(arpack)} call(s), {sum(arpack):.2f} s); evaluate GCN "
            f"{seeds} seed(s) x {args.eval_epochs} epochs "
            f"{seen['evaluate']:.2f} s, "
            f"accuracy {acc:.4f} ± {std:.4f} "
            f"({'gated' if gate else 'not gated'}); SpMM "
            f"launches by width: evaluation {w_eval}, reduce "
            f"{ {d: c for d, c in w_red.items() if c} }; peak "
            f"{peak:.2f} GiB; run {t_run:.2f} s")
        if (name, method, flags) in HELD:
            held[HELD.index((name, method, flags))] = (red.adj,
                                                       sorted(w_eval))
        if name == "pubmed" and method in COARSENERS and (
                coarse_c is None or red.adj.nnz > coarse_c[1].nnz):
            coarse_c = (method, red.adj, sorted(w_eval))
        del red, back
        seen.clear()
    TA.create_reducer, TA.Evaluator, TA.load = create, evaluator, real_load

    # the blocked SpMM on the phase's new shapes
    if None in held or coarse_c is None:
        fail(f"phase 13: no graph of {HELD} or no pubmed coarse graph to "
             f"hold the blocked SpMM on")
    for (name, method, _), graph in zip(HELD, held):
        compare_spmm_reduced(SB, G, f"{name} {method} Â", *graph, stats)
    compare_spmm_reduced(SB, G, f"pubmed {coarse_c[0]} Â", *coarse_c[1:],
                         stats)
    del twins, held, coarse_c
    torch.cuda.empty_cache()
    log(f"phase 13: {total} blocked-SpMM launches, "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"spmm_blocked": total}


# ---------------------------------------------------------------------------
# Phase 14: the model zoo and cross-architecture evaluation
# ---------------------------------------------------------------------------

# The (graph, width) pairs phase 14 gives the blocked SpMM: on the arxiv
# Â the hoisted [X | 1] (129), the class count (40: GCN's second layer,
# APPNP's steps), the features (128: Cheby's X + ÂX, GraphSage's first
# layer) and the hidden width (256: Cheby's and GraphSage's second layer,
# SGFormer's graph branch); on flickr's selected subgraph and its val and
# test subgraphs the same with flickr's 500 features and 7 classes
ZOO_HELD = {"arxiv": (40, 128, 129, 256), "flickr": (500, 501, 7, 256)}
# GAT's layer-1 shape at the evaluator's width: 8 heads of 32
GAT_HEADS, GAT_HID = 8, 256


IDLE_EPOCHS = 20     # the profiled fit that gives a model's idle share
# the epochs of every training of (a), (b) and (d): the evaluator's 300
# cut to 100 to keep the whole smoke inside its time limit (PERF.md §6)
ZOO_EPOCHS = 100


def profiled_busy(fn) -> tuple:
    """(wall ms, device-busy ms) of ``fn()`` in a device-only profiled
    window (``profiled``)."""
    _, wall, kernels = profiled(fn)
    return 1e3 * wall, sum(kernels.values())


def zoo_evaluator(SB, SG, rows: list, totals: dict, widths_seen: set):
    """An ``Evaluator`` whose ``evaluate`` records a row per call: wall
    seconds, ms per epoch of its fits, blocked-SpMM launches by width and
    gathers (counted from 0 and read just after it), peak GiB and, unless
    ``profile`` is off, the idle share: 1 − device busy / wall of a
    profiled ``IDLE_EPOCHS``-epoch fit on the same inputs, run after the
    counts are read (a trace of all its epochs takes longer to parse than
    the evaluation takes to run).  Every width it launched the SpMM at
    goes into ``widths_seen``."""
    import dataclasses

    import torch

    from graphslim_tpu_torch import models as M
    from graphslim_tpu_torch.eval import Evaluator

    class ZooEvaluator(Evaluator):
        profile = True

        def evaluate(self, reduced, model_type="GCN", *a, **kw):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            SB.reset_launches()
            SG.reset_launches()
            fits, calls = [], []
            real_fit = M.fit_with_val

            def timed_fit(*fa, **fk):
                calls.append((fa, fk))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real_fit(*fa, **fk)
                torch.cuda.synchronize()
                fits.append(time.perf_counter() - t0)
                return out

            M.fit_with_val = timed_fit
            try:
                t0 = time.perf_counter()
                out = Evaluator.evaluate(self, reduced, model_type, *a,
                                         **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                M.fit_with_val = real_fit
            widths = dict(SB.LAUNCHES_BY_WIDTH)
            widths_seen.update(widths)
            totals["spmm_blocked"] += sum(widths.values())
            totals["smem_gather"] += SG.LAUNCHES["smem_gather"]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            idle = float("nan")
            if self.profile:
                fa, fk = calls[0]
                fk = dict(fk, cfg=dataclasses.replace(fk["cfg"],
                                                      epochs=IDLE_EPOCHS))
                ms, busy = profiled_busy(lambda: real_fit(*fa, **fk))
                idle = 1.0 - busy / ms
            rows.append(dict(
                model=model_type, score=out[0][0], seconds=wall,
                widths=widths, peak=peak, idle=idle,
                ms_epoch=1e3 * sum(fits) / max(len(fits)
                                               * self.args.eval_epochs, 1)))
            return out

    return ZooEvaluator


def zoo_table(tag: str, rows: list, table: dict, share: float,
              gate: bool) -> None:
    """One line per model; fails on a non-finite entry, and with ``gate``
    on one at or below the test split's largest-class share."""
    import math

    bad = []
    for mt, (mean, std) in table.items():
        r = next((r for r in rows if r["model"] == mt), None)
        cols = "" if r is None else (
            f"evaluate {r['seconds']:.2f} s, {r['ms_epoch']:.3f} ms an "
            f"epoch, SpMM launches "
            + (", ".join(f"d={d} {c}" for d, c in sorted(r["widths"].items()))
               or "none")
            + f", peak {r['peak']:.2f} GiB, idle {r['idle']:.3f} (a "
            f"{IDLE_EPOCHS}-epoch profiled fit)")
        log(f"phase 14 {tag} {mt}: {mean:.4f} ± {std:.4f}; {cols}")
        if not (math.isfinite(mean) and math.isfinite(std)):
            bad.append(f"{mt} {mean} ± {std}")
        elif gate and not mean > share:
            bad.append(f"{mt} {mean:.4f} <= the largest-class share "
                       f"{share:.4f}")
    from graphslim_tpu_torch.eval import Evaluator

    if set(table) != set(Evaluator.MODELS):
        bad.append(f"models {sorted(table)}")
    if bad:
        fail(f"phase 14 {tag}: " + "; ".join(bad))


def f64_attention_rows(sp, rows, a_d, a_s, feat):
    """GAT's edge softmax and aggregation in float64 at ``rows`` of the
    normalized ``sp`` → ``[len(rows), H, h]``."""
    import torch
    import torch.nn.functional as F

    from graphslim_tpu_torch.kernels.segment import (segment_softmax,
                                                     segment_sum)

    starts, ends = sp.indptr[rows], sp.indptr[rows + 1]
    counts = ends - starts
    er = torch.repeat_interleave(torch.arange(rows.shape[0],
                                              device=rows.device), counts)
    first = torch.cumsum(counts, 0) - counts
    eid = starts[er] + torch.arange(er.shape[0], device=rows.device) \
        - first[er]
    col, val = sp.col[eid], sp.val[eid].double()
    s = F.leaky_relu(a_d.double()[rows][er] + a_s.double()[col], 0.2)
    att = segment_softmax(s, er, rows.shape[0]) * val[:, None]
    return segment_sum(feat.double()[col] * att[..., None], er,
                       rows.shape[0])


def run_gat_ell(ds, stats: dict) -> None:
    """(c): one GAT layer at full width on the arxiv twin's ELL, at
    inference (bf16 messages) and in float32, timed beside its bound and
    the segment path; held against the segment path, float64 on sampled
    rows, and as a whole model against the segment path."""
    import torch

    from graphslim_tpu_torch import models as M
    from graphslim_tpu_torch.kernels.ell import attention_ell

    ell = ds.adj_norm_ell()
    sp = ds.adj_norm()
    ks = sorted({int(b.idx.shape[1]) for b in ell.buckets})
    heavy_e = 0 if ell.heavy_col is None else ell.heavy_col.shape[0]
    log(f"phase 14 (c) arxiv ELL: {len(ell.buckets)} bucket parts (K = "
        f"{ks}), {ell.n_heavy} heavy rows with {heavy_e} entries in "
        f"{len(ell.chunks())} chunk(s), {ell.nnz} padded slots for "
        f"{sp.nnz} entries ({ell.nnz / sp.nnz:.3f}x), built in "
        f"{ell.build_seconds:.2f} s, {ell.nbytes() / 1e6:.1f} MB")
    cfg = M.ModelConfig(nfeat=ds.n_feat, nhid=GAT_HID, nclass=ds.nclass,
                        nheads=GAT_HEADS, dropout=0.0)
    model = M.get_model("GAT", cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(14))
    x, n = ds.feat, ds.n_nodes
    H, h = GAT_HEADS, GAT_HID // GAT_HEADS
    bad: list = []
    with torch.no_grad():
        feat = (x @ params["w1"]).reshape(n, H, h)
        a_d = torch.einsum("nhd,hd->nh", feat, params["a1"][0])
        a_s = torch.einsum("nhd,hd->nh", feat, params["a1"][1])
        fbf = feat.to(torch.bfloat16)
        out32 = attention_ell(ell, a_d, a_s, feat)
        outbf = attention_ell(ell, a_d, a_s, fbf)
        # the heavy tail's segment sums are atomic adds on the card, so a
        # repeat agrees to rounding, not bit for bit
        e_rep = check_close("bf16 ELL layer repeated", attention_ell(
            ell, a_d, a_s, fbf).float(), outbf.float(), (8e-3, 1e-4), bad)
        seg = model._attn_layer(x, sp, params["w1"], params["a1"], H,
                                False, None, 0.0).reshape(n, H, h)
        e_seg = check_close("f32 ELL layer vs segment", out32, seg,
                            (2e-3, 2e-4), bad)
        # 4096 random rows, each bucket part's first and the heavy rows
        gen = torch.Generator(device=x.device).manual_seed(15)
        rows = torch.cat([
            torch.randint(0, n, (4096,), generator=gen, device=x.device),
            torch.stack([b.rows[0] for b in ell.buckets]),
            ell.heavy_rows if ell.heavy_rows is not None
            else torch.zeros(0, dtype=torch.int64, device=x.device)
        ]).unique()
        ref = f64_attention_rows(sp, rows, a_d, a_s, feat)
        refbf = f64_attention_rows(sp, rows, a_d,
                                   a_s.to(torch.bfloat16).float(),
                                   fbf.float())
        e64 = check_close("f32 ELL layer vs float64", out32[rows].double(),
                          ref, (1e-4, 1e-5), bad)
        e64s = check_close("segment layer vs float64", seg[rows].double(),
                           ref, (1e-4, 1e-5), bad)
        ebf = check_close("bf16 ELL layer vs float64 of its bf16 inputs",
                          outbf[rows].double(), refbf, (8e-3, 1e-4), bad)
        ebf64 = check_close("bf16 ELL layer vs float64", outbf[rows].double(),
                            ref, (5e-2, 5e-2), bad)
        ms_bf = median_ms(lambda: attention_ell(ell, a_d, a_s, fbf), 10)
        ms32 = median_ms(lambda: attention_ell(ell, a_d, a_s, feat), 10)
        ms_seg = median_ms(lambda: model._attn_layer(
            x, sp, params["w1"], params["a1"], H, False, None, 0.0), 10)
        # whole model: float32 ELL (the training path at dropout 0) and
        # the bf16 inference path against the segment path
        m_seg = model.apply(params, x, sp)
        m32 = model.apply(params, x, ell, training=True)
        mbf = model.apply(params, x, ell)
        if not ((m32 - m_seg).abs() <= 2e-4 + 2e-3 * m_seg.abs()).all():
            bad.append(f"GAT float32 ELL vs segment: max|Δ| "
                       f"{max_err(m32, m_seg):.3e} beyond 2e-3 / 2e-4")
        agree = float((mbf.argmax(1) == m_seg.argmax(1)).float().mean())
        if not agree >= 0.99:
            bad.append(f"GAT bf16 argmax agreement {agree:.4f} < 0.99")
        if not ((mbf - m_seg).abs() <= 0.05 + 0.05 * m_seg.abs()).all():
            bad.append(f"GAT bf16 vs segment: max|Δ| "
                       f"{max_err(mbf, m_seg):.3e} beyond 0.05")
    bound = {dt: ell.nnz * (H + H * h) * size / PEAK_BYTES * 1e3
             for dt, size in (("bf16", 2), ("f32", 4))}
    log(f"phase 14 (c) GAT layer 1 (n {n}, {H} heads x {h}) on the ELL: "
        f"bf16 messages {ms_bf:.3f} ms (bound {bound['bf16']:.3f} ms by "
        f"bytes, {ms_bf / bound['bf16']:.1f}x), float32 {ms32:.3f} ms "
        f"(bound {bound['f32']:.3f}, {ms32 / bound['f32']:.1f}x), segment "
        f"path {ms_seg:.3f} ms; max|Δ| f32 vs segment {e_seg:.2e}, vs "
        f"float64 {e64:.2e} (segment {e64s:.2e}) on {rows.shape[0]} rows, "
        f"bf16 vs float64 of its inputs {ebf:.2e} (vs float64 {ebf64:.2e}; "
        f"a repeat {e_rep:.2e}); "
        f"model: f32 max|Δ| {max_err(m32, m_seg):.2e}, bf16 argmax "
        f"agreement {agree:.4f}, max|Δ| {max_err(mbf, m_seg):.2e}")
    stats["gat_ell"] = dict(ms_bf16=ms_bf, ms_f32=ms32, ms_segment=ms_seg,
                            bound_bf16=bound["bf16"], bound_f32=bound["f32"])
    del feat, fbf, out32, outbf, seg, ref, refbf, m_seg, m32, mbf
    torch.cuda.empty_cache()
    if bad:
        fail("phase 14 (c) GAT on the ELL:\n  " + "\n  ".join(bad))


def run_zoo(SB, SG, G, ds, tmp: str, stats: dict) -> dict:
    """Phase 14: (a) ``train_cross`` over the eight models on the shipped
    arxiv artifact (hidden 256, GAT 8 heads x 32, SGFormer 2 transformer
    layers; ``ZOO_EPOCHS`` epochs, 1 seed); (b) APPNP's 16-combination
    ``grid_search`` at the same depth; (c) GAT on the arxiv twin's ELL (``run_gat_ell``);
    (d) ``random`` on the flickr twin at its rate, then ``train_cross``
    over the eight; then the blocked SpMM at the (graph, width) pairs the
    phase launched (``ZOO_HELD``).  Returns the phase's launches."""
    import numpy as np
    import torch

    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import read_npz
    from graphslim_tpu_torch.reduce import create_reducer

    t_phase = time.perf_counter()
    totals = {"spmm_blocked": 0, "smem_gather": 0}
    rows: list = []
    launched: set = set()
    ZooEvaluator = zoo_evaluator(SB, SG, rows, totals, launched)

    # --- (a) ---------------------------------------------------------------
    args = finalize(Args(dataset="ogbn-arxiv", method="gcond", run_eval=1,
                         eval_epochs=ZOO_EPOCHS, device="cuda"),
                    explicit={"run_eval", "eval_epochs"})
    art = read_npz(os.path.join(HERE, "benchmark", "artifacts",
                                "arxiv_gcond_r0.01.npz"), device="cuda")
    labels = ds.labels.cpu().numpy()[ds.idx_test]
    share = float(np.bincount(labels).max() / labels.shape[0])
    ev = ZooEvaluator(ds, args)
    t0 = time.perf_counter()
    table = ev.train_cross(art)
    log(f"phase 14 (a) arxiv artifact, train_cross over {len(table)} "
        f"models (hidden {args.hidden}, 1 seed x {args.eval_epochs} "
        f"epochs): {time.perf_counter() - t0:.1f} s; the test split's "
        f"largest class holds {share:.4f}")
    zoo_table("(a) arxiv", rows, table, share, gate=True)

    # --- (b) ---------------------------------------------------------------
    rows.clear()
    ev.profile = False
    t0 = time.perf_counter()
    (mean, std), combo = ev.grid_search(art, "APPNP")
    n_combo = len(rows)
    if not (math.isfinite(mean) and math.isfinite(std)) or n_combo != 16:
        fail(f"phase 14 (b): APPNP grid {mean} ± {std} over {n_combo} "
             "combinations")
    log(f"phase 14 (b) APPNP grid_search over {n_combo} combinations: "
        f"{time.perf_counter() - t0:.1f} s, chose {combo}: {mean:.4f} ± "
        f"{std:.4f}; scores "
        + ", ".join(f"{r['score']:.4f}" for r in rows))

    # --- (c) ---------------------------------------------------------------
    t0 = time.perf_counter()
    run_gat_ell(ds, stats)
    log(f"phase 14 (c): {time.perf_counter() - t0:.1f} s")
    del art, ev
    torch.cuda.empty_cache()

    # --- (d) ---------------------------------------------------------------
    rows.clear()
    flickr, _ = load_ind_twin("flickr")
    fargs = ind_args("flickr", "random", os.path.join(tmp, "flickr"), 1,
                     eval_epochs=ZOO_EPOCHS)
    SB.reset_launches()
    SG.reset_launches()
    t0 = time.perf_counter()
    red = create_reducer("random", flickr, fargs).reduce(flickr)
    torch.cuda.synchronize()
    launched.update(SB.LAUNCHES_BY_WIDTH)
    totals["smem_gather"] += SG.LAUNCHES["smem_gather"]
    totals["spmm_blocked"] += sum(SB.LAUNCHES_BY_WIDTH.values())
    log(f"phase 14 (d) flickr random at r = {fargs.reduction_rate}: n_syn "
        f"{red.n_syn}, {red.adj.nnz} entries, "
        f"{time.perf_counter() - t0:.2f} s, {SG.LAUNCHES['smem_gather']} "
        "gathers")
    fshare = float(np.bincount(flickr.labels_test.cpu().numpy()).max()
                   / flickr.labels_test.shape[0])
    t0 = time.perf_counter()
    ftable = ZooEvaluator(flickr, fargs).train_cross(red)
    log(f"phase 14 (d) flickr train_cross: {time.perf_counter() - t0:.1f} "
        f"s; the test subgraph's largest class holds {fshare:.4f}")
    zoo_table("(d) flickr", rows, ftable, fshare, gate=False)

    # --- the blocked SpMM at the phase's (graph, width) pairs --------------
    held = set(ZOO_HELD["arxiv"]) | set(ZOO_HELD["flickr"])
    if not launched <= held:
        fail(f"phase 14 launched the SpMM at widths {sorted(launched)}, "
             f"held at {sorted(held)}")
    compare_spmm_reduced(SB, G, "arxiv Â", ds.adj_norm(), ZOO_HELD["arxiv"],
                         stats, normalized=True)
    compare_spmm_reduced(SB, G, "flickr random Â", red.adj,
                         ZOO_HELD["flickr"], stats)
    for split in ("val", "test"):
        compare_spmm_reduced(SB, G, f"flickr {split} Â",
                             flickr.view_norm(split), ZOO_HELD["flickr"],
                             stats, normalized=True)
    del flickr, red
    torch.cuda.empty_cache()
    log(f"phase 14: {totals['spmm_blocked']} blocked-SpMM launches, "
        f"{totals['smem_gather']} gathers, "
        f"{time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# Phase 15: the attacks, dataset files and the large loader
# ---------------------------------------------------------------------------

# PRBCD at the JAX defaults (block 250,000, 120 epochs, 30 fine-tune): the
# cora twin at ptb_r 0.25 (budget 2,293 of its 18,344 entries) and the
# arxiv twin at 0.05 (budget 110,981 < the block, so the projection binds)
PRBCD_TWINS = (("cora", 0.25), ("ogbn-arxiv", 0.05))
# the blocked SpMM on the raw adjacency PRBCD's base product runs over, at
# the surrogate's widths (hidden 64, then the class count)
PRBCD_HELD = {"cora": (64, 7), "ogbn-arxiv": (64, 40)}
HELD_BLOCK = 250_000     # the block of the split-forward check on arxiv


class AttackRecords:
    """Collects what the port logs in a run: PRBCD's statistics (the
    record's ``prbcd``) and the attacked GCN accuracies."""

    def __init__(self):
        import logging

        self.prbcd: list = []
        self.acc: list = []
        records = self

        class Handler(logging.Handler):
            def emit(self, record):
                if hasattr(record, "prbcd"):
                    records.prbcd.append(record.prbcd)
                if str(record.msg).startswith("attacked GCN accuracy"):
                    records.acc.append(float(record.args[-1]))
        self.logger = logging.getLogger("graphslim_tpu_torch")
        self.handler = Handler(level=logging.INFO)

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.handlers = list(self.logger.handlers)
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        # run_eval's get_args adds a file handler under its save_path
        for h in self.logger.handlers[:]:
            if h not in self.handlers:
                self.logger.removeHandler(h)
                h.close()
        self.logger.setLevel(self.level)


def counted(K, SB, SG, totals: dict, fn):
    """``fn()`` with every kernel's count set to 0 just before and read
    just after (added to ``totals``) → (result, seconds, launches,
    SpMM launches by width)."""
    import torch

    for mod in (K, SB, SG):
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"pge_fwd": K.LAUNCHES["pge_fwd_ws"]
                + K.LAUNCHES["pge_fwd_nows"],
                "pge_bwd": K.LAUNCHES["pge_bwd"],
                "spmm_blocked": SB.LAUNCHES["spmm_blocked"],
                "smem_gather": SG.LAUNCHES["smem_gather"]}
    for k, v in launches.items():
        totals[k] += v
    return out, secs, launches, dict(sorted(SB.LAUNCHES_BY_WIDTH.items()))


def edge_keys(G, adj):
    """Canonical (min, max) keys of an adjacency's undirected pairs."""
    import numpy as np

    ei = G.to_edge_index(adj)
    lo, hi = np.minimum(ei[0], ei[1]), np.maximum(ei[0], ei[1])
    return np.unique(lo * adj.n_rows + hi)


def held_prbcd_forward(G, ds, budget: int, stats: dict) -> None:
    """(b): the split PRBCD forward and its gradient with respect to ``p``
    against the plain gather and segment-sum version on the card at one
    fixed block of ``HELD_BLOCK`` pairs, both against the plain version in
    float64: |split − f64| ≤ 2·|plain f32 − f64| + 1e-6·max|f64| for the
    log-probabilities and the gradient.  Then the times of an epoch's
    parts (CUDA events) and of one host resampling."""
    import numpy as np
    import torch

    from graphslim_tpu_torch import utils
    from graphslim_tpu_torch.data import attack as A

    params, labels = A.train_surrogate(ds,
                                       utils.make_generator(0, ds.device))
    n = ds.n_nodes
    rng = np.random.default_rng(0)
    keys = edge_keys(G, ds.adj)
    rows, cols = A._triu_pairs(rng, n, HELD_BLOCK)
    is_edge = A._is_existing_edge(keys, rows, cols, n)
    blk = A.Block.of(rows, cols, is_edge, ds.device)
    p = torch.as_tensor(rng.random(HELD_BLOCK).astype(np.float32) * 0.5,
                        device=ds.device)
    p64 = utils.tree_map(lambda t: t.double(), params)
    blk64 = A.Block(blk.rows, blk.cols, blk.sign.double())

    def grad(fn, prm, feat, q0, b):
        with torch.enable_grad():
            q = q0.detach().requires_grad_(True)
            lp = fn(prm, ds.adj, feat, q, b)
            g, = torch.autograd.grad(A.tanh_margin_loss(lp, labels), q)
        return lp.detach(), g

    lp_s, g_s = grad(A.forward_split, params, ds.feat, p, blk)
    lp_p, g_p = grad(A.forward_plain, params, ds.feat, p, blk)
    lp_64, g_64 = grad(A.forward_plain, p64, ds.feat.double(), p.double(),
                       blk64)
    bad: list = []
    errs = {}
    for tag, s, pl, f in (("log-probabilities", lp_s, lp_p, lp_64),
                          ("gradient", g_s, g_p, g_64)):
        e_s = max_err(s.double(), f)
        e_p = max_err(pl.double(), f)
        lim = 2 * e_p + 1e-6 * float(f.abs().max())
        errs[tag] = (max_err(s, pl), e_s, e_p, float(f.abs().max()))
        if not e_s <= lim:
            bad.append(f"split PRBCD {tag}: |split - f64| {e_s:.3e} > "
                       f"{lim:.3e}")
    del lp_64, g_64, p64, blk64
    torch.cuda.empty_cache()
    if bad:
        fail("phase 15 (b): " + "; ".join(bad))
    ms = {
        "split fwd+bwd": median_ms(
            lambda: grad(A.forward_split, params, ds.feat, p, blk), 10),
        "plain fwd+bwd": median_ms(
            lambda: grad(A.forward_plain, params, ds.feat, p, blk), 5),
        "projection": median_ms(lambda: A.project(p, budget, 1e-7), 10),
        "epoch_step": median_ms(lambda: A.epoch_step(
            params, ds.adj, ds.feat, labels, p, blk, budget, 0.2, 1e-7),
            10),
    }
    p_np = p.cpu().numpy()
    t0 = time.perf_counter()
    keep = np.argsort(-p_np)[:HELD_BLOCK // 2]
    keep = keep[p_np[keep] > 1e-7]
    r2, c2 = A._triu_pairs(rng, n, HELD_BLOCK - keep.shape[0])
    e2 = A._is_existing_edge(keys, r2, c2, n)
    A.Block.of(np.concatenate([rows[keep], r2]),
               np.concatenate([cols[keep], c2]),
               np.concatenate([is_edge[keep], e2]), ds.device)
    torch.as_tensor(np.concatenate([p_np[keep], np.full(
        r2.shape[0], 1e-7, dtype=np.float32)]), device=ds.device)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    stats["prbcd_epoch"] = dict(ms, host_resample=host_ms)
    log("phase 15 (b) split PRBCD forward on the arxiv twin at one block of "
        f"{HELD_BLOCK} pairs ({int(is_edge.sum())} existing edges): "
        + "; ".join(f"{t}: |split - plain| {a:.3e}, |split - f64| {b:.3e}, "
                    f"|plain - f64| {c:.3e} (max|f64| {m:.3e})"
                    for t, (a, b, c, m) in errs.items())
        + "; device ms (CUDA events, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; one host resampling {host_ms:.1f} ms")


def run_attack(K, SB, SG, G, arxiv, tmp: str, stats: dict) -> dict:
    """Phase 15: (a) PRBCD on the cora twin at ptb_r 0.25 and (b) on the
    arxiv twin at 0.05 through ``attack`` (budget met, attacked GCN
    accuracy below the clean one; (b) also holds the split forward,
    ``held_prbcd_forward``); (c) ``random_adj`` and ``random_feat`` on
    arxiv (their caches read back equal); (d) GCond (3 epochs, SGC) and
    kcenter (GCN) on the attacked arxiv twin through ``train_all.run``,
    their triples read back by ``run_eval --attack``; (e) the
    ``saint-small`` and ``raw-ogb`` fixtures through ``load(data_dir=)``,
    kcenter on one, and ``LargeDataLoader`` on arxiv's train rows; then
    the blocked SpMM at the phase's new (graph, width) pairs.  Every run's
    launches are counted from 0; returns the phase's."""
    import numpy as np
    import torch

    from graphslim_tpu_torch import run_eval
    from graphslim_tpu_torch import train_all as TA
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import attack as A
    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.data.largeloader import LargeDataLoader
    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.reduce import create_reducer

    t_phase = time.perf_counter()
    totals = {"pge_fwd": 0, "pge_bwd": 0, "spmm_blocked": 0,
              "smem_gather": 0}
    torch.cuda.reset_peak_memory_stats()
    twins = {"ogbn-arxiv": arxiv}
    held_raw = {}

    # --- (a), (b): PRBCD ---------------------------------------------------
    attacked = {}
    for name, ptb in PRBCD_TWINS:
        if name not in twins:
            twins[name] = load(name, seed=0, device="cuda")
        ds = twins[name]
        args = finalize(Args(dataset=name, method="kcenter", seed=0,
                             attack="metattack", ptb_r=ptb, device="cuda",
                             save_path=os.path.join(tmp, "attack")))
        budget = int(ptb * ds.adj.nnz / 2)
        clean_acc = A._report_attacked_acc(ds, args)
        with AttackRecords() as rec:
            out, secs, launches, widths = counted(
                K, SB, SG, totals, lambda: A.attack(ds, args))
        st, acc = rec.prbcd[-1], rec.acc[-1]
        flips = np.setxor1d(edge_keys(G, ds.adj), edge_keys(G, out.adj))
        if not (st["budget"] == budget and 0 < st["applied"] <= budget
                and 0 < flips.shape[0] <= budget):
            fail(f"phase 15: PRBCD on {name}: budget {budget}, applied "
                 f"{st['applied']}, {flips.shape[0]} pairs flipped")
        if not acc < clean_acc:
            fail(f"phase 15: PRBCD on {name}: attacked GCN accuracy {acc:.4f}"
                 f" not below the clean {clean_acc:.4f}")
        attacked[name] = out
        tag = "(a)" if name == "cora" else "(b)"
        log(f"phase 15 {tag} PRBCD on the {name} twin at ptb_r {ptb}: "
            f"{ds.n_nodes} nodes, {ds.adj.nnz} entries, budget {budget}, "
            f"block {st['block']}; applied {st['applied']} (add "
            f"{st['add']}, remove {st['remove']}; {flips.shape[0]} pairs "
            f"flipped), best val loss {st['best_val_loss']:.4f}; seconds: "
            f"surrogate {st['surrogate_s']:.2f}, {st['epochs']} epochs "
            f"{st['epochs_s']:.2f} ({1e3 * st['epochs_s'] / st['epochs']:.1f}"
            f" ms an epoch with its host resampling), final draws "
            f"{st['final_s']:.2f}, attack() {secs:.2f} with the report GCN; "
            f"GCN accuracy clean {clean_acc:.4f}, attacked {acc:.4f}; "
            f"launches {launches}, SpMM by width {widths}")
        held_raw[name] = ds.adj
        if name == "ogbn-arxiv":
            held_prbcd_forward(G, ds, budget, stats)

    # --- (c): random_adj and random_feat on arxiv ------------------------
    for kind in ("random_adj", "random_feat"):
        args = finalize(Args(dataset="ogbn-arxiv", method="kcenter", seed=0,
                             attack=kind, device="cuda",
                             save_path=os.path.join(tmp, "attack")))
        with AttackRecords() as rec:
            out, secs, launches, _ = counted(
                K, SB, SG, totals, lambda: A.attack(arxiv, args))
        path = A._cache_path(args, arxiv)
        with np.load(path) as blob:
            back = G.host_from_edge_index(blob["edge_index"], arxiv.n_nodes)
            feat_ok = "feat" not in blob or np.array_equal(
                blob["feat"], out.feat.cpu().numpy())
        host = G.host_of(out.adj)
        if not (np.array_equal(back.row, host.row)
                and np.array_equal(back.col, host.col) and feat_ok):
            fail(f"phase 15 (c): the {kind} cache does not read back equal")
        log(f"phase 15 (c) {kind} on arxiv at ptb_r {args.ptb_r}: attack() "
            f"{secs:.2f} s with the report GCN (accuracy {rec.acc[-1]:.4f}),"
            f" {out.adj.nnz} entries, cache {os.path.getsize(path)} bytes "
            f"read back equal; launches {launches}")
        del out

    # --- (d): reducers on the attacked arxiv twin through train_all.run --
    ptb = dict(PRBCD_TWINS)["ogbn-arxiv"]
    seen: dict = {}
    real_load, create = TA.load, TA.create_reducer
    options = dict(setting="trans", split="fixed", seed=0, data_dir=None,
                   pre_norm=True, device="cuda")

    def load_twin(name, **kw):
        if name != "ogbn-arxiv" or kw != options:
            fail(f"phase 15 (d): load({name!r}, {kw})")
        return arxiv

    def create_seen(method, data, args, **kw):
        seen["data"] = data
        return create(method, data, args, **kw)

    runs = (("gcond", "SGC", dict(epochs=3, init="random",
                                  run_inter_eval=1)),
            ("kcenter", "GCN", {}))
    # the attacked twin's normalization, as gcn_norm builds it
    want_norm = G.gcn_norm(attacked["ogbn-arxiv"].adj).nnz
    TA.load, TA.create_reducer, run_eval.load = load_twin, create_seen, \
        load_twin
    try:
        for method, model, kw in runs:
            base = dict(dataset="ogbn-arxiv", method=method, seed=0,
                        attack="metattack", ptb_r=ptb, eval_model=model,
                        run_eval=1, device="cuda",
                        save_path=os.path.join(tmp, "attack"), **kw)
            args = finalize(Args(**base), explicit=set(base))
            if method == "gcond":
                args = args.replace(checkpoints=(1,))
            with AttackRecords():
                (mean, std), secs, launches, widths = counted(
                    K, SB, SG, totals, lambda: TA.run(args))
            data = seen["data"]
            if not (data.adj.nnz == attacked["ogbn-arxiv"].adj.nnz
                    and data.adj_norm().nnz == want_norm
                    != arxiv.adj_norm().nnz):
                fail(f"phase 15 (d) {method}: the reducer did not read the "
                     f"attacked graph ({data.adj.nnz} entries, adj_norm() "
                     f"{data.adj_norm().nnz})")
            triple = os.path.join(tmp, "attack", "corrupt_graph",
                                  "metattack", "reduced_graph", method,
                                  f"ogbn-arxiv_{args.reduction_rate}_0.npz")
            argv = ["-D", "ogbn-arxiv", "-M", method, "-S", "0", "-A",
                    "metattack", "-P", str(ptb), "--save_path",
                    os.path.join(tmp, "attack"), "--run_eval", "1",
                    "--eval_model", model]
            with AttackRecords():
                (rmean, _), rsecs, rlaunches, _ = counted(
                    K, SB, SG, totals, lambda: run_eval.main(argv))
            if not (os.path.exists(triple) and math.isfinite(mean)
                    and math.isfinite(rmean)):
                fail(f"phase 15 (d) {method}: triple {triple} "
                     f"{os.path.exists(triple)}, scores {mean}, {rmean}")
            seen["widths"] = seen.get("widths", set()) | set(widths)
            log(f"phase 15 (d) {method} / {model} on the attacked arxiv twin "
                f"(train_all.run, the cached attack read back; adj_norm() "
                f"{data.adj_norm().nnz} entries against the clean "
                f"{arxiv.adj_norm().nnz}): {secs:.2f} s, {mean:.4f} ± "
                f"{std:.4f}, launches {launches}, SpMM by width {widths}; "
                f"run_eval --attack read {os.path.relpath(triple, tmp)}: "
                f"{rmean:.4f} on the clean twin, {rsecs:.2f} s, launches "
                f"{rlaunches}")
    finally:
        TA.load, TA.create_reducer, run_eval.load = real_load, create, \
            real_load
    att = seen.pop("data")

    # --- (e): dataset files and the large loader -------------------------
    fixtures = os.path.join(HERE, "tests", "fixtures")
    for name, sub in (("synth-small", "saint-small"),
                      ("ogbn-products", "raw-ogb")):
        t0 = time.perf_counter()
        fds = load(name, seed=0, data_dir=os.path.join(fixtures, sub),
                   device="cuda")
        log(f"phase 15 (e) {sub}: load(data_dir=) {name}: {fds.n_nodes} "
            f"nodes, {fds.adj.nnz} entries, {fds.nclass} classes, train "
            f"{len(fds.idx_train)}, {time.perf_counter() - t0:.2f} s")
        if name == "synth-small":
            kargs = finalize(Args(dataset=name, method="kcenter", seed=0,
                                  run_eval=1, device="cuda",
                                  save_path=os.path.join(tmp, "files")),
                             explicit={"run_eval"})

            def reduce_eval():
                red = create_reducer("kcenter", fds, kargs).reduce(fds)
                return red, Evaluator(fds, kargs).evaluate(red, "GCN")[0]
            (red, (mean, _)), secs, launches, _ = counted(
                K, SB, SG, totals, reduce_eval)
            if not (red.n_syn > 0 and mean > 0.5):
                fail(f"phase 15 (e): kcenter on {sub}: n_syn {red.n_syn}, "
                     f"GCN {mean}")
            log(f"phase 15 (e) kcenter / GCN on {sub}: n_syn {red.n_syn}, "
                f"{mean:.4f}, {secs:.2f} s, launches {launches}")
    loaders = {}
    for split_method in ("mod", "kmeans"):
        loaders[split_method], secs, launches, widths = counted(
            K, SB, SG, totals, lambda: LargeDataLoader(
                arxiv, batch_size=3000, split_method=split_method,
                gcf_hops=2))
        loaders[split_method + " s"] = secs
        if widths != {arxiv.n_feat: 2}:
            fail(f"phase 15 (e): the GCF hops launched {widths}")
    big = loaders["kmeans"]
    sizes = [b.size for b in big.batches]
    x, y, a = big.get_batch(0)
    if not (big.n_batch > 1 and torch.isfinite(big.feat).all()
            and a.shape == (x.shape[0],) * 2):
        fail(f"phase 15 (e): LargeDataLoader {big.n_batch} batches")
    log(f"phase 15 (e) LargeDataLoader on arxiv's {big.feat.shape[0]} train "
        f"rows (batch 3000, gcf_hops 2): {big.n_batch} k-means batches of "
        f"{min(sizes)}-{max(sizes)} rows; standardize + GCF hops (2 SpMM "
        f"launches at d = {arxiv.n_feat}) {loaders['mod s']:.2f} s, with "
        f"the k-means "
        f"{loaders['kmeans s']:.2f} s (k-means "
        f"{loaders['kmeans s'] - loaders['mod s']:.2f} s); get_batch(0) "
        f"{tuple(a.shape)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # --- the blocked SpMM at the phase's new (graph, width) pairs ---------
    for name, adj in held_raw.items():
        compare_spmm_reduced(SB, G, f"{name} raw A (PRBCD's base)", adj,
                             PRBCD_HELD[name], stats, normalized=True)
    compare_spmm_reduced(SB, G, "attacked arxiv Â", att.adj_norm(),
                         sorted(seen["widths"]), stats, normalized=True)
    compare_spmm_reduced(SB, G, "arxiv train subgraph's Â", big.adj,
                         (arxiv.n_feat,), stats)
    del big, loaders, att, attacked
    torch.cuda.empty_cache()
    log(f"phase 15: launches {totals}, peak {peak:.2f} GiB, "
        f"{time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# Phase 16: the rest of evaluation, compat, visualization, tracking and
# profiling
# ---------------------------------------------------------------------------

ARTIFACT = os.path.join("benchmark", "artifacts", "arxiv_gcond_r0.01.npz")
# the depth of NAS's trainings: 300 epochs (the evaluator's) cut to 100 to
# keep the whole smoke inside its time limit (PERF.md §6)
NAS_EPOCHS = 100
# the arxiv Â's widths that phases 7 and 14 hold
ARXIV_HELD = {128, 256, 40, 129, 64, 192} | set(ZOO_HELD["arxiv"])
PROFILED_KERNELS = ("pge_fwd_kernel", "pge_bwd_kernel", "spmm_blocked_kernel")


def run_analysis(K, SB, SG, G, ds, tmp: str, stats: dict) -> dict:
    """Phase 16 on the arxiv twin ``ds`` and the shipped artifact: (a) NAS
    over ``QUICK_SPACE``, (b) the confidence MIA, (c) graph properties and
    kcenter on the cora twin through ``train_all.run --wandb``, (d) t-SNE
    and the graph pair, (e) ``compat`` round trips, (f) ``train_all.run
    --profile --wandb`` of GCond and ``Throughput``; then the blocked SpMM
    at the widths of this phase no earlier phase holds.  Returns each
    kernel's launches over the runs (counted from 0 before each)."""
    import glob
    import importlib.util
    import logging

    import numpy as np
    import torch

    from graphslim_tpu_torch import compat, utils
    from graphslim_tpu_torch import models as M
    from graphslim_tpu_torch import train_all as TA
    from graphslim_tpu_torch import visualization as V
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load, read_npz
    from graphslim_tpu_torch.eval import (Evaluator, NasEvaluator,
                                          PropertyEvaluator, mia_attack)
    from graphslim_tpu_torch.eval.nas import QUICK_SPACE
    from graphslim_tpu_torch.profiling import Throughput
    from graphslim_tpu_torch.tracking import NullTracker

    dev = ds.device
    t_phase = time.perf_counter()
    totals = {"pge_fwd": 0, "pge_bwd": 0, "spmm_blocked": 0,
              "smem_gather": 0}
    widths = {"arxiv": set(), "cora": set()}

    def add(launches: dict, graph: str) -> dict:
        for k, v in launches.items():
            if k.startswith("pge_fwd"):
                totals["pge_fwd"] += v
            elif k == "pge_bwd":
                totals["pge_bwd"] += v
            elif k == "gather":
                totals["smem_gather"] += v
            else:
                totals["spmm_blocked"] += v
                widths[graph].add(int(k.split("=")[1]))
        return launches

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    art = read_npz(os.path.join(HERE, ARTIFACT), device=dev)
    args = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                         eval_epochs=300, save_path=tmp, device=dev.type),
                    explicit={"eval_epochs"})
    val_labels = ds.labels.cpu().numpy()[ds.idx_val]
    majority = float(np.bincount(val_labels).max() / val_labels.shape[0])

    # --- (a) NAS over the quick space --------------------------------------
    nas = NasEvaluator(ds, args.replace(eval_epochs=NAS_EPOCHS),
                       space=QUICK_SPACE)
    secs, accs = {}, {}
    for side in ("ori", "syn"):
        fn = getattr(nas, f"evaluate_{side}")

        def timed(*a, _fn=fn, _side=side):
            sync()
            t0 = time.perf_counter()
            out = _fn(*a)
            sync()
            secs[_side] = time.perf_counter() - t0
            accs[_side] = out
            return out
        setattr(nas, f"evaluate_{side}", timed)
    count = Launches(K, SB, SG)
    res = nas.correlation(art)
    nas_l = add(count.since(), "arxiv")
    ori = accs["ori"]
    if len(ori) != 16 or not (np.isfinite(ori).all()
                              and (ori > majority).all()):
        fail(f"NAS: original-graph accuracies {ori} not finite or not all "
             f"above the validation split's largest class {majority:.4f}")
    if not np.isfinite(accs["syn"]).all():
        fail(f"NAS: reduced-graph accuracies {accs['syn']}")
    log(f"analysis (a) NAS over QUICK_SPACE (16 APPNP architectures, "
        f"{NAS_EPOCHS} epochs each, a side): original graph {secs['ori']:.2f} s "
        f"(accuracies {np.round(ori, 4).tolist()}, all above the val "
        f"split's largest class {majority:.4f}), artifact "
        f"{secs['syn']:.2f} s (accuracies "
        f"{np.round(accs['syn'], 4).tolist()}); pearson_acc "
        f"{res['pearson_acc']:.4f}, pearson_rank {res['pearson_rank']:.4f}, "
        f"best_ori {res['best_ori']}, best_syn {res['best_syn']}; launches "
        f"{nas_l}")

    # --- (b) the confidence MIA on an SGC and a GCN fitted on the artifact
    ev = Evaluator(ds, args)
    parts = []
    for mt in ("SGC", "GCN"):
        model = ev._eval_model(mt, art.feat.shape[1])
        tx, tadj, ty = ev._train_tuple(art, mt)
        count = Launches(K, SB, SG)
        sync()
        t0 = time.perf_counter()
        params, best_val, _ = M.fit_with_val(
            model, utils.make_generator(0, dev), train=(tx, tadj, ty, None),
            val=ds.split_batch("val"),
            cfg=M.TrainConfig(epochs=args.eval_epochs, lr=0.01))
        sync()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        mia = mia_attack(model, params, ds)
        t_mia = time.perf_counter() - t0
        launched = add(count.since(), "arxiv")
        if not 0.5 <= mia <= 1.0:
            fail(f"MIA on {mt}: {mia} outside [0.5, 1]")
        parts.append(f"{mt}: fit {t_fit:.2f} s (best val "
                     f"{float(best_val):.4f}), mia_attack {mia:.4f} in "
                     f"{t_mia:.3f} s, launches {launched}")
    log("analysis (b) MIA on the artifact's models: " + "; ".join(parts))

    # --- (c) properties; kcenter on cora through train_all.run --wandb ----
    t0 = time.perf_counter()
    props = PropertyEvaluator(ds, args).properties(art.adj, art.feat,
                                                   art.labels)
    t_props = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in props.values()):
        fail(f"artifact properties not finite: {props}")
    cora = load("cora", seed=0, device=dev)
    real = (TA.load, TA.create_reducer, TA.build_tracker)
    seen: dict = {}
    warned: list = []

    class Warned(logging.Handler):
        def emit(self, record):
            if "wandb unavailable" in record.getMessage():
                warned.append(record.getMessage())

    def load_loaded(name, **kw):
        return {"cora": cora, "ogbn-arxiv": ds}[name]

    def create_seen(method, data, a, **kw):
        agent = real[1](method, data, a, **kw)
        reduce = agent.reduce

        def seen_reduce(*x, **k):
            seen["reduced"] = reduce(*x, **k)
            return seen["reduced"]
        agent.reduce = seen_reduce
        return agent

    def tracker_seen(a):
        tracker = real[2](a)
        seen["tracker"], seen["graphs"] = tracker, {}
        log_graph = tracker.log_graph

        def logged(name, summary):
            seen["graphs"][name] = summary
            log_graph(name, summary)
        tracker.log_graph = logged
        return tracker

    handler = Warned()
    logging.getLogger("graphslim_tpu_torch").addHandler(handler)
    # no network here: WandB's import is blocked, so the tracker falls
    # back to NullTracker with its warning, as without the package
    wandb_mod = sys.modules.get("wandb")
    sys.modules["wandb"] = None
    TA.load, TA.create_reducer, TA.build_tracker = (load_loaded, create_seen,
                                                    tracker_seen)

    def tracked(tag: str, red) -> str:
        graphs = seen["graphs"]
        want = TA.reduced_edges(red)
        if not isinstance(seen["tracker"], NullTracker) or not warned:
            fail(f"{tag}: tracker {type(seen['tracker']).__name__}, "
                 f"warnings {warned}")
        if graphs["reduced"]["edges"] != want or \
                graphs["reduced"]["nodes"] != red.n_syn:
            fail(f"{tag}: tracked reduced graph {graphs['reduced']}, "
                 f"expected {red.n_syn} nodes, {want} edges")
        return (f"NullTracker (warned), original {graphs['original']}, "
                f"reduced {graphs['reduced']}")

    try:
        kargs = finalize(Args(dataset="cora", method="kcenter",
                              reduction_rate=0.5, run_eval=1,
                              eval_epochs=300, wandb=True,
                              save_path=os.path.join(tmp, "kcenter"),
                              device=dev.type),
                         explicit={"reduction_rate", "run_eval",
                                   "eval_epochs", "wandb"})
        count = Launches(K, SB, SG)
        t0 = time.perf_counter()
        k_mean, _ = TA.run(kargs)
        t_k = time.perf_counter() - t0
        k_l = add(count.since(), "cora")
        red = seen["reduced"]
        if red.adj is not None and int((red.dense_adj() != 0).sum()) != \
                TA.reduced_edges(red):
            fail("kcenter cora: the reduced edge count differs from the "
                 "dense adjacency's nonzeros")
        k_track = tracked("kcenter cora", red)
        t0 = time.perf_counter()
        cmp = PropertyEvaluator(cora, kargs).compare(red)
        t_cmp = time.perf_counter() - t0
        for side in ("original", "reduced"):
            if not all(math.isfinite(v) for v in cmp[side].values()):
                fail(f"cora compare: {side} {cmp[side]}")
        log(f"analysis (c) PropertyEvaluator.properties of the artifact "
            f"(1354 nodes, dense) {t_props:.2f} s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in props.items())
            + f"; kcenter cora r=0.5 through train_all.run --wandb "
            f"{t_k:.2f} s (GCN 1 seed {k_mean:.4f}, launches {k_l}; "
            f"{k_track}); compare on the cora twin ({cora.n_nodes} nodes) "
            f"{t_cmp:.2f} s: original "
            + ", ".join(f"{k} {v:.4f}" for k, v in cmp["original"].items())
            + "; reduced "
            + ", ".join(f"{k} {v:.4f}" for k, v in cmp["reduced"].items()))

        # --- (d) t-SNE and the graph pair --------------------------------
        if all(importlib.util.find_spec(m) is not None
               for m in ("matplotlib", "sklearn")):
            t0 = time.perf_counter()
            png = ev.tsne_vis(art, os.path.join(tmp, "tsne.png"),
                              max_real=2000)
            t_tsne = time.perf_counter() - t0
            t0 = time.perf_counter()
            pair = V.draw_graph_pair(ds, art, os.path.join(tmp, "pair.png"))
            t_pair = time.perf_counter() - t0
            for path in (png, pair):
                if os.path.getsize(path) <= 1024:
                    fail(f"{path}: {os.path.getsize(path)} bytes")
            log(f"analysis (d) tsne_vis (2000 real rows + 1354) {t_tsne:.2f}"
                f" s, {os.path.getsize(png)} bytes; draw_graph_pair "
                f"{t_pair:.2f} s, {os.path.getsize(pair)} bytes")
        else:
            t0 = time.perf_counter()
            g_ori, _ = V._to_networkx(ds.adj, ds.labels)
            g_art, _ = V._to_networkx(art.adj, art.labels)
            t_nx = time.perf_counter() - t0
            log(f"analysis (d) matplotlib / scikit-learn not installed on "
                f"this machine: no t-SNE or graph-pair PNG; the pair's "
                f"networkx graphs (arxiv twin {g_ori.number_of_nodes()} "
                f"nodes / {g_ori.number_of_edges()} edges, artifact "
                f"{g_art.number_of_nodes()} / {g_art.number_of_edges()}) "
                f"{t_nx:.2f} s")

        # --- (e) compat round trips --------------------------------------
        t0 = time.perf_counter()
        blob = compat.to_torch(ds)
        t_to = time.perf_counter() - t0
        t0 = time.perf_counter()
        feat2, adj2, labels2 = compat.from_torch(
            blob["x"], blob["edge_index"], blob["y"], blob["edge_weight"],
            device=dev)
        sync()
        t_from = time.perf_counter() - t0
        h, h2 = G.host_of(ds.adj), G.host_of(adj2)
        r = int(np.argmax(np.diff(h.indptr)))      # the heaviest row
        a, b = h.indptr[r], h.indptr[r + 1]
        a2, b2 = h2.indptr[r], h2.indptr[r + 1]
        if adj2.nnz != ds.adj.nnz or not (
                np.array_equal(h.col[a:b], h2.col[a2:b2])
                and np.array_equal(h.values_or_ones()[a:b],
                                   h2.values_or_ones()[a2:b2])
                and torch.equal(feat2[r], ds.feat[r])
                and torch.equal(labels2, ds.labels)):
            fail(f"to_torch / from_torch of the arxiv twin: {adj2.nnz} "
                 f"entries against {ds.adj.nnz}, or row {r} differs")
        t0 = time.perf_counter()
        compat.save_reference_layout(art, os.path.join(tmp, "ref"), "gcond",
                                     "ogbn-arxiv", 0.01)
        back = compat.load_reference_reduced(os.path.join(tmp, "ref"),
                                             "gcond", "ogbn-arxiv", 0.01,
                                             device=dev)
        t_ref = time.perf_counter() - t0
        if not (torch.equal(back.adj, art.adj)
                and torch.equal(back.labels, art.labels.long())):
            fail("save_reference_layout / load_reference_reduced of the "
                 "artifact: the graph read back differs")
        log(f"analysis (e) to_torch of the arxiv twin {t_to:.2f} s "
            f"({blob['edge_index'].shape[1]} entries), from_torch "
            f"{t_from:.2f} s (the same entry count; row {r}, {b - a} "
            f"entries, equal); reference layout round trip of the artifact "
            f"{t_ref:.2f} s, equal")

        # --- (f) train_all.run --profile --wandb of GCond ------------------
        warned.clear()
        save_f = os.path.join(tmp, "gcond")
        fargs = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                              epochs=1, eval_model="SGC", run_eval=1,
                              eval_epochs=300, profile=True, wandb=True,
                              save_path=save_f, device=dev.type),
                         explicit={"epochs", "eval_model", "run_eval",
                                   "eval_epochs", "profile", "wandb"})
        # one checkpoint evaluation (one quick training) inside the trace
        fargs = fargs.replace(checkpoints=(0,), run_inter_eval=1)
        count = Launches(K, SB, SG)
        t0 = time.perf_counter()
        g_mean, _ = TA.run(fargs)
        t_g = time.perf_counter() - t0
        g_l = add(count.since(), "arxiv")
        g_track = tracked("gcond arxiv", seen["reduced"])
    finally:
        TA.load, TA.create_reducer, TA.build_tracker = real
        logging.getLogger("graphslim_tpu_torch").removeHandler(handler)
        if wandb_mod is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = wandb_mod
    traces = glob.glob(os.path.join(save_f, "traces", "gcond_ogbn-arxiv",
                                    "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--profile wrote {traces}")
    with open(traces[0]) as f:
        text = f.read()
    missing = [k for k in PROFILED_KERNELS if k not in text]
    if missing:
        fail(f"the --profile trace names none of {missing}")
    log(f"analysis (f) train_all.run --profile --wandb: GCond 1 epoch (20 "
        f"outer steps, one checkpoint evaluation) + SGC 1 seed on arxiv "
        f"{t_g:.2f} s, accuracy {g_mean:.4f}, launches {g_l}; trace "
        f"{os.path.basename(traces[0])} {len(text) / 2 ** 20:.1f} MiB names "
        + ", ".join(PROFILED_KERNELS) + f"; {g_track}")

    adj = ds.adj_norm()
    layout = adj.blocked()
    x = torch.randn(adj.n_rows, 128, device=dev,
                    generator=torch.Generator(dev).manual_seed(16))
    SB.spmm_blocked(layout, x)
    tp = Throughput(adj.nnz, device=dev)
    for _ in range(20):
        with tp.measure():
            SB.spmm_blocked(layout, x)
    log(f"analysis (f) Throughput of the blocked SpMM on the arxiv Â "
        f"({adj.nnz} entries) at d = 128: {tp.per_second / 1e9:.4f} G "
        f"edges/s ({tp.report()}; {1e3 * tp.elapsed / tp.calls:.4f} ms a "
        f"call with its two synchronizations, beside PERF.md's 0.5644 ms "
        f"of launches queued back to back)")

    # --- the SpMM at the widths no earlier phase holds ----------------------
    new = {"arxiv twin": (ds, sorted(widths["arxiv"] - ARXIV_HELD)),
           "cora twin": (cora, sorted(widths["cora"]))}
    for tag, (data, ws) in new.items():
        if ws:
            compare_spmm_reduced(SB, G, tag, data.adj_norm(), ws, stats,
                                 normalized=True)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{totals}; SpMM widths: arxiv {sorted(widths['arxiv'])} (held "
        f"here: {new['arxiv twin'][1]}), cora {sorted(widths['cora'])}")
    return totals


# ---------------------------------------------------------------------------
# Phase 17: the distributed layer at world size 1
# ---------------------------------------------------------------------------

DIST_SHARDS = (4, 8)
DIST_WIDTHS = (128, 40)
REDDIT_ART = os.path.join("benchmark", "artifacts",
                          "reddit_dist_gcondx_r0.001.npz")
REDDIT_FLOOR = 0.9569    # the random coreset's SGC accuracy on the twin


def dist_tables(G, adj, stats: dict) -> dict:
    """(a): the edge-cut order and the ragged halo tables of the arxiv
    twin's Â at each shard count, built twice (equal), timed on the host,
    with the parts' balance, the cut and the exchanged halo rows."""
    import numpy as np

    from graphslim_tpu_torch import native
    from graphslim_tpu_torch.dist import spmm as D

    h = G.host_of(adj)
    n, nnz = h.n_rows, h.row.shape[0]
    t0 = time.perf_counter()
    native.load()
    log(f"dist (a) native host library (g++ at first use, "
        f"build/native/): {time.perf_counter() - t0:.2f} s")
    out = {}
    for S in DIST_SHARDS:
        t0 = time.perf_counter()
        order = D.edge_cut_order(h, S)
        t_order = time.perf_counter() - t0
        t0 = time.perf_counter()
        hp = D.partition_rows_halo_ragged(D.reorder_adj(h, order), S)
        t_tables = time.perf_counter() - t0
        # the second build, from the partitioner's own output (its part
        # ids and cut give the balance and the cut share)
        part, cut = native.partition_graph(h.indptr, h.col, S, 0.02, 10)
        again_order = np.argsort(part, kind="stable")
        again = D.partition_rows_halo_ragged(D.reorder_adj(h, again_order),
                                             S)
        if not np.array_equal(order, again_order):
            fail(f"dist (a) S={S}: two builds give different orders")
        for f in ("send_flat", "in_offsets", "send_sizes", "row_int",
                  "col_int", "val_int", "row_bnd", "col_bnd", "val_bnd"):
            if not np.array_equal(getattr(hp, f), getattr(again, f)):
                fail(f"dist (a) S={S}: two builds differ in {f}")
        sizes = np.bincount(part, minlength=S)
        halo = int(hp.send_sizes.sum())
        log(f"dist (a) arxiv Â S={S}: edge-cut order {t_order:.2f} s, "
            f"reorder + ragged tables {t_tables:.2f} s (host); parts "
            f"{sizes.min()}-{sizes.max()} rows (largest / mean "
            f"{sizes.max() * S / n:.4f}); cut {cut} of {nnz} entries "
            f"({cut / nnz:.4f}); exchanged halo rows {halo} "
            f"({halo / n:.4f} of n); interior entries "
            f"{int(hp.n_int.sum())}, boundary {int(hp.n_bnd.sum())}; "
            f"receive buffer {hp.recv_len} rows, rounds {hp.round_max}")
        stats[f"dist_tables_s{S}"] = t_order + t_tables
        out[S] = (order, hp)
    return out


def dist_products(SB, adj, tables: dict, stats: dict) -> None:
    """(b): every shard's products on the card in one process, through the
    port's ``RankPlan``: each owner's send buffer (``send_rows``, the
    gather kernel) placed in the receive buffer round by round as the
    exchange delivers it (``rounds``), then ``product``, the interior
    (square) and boundary (rectangular) blocked SpMMs that
    ``shard_spmm_halo_ragged`` runs; the shards stacked and permuted back,
    against the one-card blocked SpMM over Â, its plain version and
    float64 (phase 7's tolerances); each shard's ms beside its bound."""
    import numpy as np
    import torch

    from graphslim_tpu_torch.dist import spmm as D
    from graphslim_tpu_torch.kernels.spmm import spmm_plain

    n = adj.n_rows
    layout = adj.blocked()
    vals = adj.values_or_ones().double()
    gen = torch.Generator(device="cuda").manual_seed(17)
    bad: list = []
    for d in DIST_WIDTHS:
        x = torch.randn(n, d, generator=gen, device="cuda")
        one = SB.spmm_blocked(layout, x)
        plain = SB.spmm_blocked_plain(layout, x)
        f64 = spmm_plain(adj.row, adj.col, vals, x.double(), n)
        for S, (order, hp) in tables.items():
            rows_per = hp.base.rows_per_shard
            xo = x[torch.as_tensor(order, device="cuda")]
            xo = torch.cat([xo, xo.new_zeros((S * rows_per - n, d))])
            blocks = [xo[s * rows_per:(s + 1) * rows_per] for s in range(S)]
            plans = [D.rank_plan(hp, s, torch.device("cuda"))
                     for s in range(S)]
            # what each rank sends (the gather kernel), then what the
            # rounds deliver: in round r, rank src's chunk for
            # (src + r) mod S lands at that rank's round-r offset
            sends = [p.send_rows(b) for p, b in zip(plans, blocks)]
            outs, times = [], []
            for s, plan in enumerate(plans):
                recv = plan.new_recv(d, False, xo)
                for r, (_, _, src, (lo, hi)) in enumerate(plan.rounds()):
                    dst, (so, se), _, _ = plans[src].rounds()[r]
                    if dst != s or se - so != hi - lo:
                        fail(f"dist (b) S={S}: round {r + 1} of shard {src} "
                             f"does not feed shard {s}")
                    recv[lo:hi] = sends[src][so:se]

                def shard(s=s, plan=plan, recv=recv):
                    return plan.product(blocks[s], recv, False)

                outs.append(shard())
                ms = median_ms(shard, 10, 1)
                b_int = spmm_bound(plan.interior.nnz, rows_per, rows_per,
                                   d)[0]
                b_bnd = spmm_bound(plan.n_bnd, rows_per, hp.recv_len,
                                   d)[0] if plan.n_bnd else 0.0
                times.append((ms, b_int + b_bnd, plan.interior.nnz,
                              plan.n_bnd))
            got = torch.cat(outs)[torch.as_tensor(
                np.argsort(order), device="cuda")]
            tag = f"dist (b) S={S} d={d}"
            err = check_close(f"{tag} vs one card", got, one, TOL_SPMM, bad,
                              f64)
            check_close(f"{tag} vs plain", got, plain, TOL_SPMM, bad, f64)
            check_close(f"{tag} vs float64", got.double(), f64, TOL_SPMM,
                        bad)
            log(f"{tag}: max|Δ| vs one card {err:.2e}; shards (ms / bound "
                f"ms, interior / boundary entries): " + "; ".join(
                    f"{ms:.4f} / {b:.4f} ({ni} / {nb})"
                    for ms, b, ni, nb in times))
            stats[f"dist_b_s{S}_d{d}"] = times
            del xo, blocks, sends, outs, got
        del x, one, plain, f64
        torch.cuda.empty_cache()
    if bad:
        fail("sharded products disagree:\n  " + "\n  ".join(bad))


def dist_gcond(K, SB, SG, ds, tmp: str, totals: dict) -> None:
    """(c): GCond on the arxiv twin with the matching sharded over a mesh
    of one rank (NCCL), both feature modes: the first outer step's loss
    against the unsharded engine's from the same generator state; one
    PGE forward keeping the workspace and one backward an outer step."""
    import torch

    from graphslim_tpu_torch import utils
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.reduce import create_reducer

    for mode in ("replicated", "sharded"):
        args = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                             init="random", epochs=2, save_path=tmp,
                             device="cuda"), explicit={"epochs"})
        args = args.replace(checkpoints=())
        eng = create_reducer("gcond", ds, args)
        if (eng.n_syn, args.hidden, eng.pge.cfg.nhid) != (1354, 256, 256):
            fail("dist (c): not the full width")
        feat = eng.init_feat_syn().requires_grad_(True)
        pge = utils.trainable(eng.pge.init(utils.make_generator(1, "cuda")))
        mp = eng.model.init(utils.make_generator(2, "cuda"))
        losses = []
        for shard in (False, True):
            if shard:
                eng.enable_distributed(1, feature_mode=mode)
            with torch.no_grad():
                adj = eng.syn_adj_norm(pge, feat)
                losses.append(float(eng.match_loss_total(
                    mp, feat, adj, utils.make_generator(7, "cuda"))))
        rel = abs(losses[1] - losses[0]) / abs(losses[0])
        if not rel <= 1e-5:
            fail(f"dist (c) {mode}: sharded loss {losses[1]} vs unsharded "
                 f"{losses[0]} ({rel:.2e} relative)")
        red, secs, launches, widths = counted(
            K, SB, SG, totals, lambda: eng.reduce(ds))
        outer = args.epochs * args.outer_loop
        # no-grad forwards: every outer step's inner_adj and the end's
        # inference_adj (no checkpoint)
        pge_rule(dict(K.LAUNCHES), outer, outer + 1)
        if not torch.isfinite(red.feat).all():
            fail(f"dist (c) {mode}: non-finite condensed features")
        log(f"dist (c) gcond arxiv, matching sharded over 1 rank (NCCL), "
            f"features {mode}: first loss {losses[1]:.6f} (unsharded "
            f"{losses[0]:.6f}, {rel:.1e} relative); {outer} outer steps "
            f"in {secs:.2f} s; launches {launches}, SpMM by width {widths}")
        del eng, red
        torch.cuda.empty_cache()


def dist_evaluator(K, SB, SG, G, ds, totals: dict, reddit=None) -> None:
    """(d): the evaluator's mesh path at world size 1 against the local
    one: SGC on the arxiv artifact (3 seeds × 300 epochs; ≥ 0.80), one
    GCN fit (validation in the loop), and the reddit gcondx artifact on
    the reddit twin with its val and test subgraphs sharded (SGC, 3
    seeds; ≥ the random coreset's 0.9569); each within two test nodes of
    the local result.  ``reddit``: the twin phase 12 loaded, else it is
    loaded here."""
    import torch

    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import read_npz
    from graphslim_tpu_torch.dist import make_mesh
    from graphslim_tpu_torch.eval import Evaluator

    mesh = make_mesh(1, device="cuda")
    runs = [("arxiv", ds, os.path.join(HERE, ARTIFACT), "SGC", 3, 0.80),
            ("arxiv", ds, os.path.join(HERE, ARTIFACT), "GCN", 1, None)]
    if reddit is None:
        reddit, _ = load_ind_twin("reddit")
    runs.append(("reddit", reddit, os.path.join(HERE, REDDIT_ART), "SGC",
                 3, REDDIT_FLOOR))
    for name, data, path, mt, seeds, floor in runs:
        args = finalize(Args(dataset=data.name, method="gcond",
                             run_eval=seeds, eval_epochs=300,
                             device="cuda"),
                        explicit={"run_eval", "eval_epochs"})
        art = read_npz(path, device="cuda")
        t0 = time.perf_counter()
        (acc0, _), _ = Evaluator(data, args).evaluate(art, mt)
        t_local = time.perf_counter() - t0
        ev = Evaluator(data, args)
        t0 = time.perf_counter()
        ev.enable_distributed(mesh)
        t_part = time.perf_counter() - t0
        ((acc, std), _), secs, launches, widths = counted(
            K, SB, SG, totals, lambda: ev.evaluate(art, mt))
        n_test = (data.labels_test.shape[0] if data.setting == "ind"
                  else len(data.idx_test))
        if sorted(ev._dist) != ["test", "val"]:
            fail(f"dist (d) {name}: sharded splits {sorted(ev._dist)}")
        if not abs(acc - acc0) <= 2.0 / n_test + 1e-6:
            fail(f"dist (d) {name} {mt}: mesh {acc:.4f} vs local "
                 f"{acc0:.4f}")
        if floor is not None and not acc >= floor:
            fail(f"dist (d) {name} {mt}: {acc:.4f} < {floor}")
        log(f"dist (d) {name} {mt} {seeds} seed(s) x 300 epochs on the "
            f"mesh of 1: {acc:.4f} ± {std:.4f} (local {acc0:.4f}, "
            f"{t_local:.2f} s); partition {t_part:.2f} s, evaluate "
            f"{secs:.2f} s; launches {launches}, SpMM by width {widths}")
        del ev, art
        torch.cuda.empty_cache()
    del reddit
    torch.cuda.empty_cache()


def run_dist(K, SB, SG, G, ds, tmp: str, stats: dict,
             reddit=None) -> dict:
    """Phase 17 → its launches on the main path ((c) and (d)); ``reddit``
    is the twin phase 12 kept loaded, if it ran."""
    import torch

    import torch.distributed as tdist

    t0 = time.perf_counter()
    totals = {"pge_fwd": 0, "pge_bwd": 0, "spmm_blocked": 0,
              "smem_gather": 0}
    try:
        adj = ds.adj_norm()
        tables = dist_tables(G, adj, stats)
        dist_products(SB, adj, tables, stats)
        del tables
        dist_gcond(K, SB, SG, ds, tmp, totals)
        dist_evaluator(K, SB, SG, G, ds, totals, reddit)
        reddit = None
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    torch.cuda.synchronize()
    log(f"dist: phase 17 {time.perf_counter() - t0:.1f} s; launches "
        f"(c) + (d) {totals}")
    return totals


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels", "condense", "cluster",
                                       "distill", "ind", "coarsen", "zoo",
                                       "attack", "analysis", "dist"],
                    default=None)
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "graphslim_tpu_torch")):
        fail("graphslim_tpu_torch/ not found beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    os.environ.setdefault("GRAPHSLIM_TORCH_CACHE",
                          os.path.join(HERE, "build", "cache"))
    from graphslim_tpu_torch import graph as G
    from graphslim_tpu_torch.kernels import build as B
    from graphslim_tpu_torch.kernels import edge_scorer as ES
    from graphslim_tpu_torch.kernels import pge as K
    from graphslim_tpu_torch.kernels import smem_gather as SG
    from graphslim_tpu_torch.kernels import spmm_blocked as SB

    # --- phase 1 ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    t_start = time.perf_counter()
    t_last = [t_start]

    def lap(name: str) -> None:
        """One line of wall seconds a part of the full run, and so far."""
        now = time.perf_counter()
        log(f"wall: {name} {now - t_last[0]:.1f} s, smoke so far "
            f"{now - t_start:.1f} s")
        t_last[0] = now

    t0 = time.perf_counter()
    B.prebuild()
    build_s = time.perf_counter() - t0
    for mod in (K, SB, SG, ES):
        mod.build()
        report = [ln.strip() for ln in mod.BUILD_INFO["report"].splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"build: {mod.BUILD_INFO['seconds']:.1f} s nvcc -> "
            f"{os.path.relpath(mod.BUILD_INFO['path'], HERE)}; ptxas: "
            + " | ".join(report))
    log(f"build: {len(B.LIBRARIES)} libraries in parallel, {build_s:.1f} s")

    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load, read_npz
    from graphslim_tpu_torch.eval import Evaluator

    if opts.only == "ind":
        with tempfile.TemporaryDirectory() as tmp:
            run_ind(K, SB, SG, tmp, {})
        log_windows()
        return
    t0 = time.perf_counter()
    ds = load("ogbn-arxiv", seed=0, device="cuda")
    log(f"load ogbn-arxiv twin: {ds.n_nodes} nodes, {ds.adj.nnz} edges, "
        f"{time.perf_counter() - t0:.1f} s")
    if opts.only in ("condense", "cluster", "distill", "coarsen", "zoo",
                     "attack", "analysis", "dist"):
        with tempfile.TemporaryDirectory() as tmp:
            if opts.only == "dist":
                run_dist(K, SB, SG, G, ds, tmp, {})
            elif opts.only == "analysis":
                run_analysis(K, SB, SG, G, ds, tmp, {})
            elif opts.only == "attack":
                run_attack(K, SB, SG, G, ds, tmp, {})
            elif opts.only == "zoo":
                run_zoo(SB, SG, G, ds, tmp, {})
            elif opts.only == "coarsen":
                run_coarsen(SB, G, ds, tmp, {})
            elif opts.only == "condense":
                run_condensers(K, SB, ds, tmp)
            elif opts.only == "cluster":
                run_clusterers(SB, ds, tmp, {})
            else:
                run_distillers(K, SB, SG, ds, tmp, {})
        log_windows()
        return

    # --- phases 2-3 ------------------------------------------------------
    lap("build and the arxiv twin's load")
    stats: dict = {}
    compare_kernels(K, stats)

    # --- phases 6-7 ------------------------------------------------------
    probe_gather(SG, stats, ds)
    compare_spmm_small(SB, G)
    compare_spmm_arxiv(SB, ds, stats)
    if opts.only == "kernels":
        # the full run holds these in phase 12, on the twins it loads there
        for name in IND_SPMM_WIDTHS:
            twin, _ = load_ind_twin(name)
            compare_spmm_ind(SB, twin, stats)
            del twin
            torch.cuda.empty_cache()
        return
    lap("phases 2, 3, 6, 7")

    # --- phase 4 ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        red, launches = run_gcond(K, SB, ds, tmp)
        saved = os.path.join(tmp, "reduced_graph", "gcond",
                             "ogbn-arxiv_0.01_1.npz")
        if not os.path.exists(saved):
            fail("the checkpoint did not save_reduced")

    # --- phase 5 ---------------------------------------------------------
    eargs = finalize(Args(dataset="ogbn-arxiv", method="gcond",
                          run_eval=3, eval_epochs=300, device="cuda"),
                     explicit={"run_eval", "eval_epochs"})
    art = read_npz(os.path.join(HERE, "benchmark", "artifacts",
                                "arxiv_gcond_r0.01.npz"), device="cuda")
    ev = Evaluator(ds, eargs)
    t0 = time.perf_counter()
    (acc, std), _ = ev.evaluate(art, "SGC")
    t_eval = time.perf_counter() - t0
    if not acc >= 0.80:
        fail(f"artifact SGC accuracy {acc:.4f} < 0.80")
    (acc_new, std_new), _ = ev.evaluate(red, "SGC")
    if not math.isfinite(acc_new):
        fail(f"condensed-graph accuracy {acc_new}")
    log(f"eval SGC 3 seeds x 300 epochs: artifact {acc:.4f} ± {std:.4f} "
        f"({t_eval:.1f} s; JAX package 0.8142 ± 0.0001), fresh 3-epoch "
        f"GCond graph {acc_new:.4f} ± {std_new:.4f}")
    lap("phases 4, 5")

    # --- phase 8 ---------------------------------------------------------
    del ev, art, red
    torch.cuda.empty_cache()
    core, subgraphs = run_coresets(SB, SG, G)
    compare_spmm_subgraphs(SB, G, subgraphs)
    lap("phase 8")

    # --- phase 9 ---------------------------------------------------------
    del subgraphs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cond = run_condensers(K, SB, ds, tmp)
    lap("phase 9")

    # --- phase 10 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        clus = run_clusterers(SB, ds, tmp, stats)
    lap("phase 10")

    # --- phase 11 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist = run_distillers(K, SB, SG, ds, tmp, stats)
    lap("phase 11")

    # --- phase 12 --------------------------------------------------------
    torch.cuda.empty_cache()
    kept: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        ind = run_ind(K, SB, SG, tmp, stats, kept)
    lap("phase 12")

    # --- phase 13 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        coarse = run_coarsen(SB, G, ds, tmp, stats)
    lap("phase 13")

    # --- phase 14 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        zoo = run_zoo(SB, SG, G, ds, tmp, stats)
    lap("phase 14")

    # --- phase 15 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        atk = run_attack(K, SB, SG, G, ds, tmp, stats)
    lap("phase 15")

    # --- phase 16 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ana = run_analysis(K, SB, SG, G, ds, tmp, stats)
    lap("phase 16")

    # --- phase 17 --------------------------------------------------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        distp = run_dist(K, SB, SG, G, ds, tmp, stats,
                         kept.pop("reddit"))
    lap("phase 17")
    log_windows()

    src = "graphslim_tpu_torch/csrc/"
    kernels = [
        # ms: the launch kind that keeps the workspace (syn_adj_norm);
        # ms_nograd: the kind without it (inner_adj, inference_adj)
        dict(name="pge_fwd", route="cuda", source=src + "pge_kernels.cuh",
             replaces="graphslim_tpu/kernels/pallas_pge.py:74",
             launches=launches["pge_fwd"] + cond["pge_fwd"]
             + dist["pge_fwd"] + ind["pge_fwd"] + atk["pge_fwd"]
             + ana["pge_fwd"] + distp["pge_fwd"],
             library_ms=None, **stats["pge_fwd"]),
        dict(name="pge_bwd", route="cuda", source=src + "pge_kernels.cuh",
             replaces="graphslim_tpu/kernels/pallas_pge.py:165",
             launches=launches["pge_bwd"] + cond["pge_bwd"]
             + dist["pge_bwd"] + ind["pge_bwd"] + atk["pge_bwd"]
             + ana["pge_bwd"] + distp["pge_bwd"],
             library_ms=None, **stats["pge_bwd"]),
        # timed at the hidden width, where the coreset path spends most
        dict(name="spmm_blocked", route="cuda",
             source=src + "spmm_blocked.cu",
             replaces="graphslim_tpu/kernels/pallas_spmm_blocked.py:198",
             launches=core["spmm_blocked"] + cond["spmm_blocked"]
             + clus["spmm_blocked"] + dist["spmm_blocked"]
             + ind["spmm_blocked"] + coarse["spmm_blocked"]
             + zoo["spmm_blocked"] + atk["spmm_blocked"]
             + ana["spmm_blocked"] + distp["spmm_blocked"],
             **stats["spmm_blocked_d256"]),
        dict(name="smem_gather", route="cuda",
             source=src + "smem_gather.cu",
             replaces="benchmark/probe_spmm.py:82",
             launches=core["smem_gather"] + dist["smem_gather"]
             + ind["smem_gather"] + zoo["smem_gather"]
             + atk["smem_gather"] + ana["smem_gather"]
             + distp["smem_gather"],
             **stats["smem_gather"]),
        # MSGC's scorer at the MSGC arxiv cell's shapes (phase 10); it
        # replaces no TPU kernel (the JAX package's scorer is plain JAX);
        # launches: from phase 10's MSGC run on (phases 10 and 12)
        dict(name="edge_scorer_fwd", route="cuda",
             source=src + "edge_scorer.cu", replaces=None,
             launches=ES.LAUNCHES["edge_scorer_fwd"],
             **stats["edge_scorer_fwd"]),
        dict(name="edge_scorer_bwd", route="cuda",
             source=src + "edge_scorer.cu", replaces=None,
             launches=ES.LAUNCHES["edge_scorer_bwd"],
             **stats["edge_scorer_bwd"]),
    ]
    for k in kernels:
        if not k["launches"] > 0:
            fail(f"kernel {k['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
