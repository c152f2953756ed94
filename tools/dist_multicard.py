#!/usr/bin/env python3
"""The distributed layer across several cards, one rank a card.

Run from the root of a checkout on a host with N cards:
``torchrun --standalone --nproc-per-node N tools/dist_multicard.py``
(NCCL); ``--device cpu --dataset synth-small`` runs the same checks in
gloo processes on the CPU.  ``chip_smoke.py`` runs the distributed layer
at world size 1 only (phase 17); this tool runs its exchanges between
ranks.  Every rank loads the twin onto its card, and then:

1. the sharded SpMMs of the twin's normalized Â (the ragged halo product
   of a ``DistAdj`` with both exchanges, the row-partitioned products in
   both feature layouts, the padded halo product) at d = 128 and 40,
   each rank's rows against the one-card blocked SpMM within
   1e-5·max|ref| + 1e-6, the ragged products timed (median of CUDA
   events; the exchange included) beside the one-card product;
2. the cross-shard row gather: exactly ``x[idx]``;
3. GCond's matching sharded over the ranks (both feature modes): the
   match loss within 1e-5 relative of the unsharded engine's on the same
   draws, the gradients within 1e-3 of their largest entry (float32; the
   PGE's BatchNorm backward magnifies class sums taken in another
   order), then two outer steps whose parameters must be equal bit for
   bit on every rank; outer steps/s of an epoch of 20 steps beside the
   unsharded engine's;
4. the evaluator's mesh path: SGC (3 seeds) and GCN (1 seed) on the
   reduced graph (``benchmark/artifacts/arxiv_gcond_r0.01.npz`` on the
   arxiv twin, else 60 train rows), within two test nodes of the local
   evaluation, with seconds;
5. ``sharded_multi_seed`` over 10 seeds, equal to a loop over them.

Rank 0 prints the card's name and power limit first and a line a check;
any failed check raises (non-zero exit on that rank, and torchrun's).
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = (1e-5, 1e-6)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dataset", default="ogbn-arxiv")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    os.environ.setdefault("GRAPHSLIM_TORCH_CACHE",
                          os.path.join(HERE, "build", "cache"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from graphslim_tpu_torch import utils
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load, read_npz
    from graphslim_tpu_torch.dist import (build_dist_adj, make_mesh,
                                          make_sharded_row_gather,
                                          partition_rows,
                                          partition_rows_halo,
                                          shard_spmm, shard_spmm_halo,
                                          shard_spmm_halo_ragged,
                                          sharded_multi_seed)
    from graphslim_tpu_torch.dist.evalp import seed_generator
    from graphslim_tpu_torch.dist.mesh import all_gather, axis_size
    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.graph import Reduced
    from graphslim_tpu_torch.reduce import create_reducer

    cuda = opts.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("dist_multicard: no CUDA card")
    mesh = make_mesh(None, device=opts.device,
                     timeout=datetime.timedelta(seconds=300))
    S, me = axis_size(mesh, "data"), mesh.get_local_rank("data")
    group = mesh.get_group("data")
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    if not cuda:
        torch.set_num_threads(1)

    def log(msg: str) -> None:
        if me == 0:
            print(msg, flush=True)

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    def fail(msg: str) -> None:
        raise SystemExit(f"dist_multicard: rank {me}: FAILED: {msg}")

    def close(name: str, got, ref) -> float:
        err = float((got.double() - ref.double()).abs().max()) \
            if ref.numel() else 0.0
        lim = TOL[0] * float(ref.abs().max()) + TOL[1] if ref.numel() \
            else TOL[1]
        if not err <= lim:
            fail(f"{name}: max|Δ| {err:.3e} > {lim:.3e}")
        return err

    def ms_of(fn, reps: int = 20) -> float:
        """Median ms of ``fn`` (CUDA events; host clock on the CPU), every
        rank calling it the same number of times."""
        fn()
        sync()
        times = []
        for _ in range(reps):
            dist.barrier(group)
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[len(times) // 2]

    if me == 0 and cuda:
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, {S} ranks on {opts.device} "
        f"({dist.get_backend()})")
    t0 = time.perf_counter()
    ds = load(opts.dataset, seed=0, device=opts.device)
    log(f"{opts.dataset}: {ds.n_nodes} nodes, {ds.adj.nnz} entries, "
        f"load {time.perf_counter() - t0:.1f} s")

    # --- 1. sharded SpMMs --------------------------------------------------
    adj = ds.adj_norm()
    n = adj.n_rows
    t0 = time.perf_counter()
    da = build_dist_adj(ds.adj_norm_host(), mesh)
    part = partition_rows(ds.adj_norm_host(), S)
    halo = partition_rows_halo(ds.adj_norm_host(), S)
    log(f"1. partitions (edge-cut order, ragged and padded halo tables): "
        f"{time.perf_counter() - t0:.1f} s; halo H {halo.halo_size}, "
        f"ragged receive buffer {da.hp.recv_len} rows")
    pick = da.remap_idx(np.arange(n))
    lo = min(me * part.rows_per_shard, n)
    rows = slice(lo, lo + part.rows_of(me))
    for d in (128, 40):
        gen = torch.Generator(device=dev).manual_seed(d)
        x = torch.randn(n, d, generator=gen, device=dev)
        one = adj.matmul(x)
        xp = da.pad_features(x)
        errs, times = {}, {}
        for ragged in (False, True):
            def run(ragged=ragged):
                return shard_spmm_halo_ragged(
                    mesh, da.hp, xp, use_ragged=ragged, padded=True)
            got = pick.take_rows(run())
            errs[ragged] = close(f"ragged halo (ragged={ragged}) d={d}",
                                 got, one)
            times[ragged] = ms_of(run)
        for mode in ("replicated", "gather"):
            src = x if mode == "replicated" else x[rows]
            close(f"shard_spmm {mode} d={d}",
                  shard_spmm(mesh, part, src, mode), one[rows])
        close(f"shard_spmm_halo d={d}",
              shard_spmm_halo(mesh, halo, x[rows]), one[rows])
        t_one = ms_of(lambda: adj.matmul(x))
        log(f"1. d={d}: every product within 1e-5 (ragged halo max|Δ| "
            f"{errs[False]:.2e} rounds, {errs[True]:.2e} all-to-all); ms "
            f"(rank 0, median, exchange included): rounds "
            f"{times[False]:.4f}, all-to-all {times[True]:.4f}, one card "
            f"{t_one:.4f}")
        del x, one, xp

    # --- 2. cross-shard row gather --------------------------------------
    rows_per = -(-n // S)
    gen = torch.Generator(device=dev).manual_seed(5)
    feat = ds.feat
    full = torch.cat([feat, feat.new_zeros((S * rows_per - n,
                                            feat.shape[1]))])
    idx = torch.randint(0, n, (S, 4096), generator=gen, device=dev)
    got = make_sharded_row_gather(mesh, rows_per)(
        full[me * rows_per:(me + 1) * rows_per].contiguous(), idx[me])
    if not torch.equal(got, feat[idx[me]]):
        fail("the cross-shard gather is not x[idx]")
    log(f"2. cross-shard gather of 4096 rows a rank: exact")

    # --- 3. sharded matching ----------------------------------------------
    args = finalize(Args(dataset=opts.dataset, method="gcond",
                         init="random", epochs=2, device=opts.device),
                    explicit={"epochs"}).replace(checkpoints=())
    for mode in ("replicated", "sharded"):
        eng = create_reducer("gcond", ds, args)
        feat0 = eng.init_feat_syn()
        results = []
        for sharded in (False, True):
            if sharded:
                eng.enable_distributed(mesh=mesh, feature_mode=mode)
            fs = feat0.clone().requires_grad_(True)
            pge = utils.trainable(eng.pge.init(utils.make_generator(1,
                                                                    dev)))
            mp = eng.model.init(utils.make_generator(2, dev))
            with torch.enable_grad():
                a_n = eng.syn_adj_norm(pge, fs)
                loss = eng.match_loss_total(mp, fs, a_n,
                                            utils.make_generator(7, dev))
                grads = torch.autograd.grad(loss,
                                            [fs] + utils.tree_leaves(pge))
            eng.gen.manual_seed(11)
            opt_f = eng.opt_feat.init([fs])
            opt_p = eng.opt_pge.init(utils.tree_leaves(pge))
            secs = []
            for update_pge in (True, False):
                sync()
                t0 = time.perf_counter()
                eng._epoch(fs, pge, opt_f, opt_p, update_pge=update_pge)
                sync()
                secs.append(time.perf_counter() - t0)
            results.append((float(loss.detach()), grads, fs.detach(),
                            [p.detach() for p in utils.tree_leaves(pge)],
                            args.outer_loop / secs[1]))
        (l0, g0, _, _, r0), (l1, g1, f1, p1, r1) = results
        rel = abs(l1 - l0) / abs(l0)
        if not rel <= 1e-5:
            fail(f"match ({mode}): loss {l1} against {l0}")
        top = max(float(g.abs().max()) for g in g0[1:])
        g_err = max(float((a - b).abs().max()) for a, b in
                    zip(g1[1:], g0[1:])) / top
        f_err = float((g1[0] - g0[0]).abs().max()) / float(
            g0[0].abs().max())
        if not max(g_err, f_err) <= 1e-3:
            fail(f"match ({mode}): gradients {f_err:.2e} / {g_err:.2e} "
                 "of their largest entries")
        for t in [f1] + p1:
            everyone = t.new_empty((S,) + tuple(t.shape))
            all_gather(everyone, t[None], group)
            if not all(torch.equal(everyone[0], everyone[k])
                       for k in range(S)):
                fail(f"match ({mode}): parameters differ between ranks")
        log(f"3. GCond matching over {S} ranks, features {mode}: loss "
            f"{l1:.6f} (unsharded {l0:.6f}, {rel:.1e} relative); "
            f"gradients within {f_err:.1e} (feat_syn) / {g_err:.1e} (PGE) "
            f"of their largest entries; two outer steps equal on every "
            f"rank; {r1:.3f} outer steps/s (unsharded {r0:.3f}, an epoch "
            f"of {args.outer_loop})")
        del eng, results

    # --- 4. the evaluator's mesh path --------------------------------------
    art_path = os.path.join(HERE, "benchmark", "artifacts",
                            "arxiv_gcond_r0.01.npz")
    if opts.dataset == "ogbn-arxiv":
        red = read_npz(art_path, device=opts.device)
    else:
        f, _, y = ds.train_graph()
        red = Reduced(feat=f[:60].clone(), adj=None, labels=y[:60].clone())
    n_test = (ds.labels_test.shape[0] if ds.setting == "ind"
              else len(ds.idx_test))
    for mt, seeds in (("SGC", 3), ("GCN", 1)):
        eargs = finalize(Args(dataset=opts.dataset, method="gcond",
                              run_eval=seeds, eval_epochs=300,
                              device=opts.device),
                         explicit={"run_eval", "eval_epochs"})
        (acc0, _), _ = Evaluator(ds, eargs).evaluate(red, mt)
        ev = Evaluator(ds, eargs)
        ev.enable_distributed(mesh)
        sync()
        t0 = time.perf_counter()
        (acc, std), _ = ev.evaluate(red, mt)
        sync()
        secs = time.perf_counter() - t0
        if not (math.isfinite(acc) and abs(acc - acc0) <= 2.0 / n_test
                + 1e-6):
            fail(f"evaluator {mt}: mesh {acc} against local {acc0}")
        log(f"4. evaluator {mt} {seeds} seed(s) x 300 epochs on {S} ranks: "
            f"{acc:.4f} ± {std:.4f} (local {acc0:.4f}), {secs:.2f} s")

    # --- 5. seed-parallel evaluation ---------------------------------------
    def draw(g):
        return torch.rand((), generator=g, device=dev)

    got = sharded_multi_seed(mesh, draw, n_seeds=10, seed=4)
    want = torch.stack([draw(seed_generator(4, i, dev.type))
                        for i in range(10)])
    if not torch.equal(got, want):
        fail("sharded_multi_seed differs from the loop over its seeds")
    log("5. sharded_multi_seed over 10 seeds: equal to the loop")
    dist.destroy_process_group()
    log("dist_multicard: ok")


if __name__ == "__main__":
    main()
