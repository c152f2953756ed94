"""Rank functions of the port's multi-rank tests, and the spawner that runs
them in gloo worlds on the CPU.

This module imports no JAX (the spawned children import it, never a JAX
test module).  :func:`run_world` starts ``world`` processes from the
``spawn`` context, each joining a gloo process group through a
``FileStore`` under the test's directory (no TCP port, so parallel test
workers cannot collide) with a 60 s collective timeout, and runs the named
checks of this module on every rank.  Each rank returns a dict of NumPy
arrays; a rank that raises writes its traceback, and a rank that does not
finish in time is killed: either fails the caller with that text.
"""

import datetime
import os
import pathlib
import pickle
import sys
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = datetime.timedelta(seconds=60)


def run_world(world: int, tmp_path, checks: list, payload: dict,
              deadline: float = 240.0) -> list:
    """Run ``checks`` (names of this module's ``check_*`` functions, each
    ``fn(mesh, payload) -> dict``) on ``world`` ranks → per rank, the
    merged dict of their results."""
    import multiprocessing as mp

    tmp = pathlib.Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp), list(checks)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    errors = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join(10)
            errors.append(f"rank {r} did not finish in {deadline:.0f} s")
        err = tmp / f"rank{r}.err"
        if err.exists():
            errors.append(f"rank {r}:\n{err.read_text()}")
        elif p.exitcode not in (0, None):
            errors.append(f"rank {r} exited with {p.exitcode}")
    if errors:
        raise AssertionError("\n".join(errors))
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, tmp: str, checks: list) -> None:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    tmp = pathlib.Path(tmp)
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from graphslim_tpu_torch.dist import make_mesh

        with open(tmp / "payload.pkl", "rb") as f:
            payload = dict(pickle.load(f), tmp=str(tmp))
        store = dist.FileStore(str(tmp / "store"), world)
        mesh = make_mesh(world, device="cpu", store=store, rank=rank,
                         world_size=world, timeout=TIMEOUT)
        res = {}
        for name in checks:
            res[name] = globals()[name](mesh, payload)
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def _np(t):
    import torch

    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


# ---------------------------------------------------------------------------
# Inputs both sides build the same way
# ---------------------------------------------------------------------------

def ragged_edges(n: int, e: int, seed: int) -> tuple:
    """A random weighted digraph with rows n//3..n//2 empty and one row
    pointing at every column: (edge index [2, E], weights)."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = (row < n // 3) | (row >= n // 2)
    row = np.concatenate([row[keep], np.full(n, n - 1)])
    col = np.concatenate([col[keep], np.arange(n)])
    w = rng.normal(size=row.shape[0]).astype(np.float32)
    return np.stack([row, col]), w


def graph_inputs() -> dict:
    """name → (indptr, row, col, val) host arrays of the graphs the SpMM
    checks shard, and ``x`` of each: synth-small's normalized Â and two
    ragged graphs (one whose row count divides into 2 and 4 shards)."""
    from graphslim_tpu_torch import graph as G
    from graphslim_tpu_torch.data import load

    ds = load("synth-small", seed=0, device="cpu")
    graphs = {"synth-small": ds.adj_norm_host()}
    for name, n in (("ragged-257", 257), ("ragged-256", 256)):
        ei, w = ragged_edges(n, 6 * n, n)
        graphs[name] = G.host_from_edge_index(ei, n, edge_weight=w)
    rng = np.random.default_rng(5)
    return {name: (h, rng.normal(size=(h.n_rows, 19)).astype(np.float32))
            for name, h in graphs.items()}


def forward_weights() -> list:
    """The two layers of the ``sharded_graph_forward`` check (19 → 8 → 5
    columns)."""
    rng = np.random.default_rng(6)
    return [rng.normal(size=(19, 8)).astype(np.float32),
            rng.normal(size=(8, 5)).astype(np.float32)]


# ---------------------------------------------------------------------------
# Checks (each runs on every rank)
# ---------------------------------------------------------------------------

def check_spmm(mesh, payload) -> dict:
    """Every sharded SpMM of the port on this rank's rows: ``shard_spmm``
    (both modes), ``shard_spmm_halo``, ``shard_spmm_halo_ragged`` (both
    exchanges, unpadded and padded), ``DistAdj.matmul`` and its padded
    view, a two-layer ``sharded_graph_forward``; and the errors of the
    padded shape and of an input that requires grad."""
    import torch

    from graphslim_tpu_torch.dist import spmm as D
    from graphslim_tpu_torch.dist.mesh import axis_size

    S, me = axis_size(mesh, "data"), mesh.get_local_rank("data")
    out = {}
    for name, (h, x) in graph_inputs().items():
        xt = torch.as_tensor(x)
        part = D.partition_rows(h, S)
        lo = min(me * part.rows_per_shard, part.n_rows)
        blk = xt[lo:lo + part.rows_of(me)]
        pad = torch.cat([blk, blk.new_zeros(
            (part.rows_per_shard - blk.shape[0], blk.shape[1]))])
        r = {"rows": (lo, part.rows_of(me))}
        r["replicated"] = D.shard_spmm(mesh, part, xt, "replicated")
        r["gather"] = D.shard_spmm(mesh, part, blk, "gather")
        r["halo"] = D.shard_spmm_halo(mesh, D.partition_rows_halo(h, S),
                                      blk)
        hp = D.partition_rows_halo_ragged(h, S)
        for ragged in (False, True):
            r[f"ragged{int(ragged)}"] = D.shard_spmm_halo_ragged(
                mesh, hp, blk, use_ragged=ragged)
            r[f"ragged{int(ragged)}_padded"] = D.shard_spmm_halo_ragged(
                mesh, hp, pad, use_ragged=ragged, padded=True)
        da = D.build_dist_adj(h, mesh)
        r["dist_full"] = da.matmul(xt)
        xp = da.pad_features(xt)
        r["dist_padded"] = da.padded_view().matmul(xp)
        pick = da.remap_idx(np.arange(h.n_rows))
        r["dist_picked"] = pick.take_rows(r["dist_padded"])
        r["order"] = da.order
        r["forward"] = D.sharded_graph_forward(
            mesh, part, [torch.as_tensor(w) for w in forward_weights()], xt)
        if da.n_padded != h.n_rows:
            try:
                da.matmul(torch.zeros(da.n_padded, 3))
                r["padded_refused"] = ""
            except ValueError as e:
                r["padded_refused"] = str(e)
        try:
            with torch.enable_grad():
                da.padded_view().matmul(xp.clone().requires_grad_(True))
            r["grad_refused"] = ""
        except NotImplementedError as e:
            r["grad_refused"] = str(e)
        out[name] = {k: _np(v) for k, v in r.items()}
    return out


def check_gather(mesh, payload) -> dict:
    """``make_sharded_row_gather`` of this rank's requests."""
    import torch

    from graphslim_tpu_torch.dist import make_sharded_row_gather
    from graphslim_tpu_torch.dist.mesh import axis_size

    S, me = axis_size(mesh, "data"), mesh.get_local_rank("data")
    x, idx = payload["gather_x"], payload["gather_idx"][S]
    rows_per = -(-x.shape[0] // S)
    xp = np.zeros((S * rows_per, x.shape[1]), np.float32)
    xp[:x.shape[0]] = x
    gather = make_sharded_row_gather(mesh, rows_per)
    got = gather(torch.as_tensor(xp[me * rows_per:(me + 1) * rows_per]),
                 torch.as_tensor(idx[me]))
    return {"rows": _np(got)}


def match_engine(feature_mode=None, mesh_size=None, double=False):
    """The GCond engine of the match checks (synth-small, SGC, hidden 32,
    one outer step an epoch); with ``mesh_size`` the matching shards over
    that many ranks; with ``double`` every float it computes with is
    float64 (the real features, the class weights, and the model's and the
    PGE's parameters as drawn)."""
    from graphslim_tpu_torch import utils
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.reduce import create_reducer

    base = dict(dataset="synth-small", method="gcond", condense_model="SGC",
                hidden=32, outer_loop=1, inner_loop=1, device="cpu")
    args = finalize(Args(**base), set(base))
    eng = create_reducer("gcond", load("synth-small", seed=0, device="cpu"),
                         args)
    if double:
        eng.real = eng.real._replace(features=eng.real.features.double())
        eng.coeffs = eng.coeffs.double()
        for part in (eng.model, eng.pge):
            init = part.init
            part.init = lambda gen, init=init: utils.tree_map(
                lambda p: p.double(), init(gen))
    if mesh_size is not None:
        eng.enable_distributed(mesh_size,
                               feature_mode=feature_mode or "replicated")
    return eng


def match_run(eng, feat0: np.ndarray) -> dict:
    """One match loss and its gradients from fixed draws, then two outer
    steps (a PGE step, a feature step) from the same start."""
    import torch

    from graphslim_tpu_torch import utils

    feat = torch.tensor(feat0, dtype=eng.real.features.dtype,
                        requires_grad=True)
    pge = utils.trainable(eng.pge.init(utils.make_generator(1, "cpu")))
    mp = eng.model.init(utils.make_generator(2, "cpu"))
    with torch.enable_grad():
        adj = eng.syn_adj_norm(pge, feat)
        loss = eng.match_loss_total(mp, feat, adj,
                                    utils.make_generator(7, "cpu"))
        grads = torch.autograd.grad(loss, [feat] + utils.tree_leaves(pge))
    out = {"loss": _np(loss), "grads": [_np(g) for g in grads]}
    eng.gen.manual_seed(11)
    opt_f = eng.opt_feat.init([feat])
    opt_p = eng.opt_pge.init(utils.tree_leaves(pge))
    for update_pge in (True, False):
        eng._epoch(feat, pge, opt_f, opt_p, update_pge=update_pge)
    out["feat"] = _np(feat)
    out["pge"] = [_np(p) for p in utils.tree_leaves(pge)]
    return out


MATCH_CASES = [(mode, double) for mode in ("replicated", "sharded")
               for double in (False, True)]


def check_match(mesh, payload) -> dict:
    from graphslim_tpu_torch.dist.mesh import axis_size

    S = axis_size(mesh, "data")
    return {(mode, double): match_run(match_engine(mode, S, double),
                                      payload["feat_syn"])
            for mode, double in MATCH_CASES}


def seed_fn(gen):
    import torch

    return {"u": torch.rand((), generator=gen),
            "v": torch.randn(3, generator=gen)}


def check_multi_seed(mesh, payload) -> dict:
    from graphslim_tpu_torch.dist import sharded_multi_seed

    out = sharded_multi_seed(mesh, seed_fn, n_seeds=10, seed=4)
    return {k: _np(v) for k, v in out.items()}


EVAL_DATASETS = {"trans": "synth-small", "ind": "synth-ind-small"}


def eval_args(name: str, **kw):
    from graphslim_tpu_torch.config import Args, finalize

    base = dict(dataset=name, method="random", reduction_rate=0.5,
                eval_epochs=30, run_eval=2, hidden=32, seed=3, device="cpu")
    base.update(kw)
    return finalize(Args(**base), set(base))


def eval_reduced(ds):
    """The first 60 rows of the graph reducers consume, with their induced
    subgraph (sparse): the reduced triple the evaluator checks train on."""
    import torch

    from graphslim_tpu_torch import graph as G

    feat, _, labels = ds.train_graph()
    rows = np.arange(60)
    adj = G.submatrix(ds.train_host(), rows, device="cpu")
    return G.Reduced(feat=feat[torch.as_tensor(rows)], adj=adj,
                     labels=labels[torch.as_tensor(rows)])


def check_build_once(mesh, payload) -> dict:
    """``utils.build_once`` on every rank: the writer alone runs a slow
    build of the cache file; every rank, once it returns, reads the file
    whole; a second call, with the file there, builds nothing."""
    from graphslim_tpu_torch import utils

    root = os.path.join(payload["tmp"], "cache")
    path = os.path.join(root, "built.npz")
    calls = []

    def build():
        calls.append(1)
        time.sleep(0.5)     # the other ranks must wait for it
        utils.save_npz(path, x=np.arange(5))
        return "built"

    out = utils.build_once(path, build)
    with np.load(path) as f:
        x = f["x"]
    again = utils.build_once(path, build)
    return {"calls": len(calls), "out": out, "again": again, "x": x,
            "files": sorted(os.listdir(root))}


def check_evaluator(mesh, payload) -> dict:
    """The mesh path's SGC and GCN accuracies on both settings: the
    default draws (``runs`` 2) and the JAX draws the parent carried in
    (one run)."""
    import torch

    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.eval import Evaluator

    out = {}
    for setting, name in EVAL_DATASETS.items():
        ds = load(name, seed=0, device="cpu")
        red = eval_reduced(ds)
        for mt in ("SGC", "GCN"):
            ev = Evaluator(ds, eval_args(name))
            ev.enable_distributed(mesh)
            (m, s), (accs, vals) = ev.evaluate(red, mt)
            carried = payload["carried"][setting, mt]
            ev.init_params = lambda *a, p=carried: _tensors(p)
            one = ev.test(red, mt, seed=3)
            out[setting, mt] = {"mean": m, "std": s, "accs": accs,
                                "vals": vals, "carried": one,
                                "sharded": sorted(ev._dist)}
    return out


def _tensors(tree):
    import torch

    from graphslim_tpu_torch import utils

    return utils.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)
