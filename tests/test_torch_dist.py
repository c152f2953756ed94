"""The port's distributed layer (``graphslim_tpu_torch/dist/``) against the
JAX package's (CPU).

The JAX side runs in this process on the 8-device virtual CPU mesh that
``conftest.py`` sets up.  The port's ranks run in spawned gloo processes
(``torch_dist_ranks.py``, which imports no JAX): one world of 2 ranks and
one of 4 for the whole module, each running every rank-side check once;
the tests read their results.  Tolerances:

* routing tables: equal bit for bit (the JAX native library is asserted
  loaded, so that its RCM fallback cannot stand in);
* sharded SpMMs: within 1e-5·max|ref| + 1e-6 of the port's one-process
  ``SparseAdj.matmul`` and of the JAX package's 8-device result
  (``JAX_KINDS``; only the order of the float32 sums differs);
* the cross-shard row gather: exactly ``x[idx]``;
* the sharded match within 1e-5 relative of the unsharded one on the
  same draws at S = 1, 2 and 4: the loss in float32 and float64, the
  gradients and the parameters after two outer steps in float64 (see
  ``_check_match``); after two outer steps the parameters are equal bit
  for bit on every rank in both precisions;
* the evaluator's mesh path: within 1e-6 of the port's local evaluator,
  and from the JAX draws within two test nodes of the JAX package's mesh
  evaluator at 8 devices.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_shared import jax_native_lib
from torch_shared import one_thread as _one_thread  # noqa: F401

import jax
import jax.numpy as jnp

import torch_dist_ranks as R
from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.dist import make_mesh as jmake_mesh
from graphslim_tpu.dist import spmm as JD
from graphslim_tpu.eval import Evaluator as JEvaluator
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.dist import spmm as D
from graphslim_tpu_torch.eval import Evaluator

TOL = (1e-5, 1e-6)


def _jax_adj(h: G.HostAdj) -> JG.SparseAdj:
    """The same host arrays as a JAX ``SparseAdj``."""
    return JG.SparseAdj(jnp.asarray(h.indptr, jnp.int32),
                        jnp.asarray(h.row, jnp.int32),
                        jnp.asarray(h.col, jnp.int32),
                        jnp.asarray(h.values_or_ones(), jnp.float32))


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    lim = TOL[0] * float(np.abs(ref).max(initial=0.0)) + TOL[1]
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= lim, (what, err, lim)


@pytest.fixture(scope="module")
def inputs():
    return R.graph_inputs()


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(101, 16)).astype(np.float32)
    eng = R.match_engine()
    return {"gather_x": x,
            "gather_idx": {S: rng.integers(0, 101, size=(S, 33))
                           for S in (2, 4)},
            "feat_syn": eng.init_feat_syn().numpy(),
            "carried": _carried()}


def _jax_eval(setting: str):
    name = R.EVAL_DATASETS[setting]
    args = dict(dataset=name, method="random", reduction_rate=0.5,
                eval_epochs=30, run_eval=2, hidden=32, seed=3)
    jds = jload(name, seed=0)
    return jds, JEvaluator(jds, jfinalize(JArgs(**args), set(args)))


def _jax_reduced(jds):
    feat, adj, labels = jds.train_graph()
    rows = np.arange(60)
    return JG.Reduced(feat=jnp.asarray(np.asarray(feat)[rows]),
                      adj=JG.submatrix(adj, rows),
                      labels=jnp.asarray(np.asarray(labels)[rows]))


def _carried() -> dict:
    """The JAX evaluator's draw of a single run of seed 3, as the port's
    parameters (NumPy leaves), per (setting, model)."""
    out = {}
    for setting in R.EVAL_DATASETS:
        jds, jev = _jax_eval(setting)
        for mt in ("SGC", "GCN"):
            model = jev._eval_model(mt, jds.feat.shape[-1])
            p = model.init(jax.random.split(jax.random.split(
                jax.random.key(3), 1)[0])[0])
            tp = model_params_from_jax(mt, jax.tree.map(np.asarray, p),
                                       device="cpu")
            out[setting, mt] = jax.tree.map(lambda t: t.numpy(), tp)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory, payload):
    return R.run_world(2, tmp_path_factory.mktemp("world2"),
                       ["check_spmm", "check_gather", "check_match",
                        "check_evaluator"], payload)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, payload):
    return R.run_world(4, tmp_path_factory.mktemp("world4"),
                       ["check_spmm", "check_gather", "check_match",
                        "check_multi_seed", "check_build_once"], payload)


def _world(request, S):
    return request.getfixturevalue(f"world{S}")


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
def test_partition_tables_equal_jax_bit_for_bit(inputs, S):
    assert jax_native_lib() is not None, "the JAX native library must load"
    for name, (h, _) in inputs.items():
        ja = _jax_adj(h)
        order = D.edge_cut_order(h, S)
        assert np.array_equal(order, np.asarray(JD.edge_cut_order(ja, S)))
        ra, rj = D.reorder_adj(h, order), JD.reorder_adj(ja, order)
        for f in ("indptr", "row", "col", "val"):
            assert np.array_equal(getattr(ra, f), np.asarray(getattr(rj, f)))
        p, pj = D.partition_rows(h, S), JD.partition_rows(ja, S)
        for f in ("row_local", "col", "val"):
            assert np.array_equal(getattr(p, f), np.asarray(getattr(pj, f)))
        assert (p.rows_per_shard, p.n_rows) == (pj.rows_per_shard,
                                                pj.n_rows)
        q, qj = D.partition_rows_halo(h, S), JD.partition_rows_halo(ja, S)
        assert q.halo_size == qj.halo_size
        for f in ("send_idx", "col_halo"):
            assert np.array_equal(getattr(q, f), np.asarray(getattr(qj, f)))
        g, gj = (D.partition_rows_halo_ragged(h, S),
                 JD.partition_rows_halo_ragged(ja, S))
        for f in ("send_flat", "in_offsets", "send_sizes", "out_offsets",
                  "recv_sizes", "row_int", "col_int", "val_int", "row_bnd",
                  "col_bnd", "val_bnd"):
            assert np.array_equal(getattr(g, f), np.asarray(getattr(gj, f))), f
        assert (g.send_max, g.recv_len, g.round_max) == \
            (gj.send_max, gj.recv_len, gj.round_max)
        # the real entries of each segment come first
        for s in range(S):
            assert (g.n_int[s] + g.n_bnd[s]) == p.counts[s]


def test_edge_cut_order_has_no_fallback(monkeypatch, inputs):
    from graphslim_tpu_torch import native

    def broken():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        D.edge_cut_order(inputs["synth-small"][0], 2)


# ---------------------------------------------------------------------------
# Sharded products
# ---------------------------------------------------------------------------

# the JAX package's 8-device products held against: every kind on
# synth-small's Â; the ragged graphs' row-partitioned kinds (each ragged
# halo program compiles for about 9 s on the CPU mesh, so those two kinds
# hold the ragged graphs to the port's one-process product only)
JAX_KINDS = {"synth-small": ("replicated", "gather", "halo", "ragged",
                             "dist"),
             "ragged-257": ("replicated", "gather", "halo")}


@pytest.fixture(scope="module")
def jax_products(inputs):
    """The JAX package's 8-device results of the sharded SpMMs."""
    mesh = jmake_mesh(8)
    out = {}
    for name, kinds in JAX_KINDS.items():
        h, x = inputs[name]
        ja, xj = _jax_adj(h), jnp.asarray(x)
        part = JD.partition_rows(ja, 8)
        run = {
            "replicated": lambda: JD.shard_spmm(mesh, part, xj,
                                                "replicated"),
            "gather": lambda: JD.shard_spmm(mesh, part, xj, "gather"),
            "halo": lambda: JD.shard_spmm_halo(
                mesh, JD.partition_rows_halo(ja, 8), xj),
            "ragged": lambda: JD.shard_spmm_halo_ragged(
                mesh, JD.partition_rows_halo_ragged(ja, 8), xj),
            "dist": lambda: JD.build_dist_adj(ja, mesh).matmul(xj),
        }
        out[name] = {k: np.asarray(run[k]()) for k in kinds}
    return out


def _assembled(results, name, key):
    """The blocks of all ranks, stacked in rank order."""
    return np.concatenate([r["check_spmm"][name][key] for r in results])


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_spmm_matches_local_and_jax(request, inputs, jax_products,
                                            S):
    res = _world(request, S)
    for name, (h, x) in inputs.items():
        local = h.to_sparse("cpu").matmul(torch.as_tensor(x)).numpy()
        jx = jax_products.get(name, {})
        n = h.n_rows
        for key, jkey in (("replicated", "replicated"),
                          ("gather", "gather"), ("halo", "halo"),
                          ("ragged0", "ragged"), ("ragged1", "ragged")):
            got = _assembled(res, name, key)
            _close(got, local, (name, key, "local"))
            if jkey in jx:
                _close(got, jx[jkey], (name, key, "jax"))
        order = res[0]["check_spmm"][name]["order"]
        for key in ("ragged0_padded", "ragged1_padded"):
            got = _assembled(res, name, key)
            p = D.partition_rows(h, S)
            assert got.shape[0] == S * p.rows_per_shard
            _close(got[:n], local, (name, key))
            assert not got[n:].any()       # padding rows have no entries
        for r in res:
            assert np.array_equal(r["check_spmm"][name]["order"], order)
            _close(r["check_spmm"][name]["dist_full"], local,
                   (name, "DistAdj.matmul"))
            if "dist" in jx:
                _close(r["check_spmm"][name]["dist_full"], jx["dist"],
                       (name, "DistAdj.matmul jax"))
            # the padded view's blocks, picked back into the original order
            _close(r["check_spmm"][name]["dist_picked"], local,
                   (name, "padded view"))
        adj = h.to_sparse("cpu")
        w1, w2 = (torch.as_tensor(w) for w in R.forward_weights())
        two = adj.matmul(torch.relu(adj.matmul(torch.as_tensor(x) @ w1))
                         @ w2).numpy()
        _close(_assembled(res, name, "forward"), two,
               (name, "sharded_graph_forward"))
        padded = np.concatenate([r["check_spmm"][name]["dist_padded"]
                                 for r in res])
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        _close(padded[inv], local, (name, "padded view blocks"))


@pytest.mark.parametrize("S", [2, 4])
def test_dist_adj_refuses_the_padded_shape_and_grad(request, S):
    res = _world(request, S)
    # 257 rows pad to 258 / 260 rows: the padded shape is refused
    r = res[0]["check_spmm"]["ragged-257"]
    assert "padded_view" in r["padded_refused"]
    for r in res:
        for name, v in r["check_spmm"].items():
            assert "forward-only" in v["grad_refused"], name


@pytest.mark.parametrize("S", [2, 4])
def test_cross_shard_row_gather_is_exact(request, payload, S):
    res = _world(request, S)
    x, idx = payload["gather_x"], payload["gather_idx"][S]
    for me, r in enumerate(res):
        assert np.array_equal(r["check_gather"]["rows"], x[idx[me]])


# ---------------------------------------------------------------------------
# Class-parallel matching
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded(payload):
    """The unsharded engine's results in float32 and float64."""
    return {double: R.match_run(R.match_engine(double=double),
                                payload["feat_syn"])
            for double in (False, True)}


def _rel_close(got, ref, what):
    """max|got - ref| ≤ 1e-5 · max|ref|; a list of leaves is held against
    the largest entry of any of them (the PGE's hidden biases feed
    BatchNorm: their gradient is zero up to rounding)."""
    ref_l = ref if isinstance(ref, list) else [ref]
    got_l = got if isinstance(got, list) else [got]
    top = max(float(np.abs(np.asarray(r, np.float64)).max(initial=0.0))
              for r in ref_l)
    assert top > 0 and len(got_l) == len(ref_l), what
    for i, (g, r) in enumerate(zip(got_l, ref_l)):
        err = float(np.abs(np.asarray(g, np.float64)
                           - np.asarray(r, np.float64)).max(initial=0.0))
        assert err <= 1e-5 * top, (what, i, err, top)


def _check_match(got, want, double):
    """The loss in both precisions; in float64 also the gradients with
    respect to ``feat_syn`` and to the PGE parameters.  (In float32 the
    backward through the PGE's BatchNorm subtracts means of the incoming
    gradient, which magnifies the rounding of class sums taken in another
    order to about 1e-4 of the largest entry: the sums, not the algorithm,
    differ.)"""
    _rel_close(got["loss"], want["loss"], "loss")
    if double:
        _rel_close(got["grads"][0], want["grads"][0], "grad feat_syn")
        _rel_close(got["grads"][1:], want["grads"][1:], "grad PGE")


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_sharded_match_at_one_rank(payload, unsharded, mode, double):
    """A world of one (gloo, in this process): the sharded match is the
    unsharded one, padded classes and all."""
    from graphslim_tpu_torch.dist import make_mesh

    assert not dist.is_initialized()
    try:
        make_mesh(1, device="cpu")
        got = R.match_run(R.match_engine(mode, 1, double),
                          payload["feat_syn"])
    finally:
        dist.destroy_process_group()
    _check_match(got, unsharded[double], double)


@pytest.mark.parametrize("case", R.MATCH_CASES, ids=str)
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_match_matches_unsharded(request, unsharded, S, case):
    for r in _world(request, S):
        _check_match(r["check_match"][case], unsharded[case[1]], case[1])


@pytest.mark.parametrize("case", R.MATCH_CASES, ids=str)
@pytest.mark.parametrize("S", [2, 4])
def test_two_outer_steps_agree_on_every_rank(request, unsharded, payload,
                                             S, case):
    """After a PGE step and a feature step the parameters are equal bit
    for bit on every rank; in float64 they match the one-process run."""
    res = _world(request, S)
    first = res[0]["check_match"][case]
    assert not np.array_equal(first["feat"], payload["feat_syn"])
    for r in res:
        got = r["check_match"][case]
        assert np.array_equal(got["feat"], first["feat"])
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["pge"], first["pge"]))
    if case[1]:
        want = unsharded[True]
        _rel_close(first["feat"], want["feat"], "feat_syn")
        _rel_close(first["pge"], want["pge"], "PGE parameters")


# ---------------------------------------------------------------------------
# Seed-parallel evaluation
# ---------------------------------------------------------------------------

def test_sharded_multi_seed_in_seed_order(world4):
    from graphslim_tpu_torch.dist.evalp import seed_generator

    want = [R.seed_fn(seed_generator(4, i, "cpu")) for i in range(10)]
    for r in world4:
        got = r["check_multi_seed"]
        assert got["u"].shape == (10,) and got["v"].shape == (10, 3)
        assert np.array_equal(got["u"], np.stack([w["u"] for w in want]))
        assert np.array_equal(got["v"], np.stack([w["v"] for w in want]))
        assert len(np.unique(got["u"])) == 10


def test_build_once_has_one_writer(world4):
    """A cache (the attack's, SFGC's expert buffer) is built by rank 0
    alone and read whole by every rank."""
    for r, got in enumerate(world4):
        assert got["check_build_once"]["calls"] == (r == 0)
        assert got["check_build_once"]["out"] == ("built" if r == 0
                                                  else None)
        assert got["check_build_once"]["again"] is None
        assert np.array_equal(got["check_build_once"]["x"], np.arange(5))
        assert got["check_build_once"]["files"] == ["built.npz"]


# ---------------------------------------------------------------------------
# The evaluator's mesh path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_eval():
    """The JAX package's mesh evaluator at 8 devices: one run of seed 3."""
    mesh = jmake_mesh(8)
    out = {}
    for setting in R.EVAL_DATASETS:
        jds, jev = _jax_eval(setting)
        jev.enable_distributed(mesh)
        red = _jax_reduced(jds)
        for mt in ("SGC", "GCN"):
            out[setting, mt] = float(
                jev.evaluate(red, mt, runs=1, seed=3)[1][0][0])
    return out


@pytest.mark.parametrize("model_type", ["SGC", "GCN"])
@pytest.mark.parametrize("setting", sorted(R.EVAL_DATASETS))
def test_evaluator_mesh_path(world2, jax_mesh_eval, payload, setting,
                             model_type):
    ds = load(R.EVAL_DATASETS[setting], seed=0, device="cpu")
    red = R.eval_reduced(ds)
    ev = Evaluator(ds, R.eval_args(ds.name))
    (m0, s0), (accs0, vals0) = ev.evaluate(red, model_type)
    n_test = (ds.labels_test.shape[0] if setting == "ind"
              else len(ds.idx_test))
    for r in world2:
        got = r["check_evaluator"][setting, model_type]
        assert got["sharded"] == ["test", "val"]
        assert abs(got["mean"] - m0) < 1e-6 and abs(got["std"] - s0) < 1e-6
        assert np.abs(got["vals"] - vals0).max() < 1e-6
        assert abs(got["carried"] - jax_mesh_eval[setting, model_type]) \
            <= 2.0 / n_test + 1e-6


def test_small_inductive_subgraphs_stay_local():
    """Subgraphs under 2·S rows are not sharded (in a world of one, S = 1:
    a subgraph of one row stays local)."""
    from graphslim_tpu_torch.dist import make_mesh

    ds = load("synth-ind-small", seed=0, device="cpu")
    ds.set_view("val", ds.feat_val[:1], ds.labels_val[:1],
                G.host_submatrix(ds.view_host("val"), np.arange(1)))
    ds._view_norm_host.pop("val", None)
    ds._view_norm.pop("val", None)
    try:
        mesh = make_mesh(1, device="cpu")
        ev = Evaluator(ds, R.eval_args(ds.name))
        ev.enable_distributed(mesh)
    finally:
        dist.destroy_process_group()
    assert sorted(ev._dist) == ["test"]
    assert ev._split_tuple("val", "GCN")[1] is ds.view_norm("val")
    assert ev._split_tuple("test", "GAT")[1] is ds.view_norm("test")


def test_aggregate_takes_any_object_with_a_matmul():
    """``models.base.aggregate`` sends an adjacency it does not know to
    its ``matmul`` (duck-typed, as the JAX package does), and
    ``select_rows`` to an index object's ``take_rows``."""
    from graphslim_tpu_torch.models.base import aggregate, select_rows

    class Twice:
        def matmul(self, x):
            return 2 * x

    class Last:
        def take_rows(self, out):
            return out[-1:]

    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(aggregate(Twice(), x), 2 * x)
    assert torch.equal(select_rows(x, Last()), x[-1:])
    assert torch.equal(select_rows(x, torch.tensor([2, 0])), x[[2, 0]])
    assert select_rows(x, None) is x
