"""The attacks of the port against the JAX package (CPU, synth-small and
synth-ind-small).

* **Exact:** ``_triu_pairs``, ``_edge_key_set``, ``_is_existing_edge``,
  ``random_adj`` and ``random_feat`` make the same host draws in the same
  order and agree bit for bit; the cache file either package writes reads
  in the other to the same edge set (and features).
* **PRBCD at a fixed block:** the JAX package's forward, loss and
  projection are closures of its ``prbcd_attack``; the test takes them
  from the closure of its ``epoch_step`` at the first epoch (``jax.jit``
  of the attack module replaced so that the call stops there), with its
  trained surrogate, self-training labels and first block, and carries
  them across (``convert.model_params_from_jax``).  The log-probabilities
  agree to 1e-5 of the largest; ``∂loss/∂p`` to 1e-4 of max|g| (float32
  sums in other orders); ``p`` after one epoch (the sign-scaled step and
  the projection) to 1e-6, except where |g| is within 1e-6·max|g| of 0,
  where the step's sign is rounding (at most 1 % of the block may be left
  out; none is at these blocks, where the errors are 2.6e-7, 2.7e-7 and
  3e-8).  The split forward (``A`` and the block in two products) agrees
  to the same bounds.
* **The surrogate** trained from the JAX package's initial parameters
  (the seam ``attack.surrogate_init``) predicts the same self-training
  labels but for at most 1 % of the rows and its log-probabilities agree
  to 1e-3 of the largest (200 Adam epochs amplify rounding; none differs
  and 2.3e-5 were measured).
* **PRBCD end to end** on synth-small (block 5000, 20 epochs, 5
  fine-tune): the budget holds and a GCN's accuracy drops, as
  ``tests/test_prbcd.py`` checks for the JAX package.
* **The departure:** the port's attacked dataset carries none of the
  clean graph's caches and its ``adj_norm()`` is ``gcn_norm`` of the
  attacked adjacency; the JAX package's is the clean graph's.
* ``train_all --attack`` runs each attack and saves its triple under
  ``corrupt_graph/<attack>/``.
"""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import attack as jattack
from graphslim_tpu.data import load as jload
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import attack as A
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.train_all import run

from torch_shared import one_thread as _one_thread  # noqa: F401


def _args(jax_side: bool, tmp, **kw):
    base = dict(dataset="synth-small", method="kcenter", save_path=str(tmp),
                attack="random_adj", ptb_r=0.25, seed=1, hidden=16,
                eval_epochs=5)
    base.update(kw)
    if jax_side:
        return jfinalize(JArgs(**base))
    return finalize(Args(device="cpu", **base))


@pytest.fixture(scope="module")
def pair():
    return (jload("synth-small", split="random", seed=0),
            load("synth-small", split="random", seed=0, device="cpu"))


@pytest.mark.parametrize("n", [10, 137, 600])
def test_triu_pairs_agree(n):
    r, c = A._triu_pairs(np.random.default_rng(3), n, 2000)
    jr, jc = jattack._triu_pairs(np.random.default_rng(3), n, 2000)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    assert (r < c).all() and r.dtype == jr.dtype


def test_edge_key_set_and_membership_agree():
    rng = np.random.default_rng(1)
    n = 300
    ei = np.stack([rng.integers(0, n, 800), rng.integers(0, n, 800)])
    keys = A._edge_key_set(ei, n)
    np.testing.assert_array_equal(keys, jattack._edge_key_set(ei, n))
    r, c = A._triu_pairs(rng, n, 1500)
    got = A._is_existing_edge(keys, r, c, n)
    np.testing.assert_array_equal(got,
                                  jattack._is_existing_edge(keys, r, c, n))
    assert 0 < got.sum() < got.size
    empty = A._is_existing_edge(np.zeros(0, np.int64), r, c, n)
    assert not empty.any()


def test_random_adj_agrees_bit_for_bit(pair, tmp_path):
    jds, tds = pair
    jadj = jattack._random_adj(jds, _args(True, tmp_path))
    host = A._random_adj(tds, _args(False, tmp_path))
    np.testing.assert_array_equal(host.row, np.asarray(jadj.row))
    np.testing.assert_array_equal(host.col, np.asarray(jadj.col))
    assert jadj.nnz > jds.adj.nnz


def test_random_feat_agrees_bit_for_bit(pair, tmp_path):
    jds, tds = pair
    jfeat = np.asarray(jattack._random_feat(jds, _args(True, tmp_path)))
    feat = A._random_feat(tds, _args(False, tmp_path)).numpy()
    np.testing.assert_array_equal(feat, jfeat)
    assert (feat != tds.feat.numpy()).any(axis=1).sum() == \
        int(0.25 * tds.n_nodes)


def _edge_set(adj):
    h = G.host_of(adj) if isinstance(adj, G.SparseAdj) else adj
    return set(zip(np.asarray(h.row).tolist(), np.asarray(h.col).tolist()))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["random_adj", "random_feat"])
def test_the_cache_reads_in_the_other_package(pair, tmp_path, kind, writer):
    """One package attacks and writes the cache; the other reads it (its
    own attack would draw the same), and both hold the same graph."""
    jds, tds = pair
    jargs = _args(True, tmp_path, attack=kind)
    args = _args(False, tmp_path, attack=kind)
    path = tmp_path / "corrupt_graph" / kind / "synth-small_0.25.npz"
    if writer == "jax":
        jout = jattack.attack(jds, jargs)
        written = path.stat().st_mtime_ns
        out = A.attack(tds, args)
    else:
        out = A.attack(tds, args)
        written = path.stat().st_mtime_ns
        jout = jattack.attack(jds, jargs)
    assert path.stat().st_mtime_ns == written     # read, not rewritten
    with np.load(path) as blob:
        assert sorted(blob.files) == (["edge_index", "feat"]
                                      if kind == "random_feat"
                                      else ["edge_index"])
    assert _edge_set(out.adj) == set(zip(
        np.asarray(jout.adj.row).tolist(), np.asarray(jout.adj.col).tolist()))
    np.testing.assert_array_equal(out.feat.numpy(), np.asarray(jout.feat))
    if kind == "random_feat":
        assert out.adj is tds.adj
    else:
        assert out.adj.nnz > tds.adj.nnz


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_first_epoch(pair, tmp_path_factory):
    """``ptb_r`` → the JAX ``prbcd_attack``'s ``epoch_step`` (un-jitted)
    and the arguments of its first call (block 5000), the run stopped
    there."""
    jds = pair[0]
    tmp = tmp_path_factory.mktemp("jax_prbcd")
    cache = {}

    def first(ptb_r):
        if ptb_r in cache:
            return cache[ptb_r]
        got = {}

        def fake_jit(f):
            if f.__name__ != "epoch_step":
                return f

            def first_call(*args):
                got["step"], got["args"] = f, args
                raise _Stop
            return first_call

        class JaxProxy:
            jit = staticmethod(fake_jit)

            def __getattr__(self, name):
                return getattr(jax, name)

        with mock.patch.object(jattack, "jax", JaxProxy()):
            with pytest.raises(_Stop):
                jattack.prbcd_attack(
                    jds, _args(True, tmp, attack="metattack", ptb_r=ptb_r),
                    block_size=5000, epochs=20, fine_tune_epochs=5)
        cache[ptb_r] = got["step"], got["args"]
        return cache[ptb_r]
    return first


def _closure(f) -> dict:
    return dict(zip(f.__code__.co_freevars,
                    (c.cell_contents for c in f.__closure__)))


def _max_rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("ptb_r", [0.05, 0.25])
def test_fixed_block_forward_gradient_and_epoch(pair, jax_first_epoch,
                                               ptb_r):
    """At ptb_r 0.05 the projection binds (the budget, 147, is below what
    one step puts in the block), at 0.25 it does not."""
    tds = pair[1]
    step, (base, p0, jrows, jcols, jsign) = jax_first_epoch(ptb_r)
    env = _closure(step)
    fwd, loss_fn = env["fwd"], env["tanh_margin_loss"]
    jlp = np.asarray(fwd(base, p0, jrows, jcols, jsign))
    jloss, jg = jax.value_and_grad(
        lambda q: loss_fn(fwd(base, q, jrows, jcols, jsign), base[4]))(p0)
    jp1, _ = step(base, p0, jrows, jcols, jsign)
    jg, jp1 = np.asarray(jg), np.asarray(jp1)

    params = model_params_from_jax("GCN", _closure(fwd)["params"],
                                   device="cpu")
    labels = torch.as_tensor(np.asarray(base[4]).astype(np.int64))
    blk = A.Block(torch.as_tensor(np.asarray(jrows).astype(np.int64)),
                  torch.as_tensor(np.asarray(jcols).astype(np.int64)),
                  torch.as_tensor(np.array(jsign)))
    p = torch.as_tensor(np.array(p0))
    for fn in (A.forward_plain, A.forward_split):
        with torch.no_grad():
            lp = fn(params, tds.adj, tds.feat, p, blk).numpy()
        assert _max_rel(lp, jlp) <= 1e-5, fn.__name__
    loss, g = A.loss_and_grad(params, tds.adj, tds.feat, labels, p, blk)
    assert abs(float(loss) - float(jloss)) <= 1e-6
    assert _max_rel(g.numpy(), jg) <= 1e-4
    with mock.patch.object(A, "forward", A.forward_split):
        _, g_split = A.loss_and_grad(params, tds.adj, tds.feat, labels, p,
                                     blk)
    assert _max_rel(g_split.numpy(), jg) <= 1e-4

    budget = int(ptb_r * tds.adj.nnz / 2)
    p1, _ = A.epoch_step(params, tds.adj, tds.feat, labels, p, blk, budget,
                         0.2, 1e-7)
    p1 = p1.numpy()
    sure = np.abs(jg) > 1e-6 * np.abs(jg).max()
    assert (~sure).sum() <= 0.01 * sure.size, (~sure).sum()
    np.testing.assert_allclose(p1[sure], jp1[sure], rtol=0, atol=1e-6)
    stepped = np.maximum(np.asarray(p0) + 0.2 * np.sign(jg), 1e-7)
    binds = stepped.sum() > budget
    assert binds == (ptb_r == 0.05)
    if binds:
        assert abs(p1.sum() - budget) <= 1e-3 * budget


def test_project_agrees_with_the_jax_projection(jax_first_epoch):
    """The JAX projection reads ``budget`` from its closure; the test sets
    that cell to each budget in turn."""
    step, _ = jax_first_epoch(0.05)
    jproject = _closure(step)["project"]
    cells = dict(zip(jproject.__code__.co_freevars, jproject.__closure__))
    saved = cells["budget"].cell_contents
    p = np.random.default_rng(0).random(4000).astype(np.float32)
    try:
        for budget in (100, 1000, 2500):
            cells["budget"].cell_contents = budget
            want = np.asarray(jproject(jnp.asarray(p)))
            got = A.project(torch.as_tensor(p), budget, 1e-7).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert got.sum() <= budget * (1 + 1e-4)
    finally:
        cells["budget"].cell_contents = saved


def test_surrogate_from_the_jax_init(pair):
    """``train_surrogate`` from the JAX package's draw of the initial
    parameters (through ``surrogate_init``) against the JAX surrogate."""
    from graphslim_tpu import models as JM
    from graphslim_tpu_torch import models as M

    jds, tds = pair
    key = jax.random.key(1)
    cfg = JM.ModelConfig(nfeat=jds.n_feat, nhid=64, nclass=jds.nclass,
                         nlayers=2, dropout=0.0)
    jmodel = JM.get_model("GCN", cfg)
    init = jmodel.init(jax.random.split(key)[0])
    norm = jds.adj_norm()
    tr, va = jnp.asarray(jds.idx_train), jnp.asarray(jds.idx_val)
    jparams, _, _ = JM.fit_with_val(
        jmodel, key, train=(jds.feat, norm, jds.labels[tr], tr),
        val=(jds.feat, norm, jds.labels[va], va),
        cfg=JM.TrainConfig(epochs=200))
    jpred = np.array(jnp.argmax(jmodel.apply(jparams, jds.feat, norm,
                                               training=False), -1))
    jpred[jds.idx_train] = np.asarray(jds.labels)[jds.idx_train]

    carried = model_params_from_jax("GCN", init, device="cpu")
    with mock.patch.object(A, "surrogate_init",
                           lambda model, gen: carried):
        params, labels = A.train_surrogate(tds, torch.Generator())
    assert (labels.numpy() != jpred).mean() <= 0.01
    model = M.get_model("GCN", M.ModelConfig(nfeat=tds.n_feat, nhid=64,
                                             nclass=tds.nclass))
    with torch.no_grad():
        lp = model.apply(params, tds.feat, tds.adj_norm())
    jlp = np.asarray(jmodel.apply(jparams, jds.feat, norm, training=False))
    assert _max_rel(lp.numpy(), jlp) <= 1e-3


def test_prbcd_respects_budget_and_degrades(pair, tmp_path):
    _, tds = pair
    args = _args(False, tmp_path, attack="metattack", hidden=64,
                 eval_epochs=150)
    budget = int(args.ptb_r * tds.adj.nnz / 2)
    with mock.patch.object(A.log, "info") as info:
        host = A.prbcd_attack(tds, args, block_size=5000, epochs=20,
                              fine_tune_epochs=5)
    stats = info.call_args.kwargs["extra"]["prbcd"]
    assert 0 < stats["applied"] <= budget == stats["budget"]
    # a pair drawn twice into the block is one flip of the symmetric graph
    flipped = _edge_set(host) ^ _edge_set(tds.adj)
    assert 0 < len(flipped) // 2 <= stats["applied"]
    clean = A._report_attacked_acc(tds, args)
    attacked = A._report_attacked_acc(
        A.attacked_dataset(tds, host, tds.feat), args)
    assert attacked < clean - 0.02, (clean, attacked)


@pytest.mark.parametrize("name", ["synth-small", "synth-ind-small"])
def test_the_attacked_dataset_drops_every_cache(name, tmp_path):
    tds = load(name, seed=0, device="cpu")
    views = ("train", "val", "test") if tds.setting == "ind" else ()
    tds.adj_norm().blocked()
    tds.adj_norm_ell()
    tds.adj.blocked()
    for v in views:
        tds.view_norm(v)
    out = A.attack(tds, _args(False, tmp_path, dataset=name))
    # the attacked GCN's report built only the normalized adjacency
    assert out.adj is not tds.adj and out.adj._layouts == {}
    assert out.adj_host is G.host_of(out.adj)
    assert out._adj_norm is not tds._adj_norm
    assert out._adj_norm_host is not tds._adj_norm_host
    assert out._adj_norm._layouts == {} and out._adj_norm_ell is None
    assert out._view_norm == {} and out._view_norm_host == {}
    want = G.gcn_norm(out.adj)
    got = out.adj_norm()
    for a, b in ((got.row, want.row), (got.col, want.col),
                 (got.val, want.val)):
        assert torch.equal(a, b)
    assert got.nnz > tds.adj_norm().nnz
    for v in views:
        sub = G.host_submatrix(G.host_of(out.adj), getattr(out, f"idx_{v}"))
        assert _edge_set(getattr(out, f"adj_{v}")) == _edge_set(sub)
        assert torch.equal(getattr(out, f"feat_{v}"),
                           getattr(tds, f"feat_{v}"))
    # the JAX package keeps the clean host mirror: its adj_norm() is the
    # clean graph's (a departure the port does not copy)
    jds = jload(name, seed=0)
    jout = jattack.attack(jds, _args(True, tmp_path, dataset=name))
    assert jout.adj.nnz == out.adj.nnz
    assert jout.adj_norm().nnz == jds.adj_norm().nnz == tds.adj_norm().nnz
    assert JG.gcn_norm(jout.adj).nnz == got.nnz


def test_random_feat_keeps_the_clean_adjacency_and_its_caches(tmp_path):
    tds = load("synth-ind-small", seed=0, device="cpu")
    norm = tds.adj_norm()
    train_norm = tds.view_norm("train")
    out = A.attack(tds, _args(False, tmp_path, dataset="synth-ind-small",
                              attack="random_feat"))
    assert out.adj is tds.adj and out.adj_norm() is norm
    assert out.view_norm("train") is train_norm
    assert out.adj_train is tds.adj_train
    for v in ("train", "val", "test"):
        idx = torch.as_tensor(getattr(tds, f"idx_{v}"))
        assert torch.equal(getattr(out, f"feat_{v}"), out.feat[idx])
    assert not torch.equal(out.feat_train, tds.feat_train)


@pytest.mark.parametrize("kind", ["random_adj", "random_feat", "metattack"])
def test_train_all_runs_each_attack(kind, tmp_path, capsys):
    args = finalize(Args(dataset="synth-small", method="kcenter",
                         attack=kind, device="cpu", save_path=str(tmp_path),
                         run_eval=1, eval_epochs=20, prbcd_block=2000,
                         prbcd_epochs=6, prbcd_fine_tune=2),
                    explicit={"run_eval", "eval_epochs"})
    mean, _ = run(args)
    assert 0.0 <= mean <= 1.0
    root = tmp_path / "corrupt_graph" / kind
    assert (root / "synth-small_0.25.npz").exists()
    assert (root / "reduced_graph" / "kcenter" /
            "synth-small_0.25_1.npz").exists()
    assert not (tmp_path / "reduced_graph").exists()
    assert capsys.readouterr().out.startswith("kcenter on synth-small")


def test_unknown_attack_raises(pair, tmp_path):
    with pytest.raises(ValueError, match="unknown attack"):
        A.attack(pair[1], _args(False, tmp_path, attack="nope"))


def test_dataclass_fields_the_attack_rebuilds():
    """Every cache of ``Dataset`` is named here: a new one must be dropped
    by ``attacked_dataset`` too."""
    caches = {f.name for f in dataclasses.fields(G.Dataset)
              if f.name.startswith("_")}
    assert caches == {"_view_norm_host", "_view_norm", "_adj_norm",
                      "_adj_norm_host", "_adj_norm_ell"}
