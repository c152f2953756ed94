"""The port's SFGC against the JAX package on synth-hard (CPU).

* The expert buffer from the same initial parameters (the JAX package's
  keys, handed to the port through ``expert_inits``): 2 experts × 20
  full-graph GCN epochs (SGD, lr 0.4), every snapshot within 1e-4 of the
  largest parameter.  A buffer ``.npz`` written by either package reads
  the same in the other (the flat layout is ``ravel_pytree``'s).
* One outer step at ``syn_steps`` 5 from a handed-in snapshot, on the
  identity graph and on a handed-in normalized graph: the loss and its
  gradients with respect to the features and ``syn_lr`` within 1e-4
  (relative).  The JAX gradients are read from the optimizer it is handed
  (an identity transformation that records them), the step run eagerly.
* The (expert, start, target) draws of 12 outer steps are equal.
"""

import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer


TOL = 1e-4


def recorder(store: dict, key: str):
    """An optax transformation that records the gradient it is given and
    leaves the parameters where they are."""
    def update(g, state, params=None):
        store[key] = np.asarray(g)
        return jax.tree.map(jnp.zeros_like, g), state

    return optax.GradientTransformation(lambda p: optax.EmptyState(),
                                        update)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    common = dict(dataset="synth-hard", method="sfgc", hidden=16,
                  teacher_epochs=20, num_experts=2, syn_steps=5, epochs=12,
                  eval_epochs=20)
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jsave = str(tmp_path_factory.mktemp("jsfgc"))
    tsave = str(tmp_path_factory.mktemp("tsfgc"))
    jeng = jcreate("sfgc", jds, jfinalize(
        JArgs(**common, save_path=jsave), set(common)))
    teng = create_reducer("sfgc", tds, finalize(
        Args(**common, save_path=tsave, device="cpu"), set(common)))
    keys = jax.random.split(jax.random.key(jeng.args.seed), 2)
    inits = [model_params_from_jax(
        "GCN", jax.tree.map(np.asarray, jeng.expert_model.init(k)),
        device="cpu") for k in keys]
    traj_j = jeng.build_buffer(jds, False)
    with mock.patch.object(teng, "expert_inits", lambda: inits):
        traj_t = teng.build_buffer(tds, False)
    return dict(jds=jds, tds=tds, jeng=jeng, teng=teng, traj_j=traj_j,
                traj_t=traj_t)


def test_args_and_layout_match(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    assert teng.n_params == jeng.n_params
    assert (teng.args.init, teng.args.condense_model, teng.args.optim) == \
        ("kcenter", "GCN", "SGD")
    assert os.path.relpath(teng.buf_path, teng.args.save_path) == \
        os.path.relpath(jeng.buf_path, jeng.args.save_path)


def test_buffer_from_the_same_inits_matches_jax(engines):
    tj, tt = engines["traj_j"], engines["traj_t"]
    assert tt.shape == tj.shape == (2, 3, engines["teng"].n_params)
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    _close(tt, tj)
    assert np.abs(tj[:, -1] - tj[:, 0]).max() > 1e-2   # the experts moved


def test_buffers_read_across_packages(engines, tmp_path):
    jeng, teng = engines["jeng"], engines["teng"]
    t2 = create_reducer("sfgc", engines["tds"], teng.args.replace(
        save_path=str(tmp_path / "t"), no_buff=True))
    os.makedirs(os.path.dirname(t2.buf_path))
    shutil.copy(jeng.buf_path, t2.buf_path)
    np.testing.assert_array_equal(t2.build_buffer(engines["tds"], False),
                                  engines["traj_j"])
    j2 = jcreate("sfgc", engines["jds"], jeng.args.replace(
        save_path=str(tmp_path / "j"), no_buff=True))
    os.makedirs(os.path.dirname(j2.buf_path))
    shutil.copy(teng.buf_path, j2.buf_path)
    np.testing.assert_array_equal(j2.build_buffer(engines["jds"], False),
                                  engines["traj_t"])


def _syn_graph(n, seed=5):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.1).astype(np.float32)
    return np.asarray(JG.normalize_adj_dense(jnp.asarray(np.maximum(a,
                                                                    a.T))))


@pytest.mark.parametrize("graph", ["identity", "init"])
def test_outer_step_loss_and_gradients_match_jax(engines, graph):
    e = engines
    jeng, teng, traj = e["jeng"], e["teng"], e["traj_j"]
    n = teng.n_syn
    feat = np.random.default_rng(2).normal(size=(n, teng.d)).astype(
        np.float32)
    adj = np.eye(n, dtype=np.float32) if graph == "identity" \
        else _syn_graph(n)
    start, target = traj[1, 0], traj[1, 2]
    grads = {}
    jeng.opt_feat, jeng.opt_lr = recorder(grads, "f"), recorder(grads, "lr")
    with mock.patch.object(jax, "jit", lambda f, *a, **kw: f):
        step = jeng._build_align_step(graph, jnp.asarray(adj))
        fs = jnp.asarray(feat)
        lr = jnp.float32(teng.args.lr_student)
        *_, loss_j = step(fs, lr, jeng.opt_feat.init(fs),
                          jeng.opt_lr.init(lr), jnp.asarray(start),
                          jnp.asarray(target))
    fs_t = torch.tensor(feat, requires_grad=True)
    lr_t = torch.tensor(teng.args.lr_student, requires_grad=True)
    with torch.enable_grad():
        loss_t = teng.match_loss(
            fs_t, lr_t, None if graph == "identity" else torch.tensor(adj),
            torch.tensor(start), torch.tensor(target))
        g_f, g_lr = torch.autograd.grad(loss_t, [fs_t, lr_t])
    assert abs(loss_t.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    _close(g_f, grads["f"])
    assert abs(g_lr.item() - float(grads["lr"])) <= \
        TOL * abs(float(grads["lr"]))


def test_draw_sequences_are_equal(engines, tmp_path):
    """12 outer steps of each package's loop, its step replaced by one
    that records the snapshots it is given."""
    e = engines
    jeng, teng = e["jeng"], e["teng"]
    rng = np.random.default_rng(0)
    traj = rng.normal(size=(3, 6, teng.n_params)).astype(np.float32)
    seen_j, seen_t = [], []

    def fake_build(kind, adj):
        def step(fs, lr, of, ol, start, target):
            seen_j.append((np.asarray(start), np.asarray(target)))
            return fs, lr, of, ol, jnp.float32(1.0)
        return step

    def where(a):
        hit = np.argwhere((traj == a[None, None]).all(-1))
        assert hit.shape[0] == 1
        return tuple(hit[0])

    def fake_loss(fs, lr, adj, start, target):
        seen_t.append((start.numpy(), target.numpy()))
        return (fs * 0).sum() + lr * 0 + 1.0

    jargs = jeng.args.replace(checkpoints=())
    targs = teng.args.replace(checkpoints=())
    with mock.patch.object(jeng, "build_buffer", lambda d, v: traj), \
            mock.patch.object(jeng, "_build_align_step", fake_build), \
            mock.patch.object(jeng, "args", jargs), \
            mock.patch.object(teng, "build_buffer", lambda d, v: traj), \
            mock.patch.object(teng, "match_loss", fake_loss), \
            mock.patch.object(teng, "args", targs):
        jeng._reduce(e["jds"], False)
        teng._reduce(e["tds"], False)
    assert len(seen_j) == len(seen_t) == 12
    draws_j = [(where(s), where(t)) for s, t in seen_j]
    draws_t = [(where(s), where(t)) for s, t in seen_t]
    assert draws_t == draws_j
    assert len(set(draws_j)) > 1
