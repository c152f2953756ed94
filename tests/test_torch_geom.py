"""The port's GEOM against the JAX package on synth-hard (CPU).

* The curriculum order (train rows by neighbour-label entropy) is equal,
  row for row; the scheduler's prefix sizes ``floor(size(t) · n_tr)`` are
  equal at every epoch for the linear, root and geometric schedules.
* The curriculum buffer from the same initial parameters (the JAX
  package's keys, handed in through ``expert_inits``): 2 experts × 21
  epochs, every snapshot within 1e-4 of the largest parameter.
* The soft-label init from the first expert's last snapshot within 1e-5.
* One outer step at ``syn_steps`` 5, with hard labels and β = 0.01, with
  soft labels and β = 0.01, and with soft labels and β = 0: the loss and
  its gradients (features, soft labels, ``syn_lr``) within 1e-4
  (relative).  The JAX step runs eagerly and its optimizers record the
  gradients they are given.
* The draws of 12 outer steps are equal.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphslim_tpu.reduce.registry as JR
from torch_shared import one_thread as _one_thread  # noqa: F401
from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu.reduce.geom import training_scheduler as jsched
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import model_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.geom import training_scheduler


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


def _engines(tmp_path, **kw):
    common = dict(dataset="synth-hard", method="geom", hidden=16,
                  teacher_epochs=20, num_experts=2, syn_steps=5, epochs=1,
                  eval_epochs=20, **kw)
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("geom", jds, jfinalize(JArgs(
        **common, save_path=str(tmp_path / "j")), set(common))
        .replace(checkpoints=()))
    teng = create_reducer("geom", tds, finalize(Args(
        **common, save_path=str(tmp_path / "t"), device="cpu"),
        set(common)).replace(checkpoints=()))
    return jds, jeng, tds, teng


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jds, jeng, tds, teng = _engines(tmp_path_factory.mktemp("geom"))
    keys = jax.random.split(jax.random.key(jeng.args.seed), 2)
    inits = [model_params_from_jax(
        "GCN", jax.tree.map(np.asarray, jeng.expert_model.init(k)),
        device="cpu") for k in keys]
    traj_j = jeng.build_buffer(jds, False)
    with mock.patch.object(teng, "expert_inits", lambda: inits):
        traj_t = teng.build_buffer(tds, False)
    return dict(jds=jds, tds=tds, jeng=jeng, teng=teng, traj_j=traj_j,
                traj_t=traj_t)


def test_curriculum_order_is_equal(engines):
    order_j = engines["jeng"]._sorted_train(engines["jds"])
    order_t = engines["teng"].sorted_train(engines["tds"])
    np.testing.assert_array_equal(order_t, order_j)
    assert not np.array_equal(order_t, np.sort(order_t))


@pytest.mark.parametrize("scheduler", ["linear", "root", "geom"])
def test_scheduler_is_equal(scheduler):
    T, n_tr = 1500.0, 135458
    t = np.arange(0, 1600, dtype=np.float32)
    for lam in (0.75, 0.85):
        ref = np.asarray(jsched(lam, jnp.asarray(t), T, scheduler))
        got = training_scheduler(lam, torch.tensor(t), T, scheduler)
        np.testing.assert_array_equal(
            torch.floor(got * n_tr).numpy(),
            np.asarray(jnp.floor(jnp.asarray(ref) * n_tr)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-7)
        assert got[0] < 1.0 and got[-1] == 1.0


def test_curriculum_buffer_from_the_same_inits_matches_jax(engines):
    tj, tt = engines["traj_j"], engines["traj_t"]
    assert tt.shape == tj.shape == (2, 3, engines["teng"].n_params)
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    _close(tt, tj)


def test_soft_label_init_matches_jax(engines):
    e = engines
    n = e["teng"].n_syn
    feat = np.random.default_rng(3).normal(size=(n, e["teng"].d)).astype(
        np.float32)
    eye = JG.normalize_adj_dense(jnp.eye(n), add_loops=False)
    ref = e["jeng"]._soft_label_init(e["traj_j"], jnp.asarray(feat), eye)
    got = e["teng"].soft_label_init(torch.tensor(e["traj_j"]),
                                    torch.tensor(feat))
    _close(got, ref, 1e-5)
    # every row's label entry is raised to the row's maximum
    hard = e["teng"].labels_syn
    assert torch.equal(got[torch.arange(n), hard], got.max(1).values)


@pytest.mark.parametrize("soft,beta", [(0, 0.01), (1, 0.01), (1, 0.0)])
def test_outer_step_loss_and_gradients_match_jax(tmp_path, engines, soft,
                                                 beta):
    jds, jeng, tds, teng = _engines(tmp_path, soft_label=soft, beta=beta)
    traj = engines["traj_j"]
    n = teng.n_syn
    feat = np.random.default_rng(2).normal(size=(n, teng.d)).astype(
        np.float32)
    labels = np.asarray(jeng.labels_syn)
    grads, outs = {}, []

    class Init:
        def reduce(self, data, verbose=False):
            return JG.Reduced(feat=jnp.asarray(feat), adj=None,
                              labels=jnp.asarray(labels))

    def eager_jit(f, *a, **kw):
        def run(*args, **kwargs):
            out = f(*args, **kwargs)
            if f.__name__ == "step":
                outs.append(out)
            return out
        return run

    jeng.opt_feat = recorder(grads, "f")
    with mock.patch.object(jeng, "build_buffer", lambda d, v: traj), \
            mock.patch.object(JR, "create_reducer",
                              lambda *a, **kw: Init()), \
            mock.patch.object(jax, "jit", eager_jit), \
            mock.patch.object(optax, "sgd", lambda lr, momentum=None: (
                recorder(grads, "y" if momentum == 0.9 else "lr"))):
        jeng._reduce(jds, False)
    assert len(outs) == 1
    loss_j = float(outs[0][-1])

    traj_t = torch.tensor(traj)
    e, s, t = teng.draw(np.random.default_rng(teng.args.seed), 0,
                        traj.shape[0], traj.shape[1])
    fs = torch.tensor(feat, requires_grad=True)
    lr = torch.tensor(teng.args.lr_student, requires_grad=True)
    ys = teng.soft_label_init(traj_t, fs.detach()).requires_grad_(True) \
        if soft else None
    with torch.enable_grad():
        loss = teng.geom_loss(fs, ys, lr, traj_t[e, s], traj_t[e, t],
                              traj_t[e, -1])
        got = torch.autograd.grad(loss, [fs, lr] + ([ys] if soft else []))
    assert abs(loss.item() - loss_j) <= TOL * abs(loss_j)
    _close(got[0], grads["f"])
    assert abs(got[1].item() - float(grads["lr"])) <= \
        TOL * abs(float(grads["lr"]))
    if soft:
        _close(got[2], grads["y"])


def test_draw_sequences_are_equal(engines):
    """12 outer steps of each package's loop, its step replaced by one
    that records the snapshots it is given."""
    e = engines
    jeng, teng = e["jeng"], e["teng"]
    traj = np.random.default_rng(0).normal(
        size=(3, 6, teng.n_params)).astype(np.float32)
    n, labels = teng.n_syn, np.asarray(jeng.labels_syn)
    feat = np.zeros((n, teng.d), dtype=np.float32)
    seen_j, seen_t = [], []

    class Init:
        def reduce(self, data, verbose=False):
            return JG.Reduced(feat=jnp.asarray(feat), adj=None,
                              labels=jnp.asarray(labels))

    def fake_jit(f, *a, **kw):
        if f.__name__ != "step":
            return f

        def step(fs, ys, lr, of, oy, ol, start, target, clom):
            seen_j.append((np.asarray(start), np.asarray(target)))
            return fs, ys, lr, of, oy, ol, jnp.float32(1.0)
        return step

    def fake_loss(fs, ys, lr, start, target, clom):
        seen_t.append((start.numpy(), target.numpy()))
        return (fs * 0).sum() + lr * 0 + (ys * 0).sum() + 1.0

    def where(a):
        hit = np.argwhere((traj == a[None, None]).all(-1))
        assert hit.shape[0] == 1
        return tuple(hit[0])

    window = dict(epochs=12, min_start_epoch=2, max_start_epoch=40,
                  max_start_epoch_s=5)
    with mock.patch.object(jeng, "build_buffer", lambda d, v: traj), \
            mock.patch.object(JR, "create_reducer",
                              lambda *a, **kw: Init()), \
            mock.patch.object(jax, "jit", fake_jit), \
            mock.patch.object(jeng, "args", jeng.args.replace(**window)), \
            mock.patch.object(teng, "build_buffer", lambda d, v: traj), \
            mock.patch.object(teng, "init_reduced", lambda v: G.Reduced(
                feat=torch.tensor(feat), adj=None,
                labels=teng.labels_syn)), \
            mock.patch.object(teng, "geom_loss", fake_loss), \
            mock.patch.object(teng, "args", teng.args.replace(**window)):
        jeng._reduce(e["jds"], False)
        teng._reduce(e["tds"], False)
    assert len(seen_j) == len(seen_t) == 12
    draws_j = [(where(s), where(t)) for s, t in seen_j]
    draws_t = [(where(s), where(t)) for s, t in seen_t]
    assert draws_t == draws_j
    assert len({d[0] for d in draws_j}) > 1
