"""The port's degree-bucketed ELL layout, its product and GAT's edge
softmax (``kernels/ell.py``) against the JAX package's (CPU).

* ``build_ell`` gives the JAX layout element for element: each bucket
  part's ids, values and rows, the heavy tail's arrays, its chunks and
  the inverse permutation (trailing zeros row included), at the default
  cap, at ``cap=4`` (the heavy path) and with a small ``max_slots`` (parts
  and chunks split).
* ``spmm_ell``: float32 to 1e-5 against the JAX product and a float64
  dense one; bf16 ``x`` against the JAX bf16 product to 1e-5 (both round
  the inputs to bf16 and sum in float32) and a float32 output.
* ``attention_ell`` on both paths against the JAX function to 1e-5, its
  gradients (dropout 0) against ``jax.grad`` to 1e-4 of the largest; bf16
  messages against the JAX bf16 path to 2e-2 of the largest (bf16 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_shared import one_thread as _one_thread  # noqa: F401

from graphslim_tpu.data import load as jload
from graphslim_tpu.kernels import ell as JE
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import ell as TE

LAYOUTS = {"default": dict(), "cap4": dict(cap=4),
           "cap4_split": dict(cap=4, max_slots=24)}


def _csr(n=90, seed=0):
    """A weighted CSR with empty rows, rows above every cap tried here
    and a few stored zeros."""
    rng = np.random.default_rng(seed)
    deg = rng.choice([0, 1, 2, 3, 5, 9, 17, 40], size=n,
                     p=[.1, .2, .2, .15, .15, .1, .05, .05])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                              for d in deg]).astype(np.int64)
    values = rng.uniform(0.1, 1.0, indices.shape[0]).astype(np.float32)
    values[rng.random(indices.shape[0]) < 0.05] = 0.0
    return indptr, indices, values


def _np(t):
    return None if t is None else np.asarray(t)


def _layouts(kind):
    indptr, indices, values = _csr()
    kw = LAYOUTS[kind]
    return (JE.build_ell(indptr, indices, values, **kw),
            TE.build_ell(indptr, indices, values, device="cpu", **kw))


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_build_ell_equals_jax(kind):
    j, t = _layouts(kind)
    assert len(t.buckets) == len(j.buckets)
    for jb, tb in zip(j.buckets, t.buckets):
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for name in ("inv_perm", "heavy_row", "heavy_col", "heavy_val",
                 "heavy_rows"):
        ja, ta = _np(getattr(j, name)), getattr(t, name)
        if ja is None:
            assert ta is None
        else:
            np.testing.assert_array_equal(ta.numpy(), ja)
    assert (t.n_heavy, t.n_rows, t.heavy_splits) == \
        (j.n_heavy, j.n_rows, j.heavy_splits)
    assert t.nnz == j.nnz
    if kind != "default":
        assert t.heavy_col is not None
    if kind == "cap4_split":
        assert len(t.heavy_splits) > 1
        assert len(t.buckets) > len(_layouts("cap4")[1].buckets)


def test_dataset_layout_equals_jax():
    """The dataset's cached layout of its normalized Â (the bytes rule of
    ``max_slots``) equals the JAX package's."""
    j = jload("synth-hard", seed=0).adj_norm_ell()
    ds = load("synth-hard", seed=0, device="cpu")
    t = ds.adj_norm_ell()
    assert ds.adj_norm_ell() is t
    for jb, tb in zip(j.buckets, t.buckets):
        np.testing.assert_array_equal(tb.idx.numpy(), np.asarray(jb.idx))
        np.testing.assert_array_equal(tb.val.numpy(), np.asarray(jb.val))
    np.testing.assert_array_equal(t.inv_perm.numpy(), np.asarray(j.inv_perm))
    assert len(t.buckets) == len(j.buckets)


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_spmm_ell_matches_jax_and_dense(kind):
    j, t = _layouts(kind)
    indptr, indices, values = _csr()
    n = indptr.shape[0] - 1
    x = np.random.default_rng(1).normal(size=(n, 12)).astype(np.float32)
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    np.add.at(dense, (rows, indices), values)
    got = TE.spmm_ell(t, torch.tensor(x)).numpy()
    jspmm = jax.jit(lambda v: JE.spmm_ell(j, v))
    np.testing.assert_allclose(got, np.asarray(jspmm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, dense @ x, rtol=1e-5, atol=1e-5)
    # bf16 storage of x: float32 sums and a float32 result.  Against the
    # JAX function run eagerly, op by op: jitted, XLA on the CPU fuses the
    # heavy tail's bf16 products into float32 and skips their rounding
    gb = TE.spmm_ell(t, torch.tensor(x).to(torch.bfloat16))
    assert gb.dtype == torch.float32
    want = JE.spmm_ell(j, jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_allclose(gb.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _attention_inputs(n, H=3, h=5, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, H)).astype(np.float32),
            rng.normal(size=(n, H)).astype(np.float32),
            rng.normal(size=(n, H, h)).astype(np.float32),
            rng.normal(size=(n, H, h)).astype(np.float32))


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_attention_ell_and_its_gradients_match_jax(kind):
    j, t = _layouts(kind)
    a_d, a_s, feat, cot = _attention_inputs(j.n_rows)

    def jloss(ad, as_, f):
        return jnp.sum(JE.attention_ell(j, ad, as_, f) * cot)

    # jitted: eager dispatch of the JAX function's ops and their
    # gradients would take a minute here
    want = jax.jit(lambda ad, as_, f: JE.attention_ell(j, ad, as_, f))(
        jnp.asarray(a_d), jnp.asarray(a_s), jnp.asarray(feat))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(a_d), jnp.asarray(a_s), jnp.asarray(feat))
    leaves = [torch.tensor(v, requires_grad=True) for v in (a_d, a_s, feat)]
    with torch.enable_grad():
        got = TE.attention_ell(t, *leaves)
        tg = torch.autograd.grad((got * torch.tensor(cot)).sum(), leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max() + 1e-6


@pytest.mark.parametrize("kind", ["default", "cap4"])
def test_attention_ell_bf16_messages_match_jax(kind):
    j, t = _layouts(kind)
    a_d, a_s, feat, _ = _attention_inputs(j.n_rows, H=2, h=16)
    want = np.asarray(jax.jit(lambda ad, as_, f: JE.attention_ell(
        j, ad, as_, f.astype(jnp.bfloat16)).astype(jnp.float32))(
        jnp.asarray(a_d), jnp.asarray(a_s), jnp.asarray(feat)))
    got = TE.attention_ell(t, torch.tensor(a_d), torch.tensor(a_s),
                           torch.tensor(feat).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= \
        2e-2 * np.abs(want).max()


def test_attention_dropout_draws_a_mask_per_part():
    """Training with dropout: the kept attention weights are scaled by
    1 / (1 - rate), the others zero, and a generator seed repeats."""
    _, t = _layouts("cap4_split")
    a_d, a_s, feat, _ = _attention_inputs(t.n_rows)
    args = [torch.tensor(v) for v in (a_d, a_s, feat)]
    full = TE.attention_ell(t, *args)
    outs = [TE.attention_ell(t, *args, gen=torch.Generator().manual_seed(s),
                             dropout=0.5, training=True) for s in (0, 0, 1)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], full)
    assert torch.equal(TE.attention_ell(t, *args, dropout=0.5,
                                        training=False), full)
