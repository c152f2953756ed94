"""SGDD and its IGNR generator in the port against the JAX package (CPU,
synth-hard at n_syn = 40, mx_size = 30, opt_scale 1e-3, at which the
spectral-OT term is several hundred times the adjacency term below).

The port takes the generated adjacency's thresholded inverses from
``eigh`` with a divided-difference backward, the JAX package from an SVD
and its autograd; both run in float32.  Tolerances, measured gaps in
brackets:

* IGNR adjacency, the real corner's ``mx_inv``, ``opt_loss``: 1e-6 of
  the largest entry, exact, 1e-4 relative (1.5e-7, 0, 8.1e-6);
* the gradient of ``generator_forward`` (objective ``Σ adj_norm·R +
  aux``) in float32: every IGNR leaf but ``P`` to 1e-4 of the largest
  such gradient entry (3.4e-5; the biases in front of a BatchNorm have
  gradient 0 analytically, so a leaf-wise relative bound would compare
  rounding noise), the features' gradient to 1e-4 of its largest entry
  (2.0e-5), and ``P``'s to 5e-3 of its largest (1.5e-3: the float32 gap;
  ``P`` reaches the loss only through ``eigvalsh`` of a matrix whose
  small eigenvalues enter under a square root, and the port's float32
  gradient is 1.3e-3 from the float64 one as well);
* the same gradient with both sides in float64 (the JAX side inside
  ``jax.enable_x64``): every leaf to 1e-6 of its group's largest entry
  (2.2e-7);
* ``_pinv_parts`` alone: where the spectrum has no ties, its gradient in
  float64 is the symmetric part of SVD autograd's to 1e-10 (5e-15); at
  tied singular values in float32 (0.5·(1 − I), where SVD autograd is
  NaN, and a planted equal and ± pair) it stays finite and matches
  central differences of a float64 forward along symmetric directions to
  1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import graph as JG
from graphslim_tpu.config import Args as JArgs, finalize as jfinalize
from graphslim_tpu.data import load as jload
from graphslim_tpu.models import ignr as JI
from graphslim_tpu.reduce import create_reducer as jcreate
from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.convert import ignr_params_from_jax
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.models.ignr import _pinv_parts, mx_inv
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce.sgdd import adj_corner

OPT_SCALE = 1e-3
MX = 30


@pytest.fixture(autouse=True)
def _grad_on():
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    common = dict(dataset="synth-hard", method="sgdd",
                  save_path=str(tmp_path_factory.mktemp("sgdd")), hidden=16,
                  reduction_rate=0.4, mx_size=MX, opt_scale=OPT_SCALE,
                  epochs=1)
    explicit = set(common) - {"dataset", "method", "save_path"}
    jds = jload("synth-hard", seed=0)
    tds = load("synth-hard", seed=0, device="cpu")
    jeng = jcreate("sgdd", jds, jfinalize(JArgs(**common), explicit))
    teng = create_reducer("sgdd", tds, finalize(
        Args(**common, device="cpu"), explicit))
    assert teng.n_syn == jeng.n_syn == 40
    # the port carries no sinkhorn_iter: IGNR's loss never reads it
    assert vars(teng.pge.cfg) == {k: v for k, v in vars(jeng.pge.cfg).items()
                                  if k != "sinkhorn_iter"}
    pj = jeng.pge.init(jax.random.key(2))
    pt = ignr_params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    feat = np.asarray(jeng.init_feat_syn())
    R = np.random.default_rng(0).normal(
        size=(teng.n_syn, teng.n_syn)).astype(np.float32)
    corner = np.asarray(jds.adj.to_dense())[:MX, :MX]
    return dict(jeng=jeng, teng=teng, pj=pj, pt=pt, feat=feat, R=R,
                corner=corner)


def test_ignr_adjacency_matches_jax(setup):
    s = setup
    adj_j = np.asarray(s["jeng"].pge.apply(s["pj"], jnp.asarray(s["feat"])))
    adj_t = s["teng"].pge.apply(s["pt"], torch.tensor(s["feat"])).detach()
    assert np.abs(adj_t.numpy() - adj_j).max() <= 1e-6 * np.abs(adj_j).max()
    inf = s["teng"].pge.inference(s["pt"], torch.tensor(s["feat"]))
    assert torch.equal(inf, adj_t) and not inf.requires_grad


def test_mx_inv_and_the_corner_match_jax(setup):
    s = setup
    corner = adj_corner(s["teng"].data.adj_host, MX)
    np.testing.assert_array_equal(corner, s["corner"])
    np.testing.assert_array_equal(s["teng"].lx_inv.numpy(),
                                  np.asarray(s["jeng"].lx_inv))
    # a matrix with one singular value under the threshold, which drops
    rng = np.random.default_rng(1)
    u, _ = np.linalg.qr(rng.normal(size=(MX, MX)))
    v, _ = np.linalg.qr(rng.normal(size=(MX, MX)))
    d = np.linspace(2.0, 0.5, MX)
    d[-1] = 1e-3
    m = (u * d) @ v.T
    with jax.enable_x64():
        want = np.asarray(JI.mx_inv(jnp.asarray(m)))
    got = mx_inv(torch.tensor(m)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(np.linalg.svd(got, compute_uv=False)).max() <= 2.0 + 1e-9


def test_opt_loss_matches_jax(setup):
    s = setup
    adj = np.asarray(s["jeng"].pge.apply(s["pj"], jnp.asarray(s["feat"])))
    want = float(s["jeng"].pge.opt_loss(s["pj"], jnp.asarray(adj),
                                        s["jeng"].lx_inv))
    got = s["teng"].pge.opt_loss(s["pt"], torch.tensor(adj),
                                 s["teng"].lx_inv).item()
    assert abs(got - want) <= 1e-4 * abs(want)


def _svd_pinv_parts(mx, eps=0.009):
    """The JAX package's ``_pinv_parts`` (thresholded SVD) in torch, for
    autograd through the SVD."""
    U, D, Vh = torch.linalg.svd(mx, full_matrices=False)
    dmin = D.min()
    recip = 1.0 / torch.clamp(D, min=1e-12)
    inv = torch.where(D > dmin, recip, torch.zeros_like(D))
    inv = torch.where(dmin >= eps, recip, inv)
    return (U * torch.sqrt(inv)) @ Vh, (U * inv) @ Vh


def _spectrum(case, n=MX):
    """A symmetric matrix: ``J`` is 0.5·(1 − I), 0.5 the adjacency IGNR
    starts near, whose n − 1 eigenvalues −0.5 tie; ``tied`` plants an
    equal pair and a ± pair (equal singular values); ``dropped`` has a
    singular value under the threshold; ``generic`` none of these."""
    if case == "J":
        return 0.5 * (np.ones((n, n)) - np.eye(n))
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.linspace(2.0, 0.5, n) * np.where(np.arange(n) % 3, 1, -1)
    if case == "tied":
        lam[3], lam[10] = lam[4], -lam[11]
    if case == "dropped":
        lam[-1] = 1e-3
    m = (q * lam) @ q.T
    return (m + m.T) / 2


def _pinv_objective(parts, w1, w2):
    rt, inv = parts
    return (w1 * rt).sum() + (w2 * inv).sum()


@pytest.mark.parametrize("case", ["generic", "dropped"])
def test_pinv_parts_gradient_is_svd_autograds(case):
    m = _spectrum(case)
    rng = np.random.default_rng(4)
    w1, w2 = (torch.tensor(rng.normal(size=m.shape)) for _ in range(2))
    a = torch.tensor(m, requires_grad=True)
    b = torch.tensor(m, requires_grad=True)
    ours, ref = _pinv_parts(a), _svd_pinv_parts(b)
    for x, y in zip(ours, ref):
        assert torch.abs(x - y).max() <= 1e-12 * torch.abs(y).max()
    g, = torch.autograd.grad(_pinv_objective(ours, w1, w2), a)
    r, = torch.autograd.grad(_pinv_objective(ref, w1, w2), b)
    r = (r + r.T) / 2
    assert torch.abs(g - r).max() <= 1e-10 * torch.abs(r).max()


@pytest.mark.parametrize("case", ["J", "tied"])
def test_pinv_parts_gradient_stays_finite_at_tied_singular_values(case):
    m = _spectrum(case).astype(np.float32)
    rng = np.random.default_rng(5)
    w1, w2 = (rng.normal(size=m.shape) for _ in range(2))
    t1, t2 = torch.tensor(w1, dtype=torch.float32), \
        torch.tensor(w2, dtype=torch.float32)
    if case == "J":     # exact ties in any precision: what SGDD met
        b = torch.tensor(m, requires_grad=True)
        r, = torch.autograd.grad(
            _pinv_objective(_svd_pinv_parts(b), t1, t2), b)
        assert not torch.isfinite(r).all()
    a = torch.tensor(m, requires_grad=True)
    g, = torch.autograd.grad(_pinv_objective(_pinv_parts(a), t1, t2), a)
    assert torch.isfinite(g).all()

    def f64(x):
        with torch.no_grad():
            return _pinv_objective(_svd_pinv_parts(torch.tensor(x)),
                                   torch.tensor(w1), torch.tensor(w2)).item()

    m64, h = m.astype(np.float64), 1e-6
    for _ in range(3):
        e = rng.normal(size=m.shape)
        e = (e + e.T) / 2
        fd = (f64(m64 + h * e) - f64(m64 - h * e)) / (2 * h)
        assert abs(float((g.double() * torch.tensor(e)).sum()) - fd) <= \
            1e-4 * abs(fd)


def _port_grads(s, dtype):
    teng = s["teng"]
    pt = utils.tree_map(lambda x: x.to(dtype).requires_grad_(True), s["pt"])
    fs = torch.tensor(s["feat"], dtype=dtype, requires_grad=True)
    R = torch.tensor(s["R"], dtype=dtype)
    if dtype == torch.float32:
        adj_norm, aux = teng.generator_forward(pt, fs)
    else:
        adj = teng.pge.apply(pt, fs)
        lx = mx_inv(torch.tensor(s["corner"], dtype=dtype))
        adj_norm = G.normalize_adj_dense(adj)
        aux = OPT_SCALE * teng.pge.opt_loss(pt, adj, lx)
    grads = torch.autograd.grad((adj_norm * R).sum() + aux,
                                utils.tree_leaves(pt) + [fs])
    return [g.numpy() for g in grads]


def _jax_grads(s, dtype):
    jeng, R = s["jeng"], s["R"].astype(dtype)
    pj = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), dtype), s["pj"])
    lx = JI.mx_inv(jnp.asarray(s["corner"], dtype))

    def f(p, fs):
        adj = jeng.pge.apply(p, fs)
        aux = OPT_SCALE * jeng.pge.opt_loss(p, adj, lx)
        return jnp.sum(JG.normalize_adj_dense(adj) * R) + aux

    gp, gf = jax.jit(jax.grad(f, argnums=(0, 1)))(
        pj, jnp.asarray(s["feat"], dtype))
    return [np.asarray(g) for g in jax.tree.leaves(gp)] + [np.asarray(gf)]


def _check(got, want, tol_p, tol_rest):
    """Leaf 0 is P, the last the features; the rest are held to the
    largest gradient entry among them."""
    assert len(got) == len(want) == 22
    assert np.abs(got[0] - want[0]).max() <= tol_p * np.abs(want[0]).max()
    assert np.abs(got[-1] - want[-1]).max() <= \
        tol_rest * np.abs(want[-1]).max()
    scale = max(np.abs(w).max() for w in want[1:-1])
    for g, w in zip(got[1:-1], want[1:-1]):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol_rest * scale


def test_generator_forward_gradient_matches_jax_in_float32(setup):
    s = setup
    adj_norm, aux = s["teng"].generator_forward(
        s["pt"], torch.tensor(s["feat"]))
    term = (adj_norm * torch.tensor(s["R"])).sum()
    assert float(aux) > 100 * abs(float(term))    # the OT term shows
    _check(_port_grads(s, torch.float32), _jax_grads(s, np.float32),
           5e-3, 1e-4)


def test_generator_forward_gradient_matches_jax_in_float64(setup):
    s = setup
    with jax.enable_x64():
        want = _jax_grads(s, np.float64)
    _check(_port_grads(s, torch.float64), want, 1e-6, 1e-6)


def test_sgdd_runs_end_to_end_on_the_cpu(tmp_path):
    tds = load("synth-hard", seed=0, device="cpu")
    args = finalize(Args(dataset="synth-hard", method="sgdd", epochs=2,
                         hidden=16, reduction_rate=0.4, mx_size=MX,
                         outer_loop=2, inner_loop=1, run_inter_eval=1,
                         eval_epochs=5, save_path=str(tmp_path),
                         device="cpu"),
                    {"epochs", "hidden", "mx_size", "outer_loop",
                     "inner_loop", "run_inter_eval", "eval_epochs"})
    eng = create_reducer("sgdd", tds, args)
    red = eng.reduce(tds)
    assert red.feat.shape == (40, tds.n_feat) and red.adj.shape == (40, 40)
    assert torch.isfinite(red.feat).all() and torch.isfinite(red.adj).all()
    assert all(torch.isfinite(x) for x in eng.epoch_loss_sums)
    assert (tmp_path / "reduced_graph" / "sgdd" /
            "synth-hard_0.4_1.npz").exists()
