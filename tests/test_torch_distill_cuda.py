"""GCSNTK, SimGC, SFGC, GEOM and GDEM on the card, on the synth-hard twin,
against the port's own CPU path (the plain versions of the kernels).

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_distill_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 11)
runs the same methods at the arxiv twin's full width.

Tolerances: values computed from the same inputs (KRR, a SimGC step's
loss, an unrolled SFGC/GEOM loss and its gradients, GDEM's loss) within
1e-4 relative; expert buffers within 1e-4 of the largest parameter;
parameters after one Adam step within 1e-2 · lr + 1e-5 (the card's
cuBLAS sums in another order, and a near-zero gradient's step may flip);
the blocked SpMM at d = 1100 within 1e-5 relative of its plain version.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import pge as K
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.models.pge import PGE, PGEConfig
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.reduce import gdem as GD

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture(scope="module")
def twins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return load("synth-hard", seed=0, device="cuda"), \
        load("synth-hard", seed=0, device="cpu")


def _args(method, tmp, device, **kw):
    base = dict(dataset="synth-hard", method=method, hidden=16,
                save_path=str(tmp / device), eval_epochs=20, run_eval=1,
                device=device, **kw)
    return finalize(Args(**base), set(base)).replace(checkpoints=())


def _pair(method, tmp, twins, **kw):
    gpu, cpu = twins
    return (create_reducer(method, gpu, _args(method, tmp, "cuda", **kw)),
            create_reducer(method, cpu, _args(method, tmp, "cpu", **kw)))


def _close(got, ref, tol=TOL):
    got, ref = got.detach().cpu().numpy(), ref.detach().cpu().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


def test_blocked_spmm_at_gdems_width(twins):
    rng = np.random.default_rng(0)
    n, e, d = 6000, 60000, 1100
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    adj = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                       device="cuda"))
    x = torch.randn(n, d, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    SB.reset_launches()
    got = adj.matmul(x)
    assert SB.LAUNCHES_BY_WIDTH == {d: 1}
    _close(got, SB.spmm_blocked_plain(adj.blocked(), x), 1e-5)
    cpu = G.gcn_norm(G.from_edge_index(ei, n, symmetrize=True,
                                       device="cpu"))
    _close(got, cpu.matmul(x.cpu()), 1e-5)


def test_gcsntk_epoch_matches_the_cpu(twins, tmp_path):
    g, c = _pair("gcsntk", tmp_path, twins, epochs=1)
    init = c.init_syn()
    g.init_syn = lambda: tuple(t.cuda() for t in init)
    c.init_syn = lambda: init
    rg, rc = g.reduce(twins[0]), c.reduce(twins[1])
    assert rg.feat.is_cuda and rg.labels.dtype == torch.float32
    tol = 1e-2 * g.args.lr + 1e-5
    for a, b in ((rg.feat, rc.feat), (rg.labels, rc.labels)):
        assert (a.cpu() - b).abs().max() <= tol


@pytest.mark.parametrize("update_pge", [True, False])
def test_simgc_step_matches_the_cpu(twins, tmp_path, update_pge):
    g, c = _pair("simgc", tmp_path, twins, epochs=1)
    n, d = c.n_syn, c.d
    for eng in (g, c):
        eng.pge = PGE(PGEConfig(nfeat=d, nnodes=n, nhid=64))
    teacher, tp = c.train_teacher(twins[1], False)
    stats = c.concat_stats(twins[1])
    _close(g.concat_stats(twins[0])[1], stats[1])
    feat = 0.1 * torch.randn(n, d, generator=torch.Generator().manual_seed(4))
    pge0 = c.pge.init(torch.Generator().manual_seed(2))
    out = {}
    for dev, eng in (("cuda", g), ("cpu", c)):
        fs = feat.to(dev).requires_grad_(True)
        pg = utils.trainable(utils.tree_map(lambda t: t.to(dev), pge0))
        K.reset_launches()
        loss = eng.step(teacher, utils.tree_map(lambda t: t.to(dev), tp),
                        tuple(s.to(dev) for s in stats), fs, pg,
                        eng.opt_feat.init([fs]),
                        eng.opt_pge.init(utils.tree_leaves(pg)), update_pge)
        out[dev] = (loss, fs, pg, dict(K.LAUNCHES))
    assert out["cuda"][3] == {"pge_fwd_ws": 1, "pge_fwd_nows": 0,
                              "pge_bwd": 1}
    assert abs(out["cuda"][0].item() - out["cpu"][0].item()) <= \
        TOL * abs(out["cpu"][0].item())
    lr = c.args.lr_adj if update_pge else c.args.lr_feat
    assert (out["cuda"][1].cpu() - out["cpu"][1]).abs().max() <= \
        1e-2 * lr + 1e-5
    adj_g = g.pge.apply(out["cuda"][2], out["cuda"][1]).cpu()
    adj_c = c.pge.apply(out["cpu"][2], out["cpu"][1])
    assert (adj_g - adj_c).abs().max() <= 1e-3


@pytest.mark.parametrize("method", ["sfgc", "geom"])
def test_trajectory_methods_match_the_cpu(twins, tmp_path, method):
    g, c = _pair(method, tmp_path, twins, teacher_epochs=20, num_experts=2,
                 syn_steps=4, epochs=1)
    inits = c.expert_inits()
    g.expert_inits = lambda: [utils.tree_map(lambda t: t.cuda(), p)
                              for p in inits]
    c.expert_inits = lambda: inits
    SB.reset_launches()
    tg = g.build_buffer(twins[0], False)
    assert SB.LAUNCHES["spmm_blocked"] > 0
    tc = c.build_buffer(twins[1], False)
    _close(torch.tensor(tg), torch.tensor(tc))
    traj = torch.tensor(tc)
    feat = torch.randn(c.n_syn, c.d, generator=torch.Generator()
                       .manual_seed(2))
    grads = {}
    for dev, eng in (("cuda", g), ("cpu", c)):
        fs = feat.to(dev).requires_grad_(True)
        lr = torch.tensor(eng.args.lr_student, device=dev,
                          requires_grad=True)
        tr = traj.to(dev)
        with torch.enable_grad():
            if method == "sfgc":
                loss = eng.match_loss(fs, lr, None, tr[1, 0], tr[1, 2])
                wrt = [fs, lr]
            else:
                ys = eng.soft_label_init(tr, fs.detach()) \
                    .requires_grad_(True)
                loss = eng.geom_loss(fs, ys, lr, tr[1, 0], tr[1, 2],
                                     tr[1, -1])
                wrt = [fs, lr, ys]
            grads[dev] = [loss] + list(torch.autograd.grad(loss, wrt))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a.reshape(-1), b.reshape(-1))
    red = g.reduce(twins[0])
    assert red.feat.is_cuda and torch.isfinite(red.feat).all()


def _ring_graph():
    """The normalized adjacency of the JAX package's eigensolver test
    (a ring with chords and random edges, 1200 nodes)."""
    rng = np.random.default_rng(3)
    n = 1200
    src = np.arange(n)
    rows = np.concatenate([src, src, rng.integers(0, n, 3 * n)])
    cols = np.concatenate([(src + 1) % n, (src + 17) % n,
                           rng.integers(0, n, 3 * n)])
    m = rows != cols
    rows, cols = rows[m], cols[m]
    W = sp.csr_matrix((np.ones(2 * len(rows)),
                       (np.concatenate([rows, cols]),
                        np.concatenate([cols, rows]))), shape=(n, n))
    W.data[:] = 1.0
    W = W + sp.eye(n)
    dinv = 1.0 / np.sqrt(np.asarray(W.sum(1)).ravel())
    return sp.diags(dinv) @ W @ sp.diags(dinv)


def test_gdem_eigensolve_and_epochs_match_the_cpu(twins, tmp_path):
    An = _ring_graph()
    SB.reset_launches()
    vg, _, info = GD.eigsh_smallest(An, 12, "auto", "cuda")
    assert info["backend"] == "device" and not info["arpack"]
    assert SB.LAUNCHES_BY_WIDTH == {20: 26 * info["sweeps"]}  # k + q = 20
    vc, _, _ = GD.eigsh_smallest(An, 12, "device", "cpu")
    np.testing.assert_allclose(np.sort(vg), np.sort(vc), atol=1e-4)

    g, c = _pair("gdem", tmp_path, twins, epochs=2, e1=1, e2=1)
    u0 = c.init_eigenvecs()
    g.init_eigenvecs = lambda: u0.cuda()
    c.init_eigenvecs = lambda: u0
    rg, rc = g.reduce(twins[0]), c.reduce(twins[1])
    assert len(g.losses) == 2
    for a, b in zip(g.losses, c.losses):
        assert abs(a.item() - b.item()) <= TOL * abs(b.item())
    assert rg.adj.is_cuda
    assert (rg.feat.cpu() - rc.feat).abs().max() <= \
        1e-2 * c.args.lr_feat + 1e-5
    # I - U diag(λ) Uᵀ: a sum over eigen_k products, each factor moved by
    # one Adam step
    assert (rg.adj.cpu() - rc.adj).abs().max() <= 1e-3
