"""Launch counts of the condensation methods on the card, on the synth-hard
twin, and ``--resume`` restoring the saved state there.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_condense_cuda.py -m cuda``.  ``chip_smoke.py`` checks the
same rules at the arxiv twin's full width.

* DosCond (``alternation = "both"``, ``inner_loop`` forced to 0): each
  outer step launches the PGE forward once keeping the workspace and the
  backward once; forwards without the workspace come only from checkpoints
  and the final adjacency.
* GCondX and DosCondX build no PGE: no PGE launch.
* GCDM with GCN and ``nlayers`` 2: one blocked-SpMM launch per outer step,
  at the hidden width (the real embeddings of layer 0); none at the class
  count and no backward launch.
* SGDD: its thresholded inverses' gradient stays finite at tied
  eigenvalues on the card, and a run on the card ends finite.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.kernels import pge as K
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.reduce import create_reducer

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def ds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return load("synth-hard", seed=0, device="cuda")


def _args(method, tmp, epochs=2, outer=3, checkpoints=(1,), **kw):
    args = finalize(Args(dataset="synth-hard", method=method, epochs=epochs,
                         hidden=32, outer_loop=outer, run_inter_eval=1,
                         eval_epochs=3, save_path=str(tmp), device="cuda",
                         **kw),
                    {"epochs", "hidden", "outer_loop", "run_inter_eval",
                     "eval_epochs", *kw})
    return args.replace(checkpoints=checkpoints)


class _Count:
    def __init__(self, obj, name):
        self.n, self.fn = 0, getattr(obj, name)
        setattr(obj, name, self)

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


def test_doscond_launches_the_pge_once_each_way_a_step(ds, tmp_path):
    args = _args("doscond", tmp_path)
    eng = create_reducer("doscond", ds, args)
    assert eng.args.inner_loop == 0
    inference = _Count(eng, "inference_adj")
    K.reset_launches()
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    steps = args.epochs * args.outer_loop
    assert K.LAUNCHES["pge_fwd_ws"] == K.LAUNCHES["pge_bwd"] == steps
    # one checkpoint, and the final adjacency when it did not improve
    assert K.LAUNCHES["pge_fwd_nows"] == inference.n in (1, 2)
    assert torch.isfinite(red.feat).all() and torch.isfinite(red.adj).all()


@pytest.mark.parametrize("method", ["gcondx", "doscondx"])
def test_structure_free_variants_launch_no_pge(ds, tmp_path, method):
    eng = create_reducer(method, ds, _args(method, tmp_path))
    assert eng.pge is None
    K.reset_launches()
    red = eng.reduce(ds)
    assert sum(K.LAUNCHES.values()) == 0
    assert red.adj is None and torch.isfinite(red.feat).all()


def test_gcdm_launches_one_spmm_at_the_hidden_width_a_step(ds, tmp_path):
    args = _args("gcdm", tmp_path, checkpoints=(), condense_model="GCN",
                 nlayers=2, inner_loop=1)
    eng = create_reducer("gcdm", ds, args)
    eng.adj_norm_full.blocked()          # the layout, built once
    SB.reset_launches()
    red = eng.reduce(ds)
    torch.cuda.synchronize()
    steps = args.epochs * args.outer_loop
    assert SB.LAUNCHES_BY_WIDTH == {args.hidden: steps}
    assert red.adj is None and torch.isfinite(red.feat).all()


def test_resume_restores_the_saved_state(ds, tmp_path):
    create_reducer("doscond", ds, _args("doscond", tmp_path)).reduce(ds)
    eng = create_reducer("doscond", ds,
                         _args("doscond", tmp_path, epochs=3, resume=True))
    first, calls = [], []
    epoch_fn = eng._epoch

    def spy(feat_syn, pge_params, opt_f, opt_p, update_pge):
        calls.append(update_pge)
        if not first:
            first.append((feat_syn.detach().cpu().numpy().copy(),
                          eng.gen.get_state().clone()))
        return epoch_fn(feat_syn, pge_params, opt_f, opt_p, update_pge)

    eng._epoch = spy
    path = eng.state_path()
    with np.load(path) as blob:
        saved = {k: blob[k] for k in blob.files}
    eng.reduce(ds)
    assert int(saved["__epoch__"]) == 2 and len(calls) == 1  # epoch 2
    np.testing.assert_array_equal(first[0][0], saved["leaf_0"])
    n = int(saved["__n_leaves__"])
    np.testing.assert_array_equal(first[0][1].numpy(),
                                  saved[f"leaf_{n - 1}"])


def test_sgdd_pinv_parts_gradient_on_the_card_is_finite_at_ties():
    """0.5·(1 − I) has n − 1 equal eigenvalues (−0.5): the card's float32
    ``eigh`` and the divided-difference backward give a finite gradient,
    within 1e-4 of its largest entry from the float64 one on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphslim_tpu_torch.models.ignr import _pinv_parts

    n = 300
    m = 0.5 * (np.ones((n, n)) - np.eye(n))
    rng = np.random.default_rng(0)
    w1, w2 = rng.normal(size=(n, n)), rng.normal(size=(n, n))

    def grad(dev, dtype):
        a = torch.tensor(m, dtype=dtype, device=dev, requires_grad=True)
        rt, inv = _pinv_parts(a)
        obj = (torch.tensor(w1, dtype=dtype, device=dev) * rt).sum() + \
            (torch.tensor(w2, dtype=dtype, device=dev) * inv).sum()
        return torch.autograd.grad(obj, a)[0].double().cpu()

    got, want = grad("cuda", torch.float32), grad("cpu", torch.float64)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_sgdd_runs_on_the_card(ds, tmp_path):
    args = _args("sgdd", tmp_path, reduction_rate=0.4, mx_size=30)
    red = create_reducer("sgdd", ds, args).reduce(ds)
    assert red.adj.shape == (40, 40) and red.adj.is_cuda
    assert torch.isfinite(red.feat).all() and torch.isfinite(red.adj).all()
