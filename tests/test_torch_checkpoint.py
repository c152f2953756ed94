"""Train-state checkpoints and ``--resume`` in the port (CPU, synth-hard),
and the evaluation-only entry point ``run_eval``.

Resume is held to bit equality: a run stopped after epoch k and resumed
ends at the same synthetic features, generator parameters, Adam states and
random-generator state as the run that was never stopped.  ``run_eval``
reads a triple that the JAX package's artifact store wrote and must print
the line the port's evaluator gives for it, to the digit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslim_tpu import graph as JG
from graphslim_tpu.data import save_reduced as jsave_reduced
from graphslim_tpu_torch import run_eval
from graphslim_tpu_torch.checkpoint import load_state, save_state
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load, read_npz, save_reduced
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.graph import Reduced
from graphslim_tpu_torch.reduce import create_reducer


def _state():
    gen = torch.Generator().manual_seed(3)
    feat = torch.randn(5, 3, generator=gen).requires_grad_(True)
    pge = {"layers": [{"w": torch.randn(3, 2, generator=gen),
                       "b": torch.zeros(2)}],
           "bns": [{"scale": torch.ones(2), "bias": torch.zeros(2)}]}
    opt = {"m": [torch.randn(5, 3, generator=gen)],
           "v": [torch.rand(5, 3, generator=gen)], "t": 7}
    return (feat, pge, opt, None, gen.get_state())


def _equal(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b) and \
            a.requires_grad == b.requires_grad
    return a == b and type(a) is type(b)


def test_state_round_trips(tmp_path):
    path = str(tmp_path / "s" / "state.npz")
    state = _state()
    save_state(path, state, 4)
    template = tuple(
        torch.zeros_like(x).requires_grad_(x.requires_grad)
        if isinstance(x, torch.Tensor) else x for x in state)
    loaded, epoch = load_state(path, template)
    assert epoch == 4 and _equal(loaded, state)
    assert not (tmp_path / "s" / "state.npz.tmp.npz").exists()


@pytest.mark.parametrize("case", ["missing", "fewer_leaves", "shape",
                                  "garbage", "torn"])
def test_a_file_that_does_not_fit_loads_as_nothing(tmp_path, case, caplog):
    path = str(tmp_path / "state.npz")
    state = _state()
    if case == "fewer_leaves":
        save_state(path, state[:3], 2)
    elif case == "shape":
        save_state(path, (torch.zeros(4, 3),) + state[1:], 2)
    elif case == "garbage":
        with open(path, "wb") as f:
            f.write(b"not an npz")
    elif case == "torn":
        save_state(path, state, 2)
        with open(path, "rb") as f:
            head = f.read()
        with open(path, "wb") as f:
            f.write(head[:len(head) // 2])
    assert load_state(path, state) == (None, 0)
    if case != "missing":
        assert "ignoring" in caplog.text or "failed" in caplog.text


def _args(method, save, epochs, resume=False):
    args = finalize(Args(dataset="synth-hard", method=method, epochs=epochs,
                         hidden=16, outer_loop=2, inner_loop=1,
                         run_inter_eval=1, eval_epochs=3, save_path=save,
                         resume=resume, device="cpu"),
                    {"epochs", "hidden", "outer_loop", "inner_loop",
                     "run_inter_eval", "eval_epochs", "resume"})
    return args.replace(checkpoints=(1, 3))


def _final_state(eng):
    with np.load(eng.state_path()) as blob:
        return {k: blob[k] for k in blob.files}


@pytest.mark.parametrize("method", ["gcond", "doscond", "gcondx"])
def test_resume_is_bit_exact(tmp_path, method):
    """Stopped after epoch 1 (state saved with epoch 2) and resumed to 4
    epochs, the run ends where the uninterrupted 4-epoch run ends."""
    tds = load("synth-hard", seed=0, device="cpu")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    create_reducer(method, tds, _args(method, a, 2)).reduce(tds)
    resumed = create_reducer(method, tds, _args(method, a, 4, resume=True))
    epochs_run = []
    epoch_fn = resumed._epoch
    resumed._epoch = lambda *x, **kw: (epochs_run.append(1),
                                       epoch_fn(*x, **kw))[1]
    resumed.reduce(tds)
    assert len(epochs_run) == 2           # epochs 2 and 3 only
    whole = create_reducer(method, tds, _args(method, b, 4))
    whole.reduce(tds)
    got, want = _final_state(resumed), _final_state(whole)
    assert int(got["__epoch__"]) == int(want["__epoch__"]) == 4
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # without structure the state holds no PGE parameters and no PGE Adam
    # state: features, Adam (m, t, v), None, the generator's state
    n = int(want["__n_leaves__"])
    assert n == 6 if method == "gcondx" else n > 6


def test_resume_without_a_state_starts_afresh(tmp_path):
    tds = load("synth-hard", seed=0, device="cpu")
    eng = create_reducer("doscond", tds,
                         _args("doscond", str(tmp_path), 2, resume=True))
    calls = []
    epoch_fn = eng._epoch
    eng._epoch = lambda *x, **kw: (calls.append(1), epoch_fn(*x, **kw))[1]
    eng.reduce(tds)
    assert len(calls) == 2


@pytest.mark.parametrize("kind", ["dense", "identity"])
def test_run_eval_reads_a_triple_the_jax_package_saved(tmp_path, capsys,
                                                       kind):
    tds = load("synth-hard", seed=0, device="cpu")
    rng = np.random.default_rng(0)
    n_syn = 20
    a = rng.random((n_syn, n_syn)).astype(np.float32)
    jsave_reduced(JG.Reduced(
        feat=jnp.asarray(rng.normal(size=(n_syn, tds.n_feat)),
                         jnp.float32),
        adj=jnp.asarray((a + a.T) / 2) if kind == "dense" else None,
        labels=jnp.asarray(np.arange(n_syn) % tds.nclass, jnp.int32)),
        str(tmp_path), "gcond", "synth-hard", 0.5, 1)
    argv = ["-D", "synth-hard", "-M", "gcond", "-R", "0.5", "--device",
            "cpu", "--save_path", str(tmp_path), "--run_eval", "2",
            "--eval_epochs", "20", "--eval_model", "SGC"]
    mean, std = run_eval.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"gcond on synth-hard r=0\.5 \[SGC\]: "
                     r"(\d+\.\d\d) ± (\d+\.\d\d)", line)
    assert m, line
    args = run_eval.get_args(argv)
    tds = load(args.dataset, setting=args.setting, split=args.split,
               seed=args.seed, pre_norm=args.pre_norm, device="cpu")
    red = read_npz(str(tmp_path / "reduced_graph" / "gcond" /
                       "synth-hard_0.5_1.npz"), device="cpu")
    assert (red.adj is None) == (kind == "identity")
    (want, want_std), _ = Evaluator(tds, args).evaluate(red, "SGC")
    assert (mean, std) == (want, want_std)
    assert m.groups() == (f"{want * 100:.2f}", f"{want_std * 100:.2f}")


@pytest.mark.parametrize("flag", [["--dist_devices", "2"]])
def test_run_eval_refuses_branches_not_ported(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_eval.main(["-D", "synth-hard", "-M", "gcond", "--device", "cpu",
                       "--save_path", str(tmp_path)] + flag)


@pytest.mark.parametrize("present", [True, False])
def test_run_eval_reads_the_attacked_triple(tmp_path, present):
    """``--attack metattack`` reads the triple under
    ``corrupt_graph/metattack/`` (a clean triple beside it is not read),
    and names that path when it is missing."""
    rng = np.random.default_rng(1)
    n_syn, d = 20, load("synth-hard", seed=0, device="cpu").n_feat
    for attack in (None, "metattack") if present else (None,):
        save_reduced(Reduced(
            feat=torch.as_tensor(rng.normal(size=(n_syn, d)),
                                 dtype=torch.float32),
            adj=None, labels=torch.arange(n_syn) % 5),
            str(tmp_path), "gcond", "synth-hard", 0.5, 1, attack=attack)
    argv = ["-D", "synth-hard", "-M", "gcond", "-R", "0.5", "--device",
            "cpu", "--save_path", str(tmp_path), "--run_eval", "1",
            "--eval_epochs", "20", "--eval_model", "SGC", "--attack",
            "metattack"]
    path = (tmp_path / "corrupt_graph" / "metattack" / "reduced_graph" /
            "gcond" / "synth-hard_0.5_1.npz")
    if not present:
        with pytest.raises(FileNotFoundError, match=str(path)):
            run_eval.main(argv)
        return
    got = run_eval.main(argv)
    args = run_eval.get_args(argv)
    tds = load(args.dataset, setting=args.setting, split=args.split,
               seed=args.seed, pre_norm=args.pre_norm, device="cpu")
    (want, want_std), _ = Evaluator(tds, args).evaluate(
        read_npz(str(path), device="cpu"), "SGC")
    assert got == (want, want_std)
