"""The correctness check on the CPU at a tiny size: the program as it is
passes; the control and each fault a cell can have fail it.

Each fault is planted in the timed path underneath a whole run of the
driver (the look for a card skipped): a step that returns its state
unchanged (every optimizer's, or one optimizer's alone), half of each
class's batch left out with the mean over the rest, an answer altered
where the PGE produces it.  The exchange between
cards is no fault of these one-card cells.  The control is the reference
computed in TF32 in the program's place."""

import tempfile
import time

import pytest
import torch

from gsbench_tiny import tiny
from gsbench import calibrate, check, cond_job, manifest

CELLS = {"gcond_arxiv": "gcond_arxiv.r0.01",
         "gcond_reddit": "gcond_reddit.r0.001"}


@pytest.fixture(scope="module")
def twin_root():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(config, root, seed=7):
    cfg, traffic = tiny(config)
    return cond_job.run(cfg, traffic, seed, 0.2, False, "cpu",
                        time.perf_counter(),
                        manifest.limits(CELLS[config]),
                        twin_root=root)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_program_as_it_is_passes(config, twin_root):
    rec = _run(config, twin_root)
    assert rec["correct"], rec["checks"]


def _unchanged(monkeypatch):
    from graphslim_tpu_torch import utils
    monkeypatch.setattr(utils.Adam, "step", lambda self, *a, **k: None)


def _frozen(opt):
    """One optimizer's step returns its state unchanged, the others
    step."""
    def plant(monkeypatch):
        from graphslim_tpu_torch.reduce.cond_base import CondensationBase
        orig = CondensationBase.__init__

        def init(self, *a, **k):
            orig(self, *a, **k)
            getattr(self, opt).step = lambda *a, **k: None
        monkeypatch.setattr(CondensationBase, "__init__", init)
    return plant


def _half_batch(monkeypatch):
    from graphslim_tpu_torch.reduce.cond_base import CondensationBase
    orig = CondensationBase._sample_all_class_blocks

    def half(self, gen):
        ids, ws, targets, valid = orig(self, gen)
        valid = valid.clone()
        valid[:, valid.shape[1] // 2:] = False
        return ids, ws, targets, valid
    monkeypatch.setattr(CondensationBase, "_sample_all_class_blocks", half)


def _altered(monkeypatch):
    from graphslim_tpu_torch.models.pge import PGE
    orig = PGE.apply

    def apply(self, params, x):
        adj = orig(self, params, x)
        flip = torch.zeros_like(adj)
        flip[0, 1] = flip[1, 0] = 1.0
        return adj + flip * (1.0 - 2.0 * adj.detach())
    monkeypatch.setattr(PGE, "apply", apply)


@pytest.mark.parametrize(
    "fault", [_unchanged, _frozen("opt_pge"), _frozen("opt_feat"),
              _frozen("opt_model"), _half_batch, _altered],
    ids=["unchanged", "pge_unchanged", "feat_unchanged", "model_unchanged",
         "half_batch", "altered"])
@pytest.mark.parametrize("config", sorted(CELLS))
def test_each_fault_fails_the_check(config, fault, twin_root, monkeypatch):
    fault(monkeypatch)
    rec = _run(config, twin_root)
    assert not rec["correct"], rec["checks"]


def _control_fails(config, twin_root, device):
    """The control's worst reading of each number against the cell's
    limits, beside the program's own on the same seed."""
    cfg, traffic = tiny(config)
    limits = manifest.limits(CELLS[config])
    recs = calibrate.calibrate(cfg, traffic, [11], 1, device,
                               twin_root=twin_root, emit=lambda r: None)
    prog = [r for r in recs if r["kind"] == "program"][0]
    control = [r for r in recs if r["kind"] == "control"][0]
    zero = dict(sample_invalid=0, start_invalid=0, nonfinite_steps=0)
    return (check.judge(dict(prog, nonfinite_steps=0), limits),
            check.judge({**control, **zero}, limits))


@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_control_fails_the_check(config, twin_root):
    _, control = _control_fails(config, twin_root, "cpu")
    assert not control[0], control[1]


@pytest.mark.cuda
def test_the_control_fails_on_the_card(twin_root):
    """On the card the control's products run in the card's own TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prog, control = _control_fails("gcond_arxiv", twin_root, "cuda")
    assert prog[0], prog[1]
    assert not control[0], control[1]
