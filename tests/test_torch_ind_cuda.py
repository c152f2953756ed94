"""The inductive setting on the card, on the synth-ind-small twin, against
the port's own CPU path.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_ind_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 12)
runs the inductive twins at full width.

* The views land on the card once, equal to the CPU load; the cached
  subgraph normalizations keep their host mirror, so their blocked
  layouts are built without a read-back.
* The evaluator's val and test forwards on the subgraphs (the blocked
  SpMM, hoisted) score what the CPU scores with the same parameters, to
  one row; macro F1 the same.
* KCenter selects the same local ids on the card as on the CPU, given
  the same embeddings, through the row-gather kernel.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import models as M
from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.graph import host_of
from graphslim_tpu_torch.kernels import smem_gather as SG
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.reduce import create_reducer

pytestmark = pytest.mark.cuda
NAME = "synth-ind-small"


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return load(NAME, seed=0, device="cuda"), load(NAME, seed=0,
                                                   device="cpu")


def test_views_on_the_card_equal_the_cpu_load(pair):
    gpu, cpu = pair
    for split in ("train", "val", "test"):
        assert getattr(gpu, f"feat_{split}").is_cuda
        assert torch.equal(getattr(gpu, f"feat_{split}").cpu(),
                           getattr(cpu, f"feat_{split}"))
        norm = gpu.view_norm(split)
        assert norm.device.type == "cuda"
        assert host_of(norm) is gpu.view_norm_host(split)
        assert torch.equal(norm.val.cpu(), cpu.view_norm(split).val)


@pytest.mark.parametrize("metric", ["accuracy", "f1_macro"])
def test_subgraph_scores_on_the_card_match_the_cpu(pair, metric):
    gpu, cpu = pair
    cfg = M.ModelConfig(nfeat=gpu.n_feat, nhid=32, nclass=gpu.nclass,
                        nlayers=2, dropout=0.0)
    model = M.get_model("GCN", cfg)
    params = model.init(torch.Generator().manual_seed(0))
    params_gpu = utils.tree_map(lambda p: p.cuda(), params)
    SB.reset_launches()
    for split in ("val", "test"):
        got = M.evaluate(model, params_gpu, *gpu.split_batch(split),
                         metric=metric).item()
        want = M.evaluate(model, params, *cpu.split_batch(split),
                          metric=metric).item()
        assert abs(got - want) <= 1.0 / getattr(gpu, f"feat_{split}"
                                                ).shape[0] + 1e-6
    assert SB.LAUNCHES["spmm_blocked"] == 4     # two layers, two splits


def test_kcenter_selects_local_ids_on_the_card(pair, tmp_path):
    gpu, cpu = pair
    base = dict(dataset=NAME, method="kcenter", save_path=str(tmp_path),
                eval_epochs=20)
    emb = np.random.default_rng(3).normal(
        size=(len(gpu.idx_train), 16)).astype(np.float32)
    reds = []
    for ds, dev in ((gpu, "cuda"), (cpu, "cpu")):
        agent = create_reducer("kcenter", ds, finalize(
            Args(**base, device=dev), set(base)))
        agent._embeddings = lambda data, verbose, dev=dev: \
            torch.as_tensor(emb, device=dev)
        SG.reset_launches()
        reds.append(agent.reduce(ds))
        if dev == "cuda":
            # each class's pool, then the selected rows
            assert SG.LAUNCHES["smem_gather"] == ds.nclass + 1
    red_gpu, red_cpu = reds
    assert torch.equal(red_gpu.feat.cpu(), red_cpu.feat)
    assert torch.equal(red_gpu.labels.cpu(), red_cpu.labels)
    assert torch.equal(red_gpu.adj.col.cpu(), red_cpu.adj.col)
