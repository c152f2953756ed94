"""NAS and the membership-inference attack on the card against the CPU.

These tests need a CUDA card (marker ``cuda``) and skip without one; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_analysis_cuda.py -m cuda``.  ``chip_smoke.py`` (phase 16)
runs both at full size on the arxiv twin.

* ``NasEvaluator._arch_val`` of two architectures on synth-hard
  (transductive: the full graph through the blocked SpMM) and
  synth-ind-small (inductive), on both graphs, from the same initial
  parameters on both devices: the validation accuracy within two
  validation nodes of the CPU's.
* ``mia_attack`` of one GCN's parameters on both devices: within
  1 / min(n_train, n_test) of the CPU's.
"""

import numpy as np
import pytest
import torch

from graphslim_tpu_torch import graph as G
from graphslim_tpu_torch import models as M
from graphslim_tpu_torch.config import Args, finalize
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.eval import NasEvaluator, mia_attack
from graphslim_tpu_torch.kernels import spmm_blocked as SB
from graphslim_tpu_torch.utils import make_generator, tree_map

pytestmark = pytest.mark.cuda

DATASETS = {"trans": "synth-hard", "ind": "synth-ind-small"}
ARCHS = [(2, 16, 0.1, "relu"), (4, 16, 0.2, "tanh")]


@pytest.fixture(scope="module")
def twins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for setting, name in DATASETS.items():
        pair = {dev: load(name, seed=0, device=dev)
                for dev in ("cpu", "cuda")}
        ds = pair["cpu"]
        feat, adj, labels = ds.train_graph()
        rows = np.arange(30) if setting == "ind" else \
            np.asarray(ds.idx_train)[:30]
        dense = G.submatrix(G.host_of(adj), rows, device="cpu").to_dense()
        idx = torch.as_tensor(rows)
        red = G.Reduced(feat=feat[idx], adj=dense, labels=labels[idx])
        out[setting] = (pair, red)
    return out


def _n_val(ds) -> int:
    return ds.labels_val.shape[0] if ds.setting == "ind" \
        else len(ds.idx_val)


@pytest.mark.parametrize("setting", sorted(DATASETS))
def test_arch_val_on_the_card_matches_the_cpu(twins, setting, tmp_path):
    pair, red = twins[setting]
    draws = {}
    accs = {}
    for dev in ("cpu", "cuda"):
        ds = pair[dev]
        args = finalize(Args(dataset=ds.name, method="random",
                             eval_epochs=40, save_path=str(tmp_path),
                             device=dev), {"eval_epochs"})
        nas = NasEvaluator(ds, args)

        def init(arch, side, model, gen, _dev=dev):
            # the CPU's draw, on both devices
            key = (arch, side)
            if key not in draws:
                draws[key] = model.init(make_generator(0, "cpu"))
            return tree_map(lambda t: t.to(_dev), draws[key])
        nas.init_params = init
        red_d = G.Reduced(feat=red.feat.to(dev), adj=red.adj.to(dev),
                          labels=red.labels.to(dev))
        SB.reset_launches()
        accs[dev] = [(nas._arch_val(a), nas._arch_val(a, red_d))
                     for a in ARCHS]
        if dev == "cuda":
            assert SB.LAUNCHES["spmm_blocked"] > 0
    tol = 2.0 / _n_val(pair["cpu"]) + 1e-6
    assert np.abs(np.asarray(accs["cuda"])
                  - np.asarray(accs["cpu"])).max() <= tol


@pytest.mark.parametrize("setting", sorted(DATASETS))
def test_mia_on_the_card_matches_the_cpu(twins, setting):
    pair, _ = twins[setting]
    ds = pair["cpu"]
    model = M.GCN(M.ModelConfig(nfeat=ds.n_feat, nhid=32,
                                nclass=ds.nclass, dropout=0.0))
    params = model.init(make_generator(0, "cpu"))
    got = {dev: mia_attack(model, tree_map(lambda t: t.to(dev), params),
                           pair[dev]) for dev in ("cpu", "cuda")}
    if setting == "ind":
        n = min(ds.labels_train.shape[0], ds.labels_test.shape[0])
    else:
        n = min(len(ds.idx_train), len(ds.idx_test))
    assert 0.5 <= got["cuda"] <= 1.0
    assert abs(got["cuda"] - got["cpu"]) <= 1.0 / n + 1e-9
