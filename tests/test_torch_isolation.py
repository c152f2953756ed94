"""The port stands alone: it imports neither JAX nor ``graphslim_tpu``,
its entry points run on the CUDA card unless asked otherwise, and
``chip_smoke.py`` refuses to report without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "graphslim_tpu_torch"


def _run(code: str, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_port_module_keeps_jax_out():
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import graphslim_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'graphslim_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py",
                                       REPO / "tests"
                                       / "torch_dist_ranks.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "graphslim_tpu"), name


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load, read_npz
    from graphslim_tpu_torch.train_all import run

    with pytest.raises(RuntimeError, match="CUDA"):
        load("synth-hard")
    with pytest.raises(RuntimeError, match="CUDA"):
        read_npz(str(REPO / "benchmark" / "artifacts"
                     / "arxiv_gcond_r0.01.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run(finalize(Args(dataset="synth-hard", method="gcond")))
    with pytest.raises(RuntimeError, match="CUDA"):
        run(finalize(Args(dataset="synth-hard", method="kcenter")))


@pytest.mark.parametrize("method", ["doscond", "gcondx", "doscondx",
                                    "gcdm", "gcdmx", "sgdd", "run_eval",
                                    "clustering", "averaging", "vng",
                                    "msgc", "mirage", "gecc", "gcsntk",
                                    "simgc", "sfgc", "geom", "gdem",
                                    "attack", "LargeDataLoader",
                                    "load_data_dir", "wandb", "profile",
                                    "visualization"])
def test_new_entry_points_default_to_the_card(method, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from graphslim_tpu_torch import run_eval, visualization
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.data import load
    from graphslim_tpu_torch.data.largeloader import LargeDataLoader
    from graphslim_tpu_torch.train_all import run

    with pytest.raises(RuntimeError, match="CUDA"):
        if method == "run_eval":
            run_eval.main(["-D", "synth-hard", "-M", "gcond",
                           "--save_path", str(tmp_path)])
        elif method == "attack":
            run(finalize(Args(dataset="synth-hard", attack="metattack",
                              save_path=str(tmp_path))))
        elif method in ("wandb", "profile"):
            run(finalize(Args(dataset="synth-hard", method="kcenter",
                              save_path=str(tmp_path), **{method: True})))
        elif method == "visualization":
            visualization.main(["-D", "synth-hard", "-M", "kcenter",
                                "--save_path", str(tmp_path)])
        elif method == "LargeDataLoader":
            LargeDataLoader(load("synth-hard"))
        elif method == "load_data_dir":
            load("synth-small", data_dir=str(REPO / "tests" / "fixtures"
                                             / "saint-small"))
        else:
            run(finalize(Args(dataset="synth-hard", method=method,
                              save_path=str(tmp_path))))


def _tiny_builders():
    import numpy as np
    import scipy.sparse as sp

    from graphslim_tpu_torch import compat, convert
    from graphslim_tpu_torch import graph as G
    from graphslim_tpu_torch.kernels.spmm_blocked import build_blocked

    ei = np.array([[0, 1, 2], [1, 2, 0]])
    host = G.host_from_edge_index(ei, 3)
    lin = {"layers": [{"w": np.ones((2, 2)), "b": np.zeros(2)}]}
    return {
        "from_edge_index": lambda: G.from_edge_index(ei, 3),
        "from_scipy": lambda: G.from_scipy(sp.eye(3, format="coo")),
        "submatrix": lambda: G.submatrix(host, np.array([0, 1])),
        "pge_params_from_jax": lambda: convert.pge_params_from_jax(
            dict(lin, bns=[{"scale": np.ones(2), "bias": np.zeros(2)}])),
        "model_params_from_jax": lambda: convert.model_params_from_jax(
            "SGC", lin),
        "ignr_params_from_jax": lambda: convert.ignr_params_from_jax(
            {"net0": lin["layers"], "net1": lin["layers"], "bn0": [],
             "bn1": [], "P": np.ones((2, 2))}),
        "build_blocked": lambda: build_blocked(host.indptr, host.col,
                                               host.val),
        "from_torch": lambda: compat.from_torch(
            torch.ones(3, 2), torch.as_tensor(ei), torch.zeros(3)),
        "load_reference_reduced": lambda: compat.load_reference_reduced(
            str(REPO), "gcond", "cora", 0.5),
    }


@pytest.mark.parametrize("name", ["from_edge_index", "from_scipy",
                                  "submatrix",
                                  "pge_params_from_jax",
                                  "model_params_from_jax",
                                  "ignr_params_from_jax",
                                  "build_blocked", "from_torch",
                                  "load_reference_reduced"])
def test_tensor_builders_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_builders()[name]()


@pytest.mark.parametrize("flag", ["--dropout", "--with_bn",
                                  "--weight_decay", "--sinkhorn_iter",
                                  "--balance_alpha"])
def test_cli_rejects_options_nothing_reads(flag, tmp_path):
    from graphslim_tpu_torch.config import get_args

    with pytest.raises(SystemExit):
        get_args(["--save_path", str(tmp_path), flag, "1"])


def test_unported_names_raise_with_their_roadmap_item(tmp_path):
    """Nothing is refused any more: the distributed branches run, and in a
    world of one rank (no launcher) a 2-device mesh raises ``make_mesh``'s
    error, before any work."""
    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.dist import make_mesh
    from graphslim_tpu_torch.eval import Evaluator
    from graphslim_tpu_torch.train_all import run

    with pytest.raises(RuntimeError, match="requested a 2-device mesh"):
        Evaluator(None, None).enable_distributed(make_mesh(2,
                                                           device="cpu"))
    with pytest.raises(RuntimeError, match="requested a 2-device mesh"):
        run(finalize(Args(dataset="synth-small", dist_devices=2,
                          save_path=str(tmp_path), device="cpu")))


@pytest.mark.parametrize("flag", ["wandb", "profile"])
def test_wandb_and_profile_now_run(flag, tmp_path, monkeypatch):
    import math

    from graphslim_tpu_torch.config import Args, finalize
    from graphslim_tpu_torch.train_all import run

    monkeypatch.setitem(sys.modules, "wandb", None)
    mean, std = run(finalize(Args(dataset="synth-small", method="kcenter",
                                  run_eval=1, eval_epochs=5,
                                  save_path=str(tmp_path), device="cpu",
                                  **{flag: True}),
                             {"run_eval", "eval_epochs", flag}))
    assert math.isfinite(mean) and math.isfinite(std)


def _jax_reducer_names():
    from graphslim_tpu.reduce import registry

    return sorted(registry.REGISTRY) + sorted(registry._ALIASES)


@pytest.mark.parametrize("name", _jax_reducer_names())
def test_every_jax_reducer_name_resolves_to_a_port_class(name):
    from graphslim_tpu.reduce.registry import get_method_spec
    from graphslim_tpu_torch.reduce.base import Reducer
    from graphslim_tpu_torch.reduce.registry import reducer_class

    spec = get_method_spec(name)
    for agg in (False, True):
        cls = reducer_class(name, agg)
        assert issubclass(cls, Reducer)
        assert cls.__module__ == f"graphslim_tpu_torch.reduce.{spec.module}"
        assert cls.__name__ == (spec.agg_cls if agg and spec.agg_cls
                                else spec.cls)


@pytest.mark.parametrize("wrapper", ["spmm_blocked", "smem_gather"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel's wrapper launches or raises; only the dispatch above it
    takes the plain version, and only for a CPU tensor."""
    import numpy as np

    from graphslim_tpu_torch import graph as G
    from graphslim_tpu_torch.kernels import smem_gather, spmm_blocked

    x = torch.ones(3, 4)
    if wrapper == "spmm_blocked":
        adj = G.from_edge_index(np.array([[0, 1, 2], [1, 2, 0]]), 3,
                                device="cpu")
        with pytest.raises(ValueError, match="CUDA"):
            spmm_blocked.spmm_blocked_cuda(adj.blocked(), x)
        assert torch.equal(adj.matmul(x), x)
        assert spmm_blocked.LAUNCHES["spmm_blocked"] == 0
    else:
        idx = torch.tensor([2, 0])
        with pytest.raises(ValueError, match="CUDA"):
            smem_gather.gather_rows_cuda(x, idx)
        assert torch.equal(smem_gather.gather_rows(x, idx), x[idx])
        assert smem_gather.LAUNCHES["smem_gather"] == 0


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        script, cwd = REPO / "chip_smoke.py", REPO
    res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
