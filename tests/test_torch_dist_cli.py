"""``train_all --dist_devices`` from the command line (CPU, gloo).

``torchrun --standalone --nproc-per-node 2 -m graphslim_tpu_torch.train_all
-D synth-small -M gcondx --dist_devices 2 --device cpu`` at a small depth:
two ranks shard GCondX's matching and the evaluator's forwards; rank 0
alone prints the result line and writes the artifact.  Without a launcher
``--dist_devices 2`` raises ``make_mesh``'s error.  Each run is a
subprocess in its own session, killed whole at its time limit.
"""

import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["-D", "synth-small", "-M", "gcondx", "--dist_devices", "2",
        "--device", "cpu", "-E", "3", "--eval_epochs", "50", "--run_eval",
        "2"]
RESULT = re.compile(r"^gcondx on synth-small r=[0-9.]+: ([0-9.]+) ± "
                    r"([0-9.]+)$")


def _run(cmd: list, tmp_path, timeout: float = 240.0):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               HOME=str(tmp_path))
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"timed out after {timeout} s:\n{out}\n{err}")
    return proc.returncode, out, err


def test_torchrun_two_ranks_print_one_result(tmp_path):
    from graphslim_tpu_torch.data import load

    save = tmp_path / "ck"
    rc, out, err = _run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "graphslim_tpu_torch.train_all"]
        + ARGS + ["--save_path", str(save)], tmp_path)
    assert rc == 0, out + err[-4000:]
    lines = [ln for ln in out.splitlines() if RESULT.match(ln)]
    assert len(lines) == 1, out
    acc = float(RESULT.match(lines[0]).group(1)) / 100
    ds = load("synth-small", seed=0, device="cpu")
    test_labels = ds.labels.numpy()[ds.idx_test]
    largest = np.bincount(test_labels).max() / len(test_labels)
    assert acc > largest, (acc, largest)
    arts = list((save / "reduced_graph" / "gcondx").glob("*.npz"))
    assert len(arts) == 1, arts
    logs = list((save / "logs" / "gcondx").glob("*.log"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert text.count("distributed matching over 2 devices") == 1, text


def test_dist_devices_without_a_launcher_raises(tmp_path):
    rc, out, err = _run(
        [sys.executable, "-m", "graphslim_tpu_torch.train_all"] + ARGS
        + ["--save_path", str(tmp_path / "ck")], tmp_path)
    assert rc != 0
    assert "requested a 2-device mesh but only 1 rank(s) exist" in err
    assert not RESULT.search(out)


def test_torchrun_two_ranks_attack_cache_written_once(tmp_path):
    """``--attack random_adj`` under two ranks: rank 0 alone builds the
    attack cache and writes it whole (no temporary file is left), rank 1
    waits at the barrier and reads it, and the run prints one result."""
    save = tmp_path / "ck"
    args = ["-D", "synth-small", "-M", "kcenter", "--attack", "random_adj",
            "--dist_devices", "2", "--device", "cpu", "--eval_epochs",
            "50", "--run_eval", "1", "--save_path", str(save)]
    rc, out, err = _run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "graphslim_tpu_torch.train_all"]
        + args, tmp_path)
    assert rc == 0, out + err[-4000:]
    result = re.compile(r"^kcenter on synth-small r=[0-9.]+: [0-9.]+ ± "
                        r"[0-9.]+$")
    assert len([ln for ln in out.splitlines() if result.match(ln)]) == 1, out
    root = save / "corrupt_graph" / "random_adj"
    assert sorted(p.name for p in root.iterdir()) == [
        "reduced_graph", "synth-small_0.25.npz"]
    with np.load(root / "synth-small_0.25.npz") as blob:
        assert blob["edge_index"].shape[0] == 2
