"""Nothing the run path or the reference imports is JAX or the JAX
package, by whole top-level name; the reference imports nothing of the
port."""

import ast
import os
import subprocess
import sys

from gsbench_tiny import ROOT

HERE = os.path.join(ROOT, "gsbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "graphslim_tpu"}


def _top_levels(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_on_the_cpu_loads_no_jax():
    """The driver's whole run at a tiny size, in a fresh process."""
    mods = _top_levels(
        "import sys, tempfile, time\n"
        "sys.path.insert(0, 'gsbench/tests')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from gsbench_tiny import tiny\n"
        "from gsbench import cond_job, manifest, run\n"
        "cfg, tr = tiny('gcond_arxiv')\n"
        "rec = cond_job.run(cfg, tr, 3, 0.5, False, 'cpu', time.perf_counter(),"
        " manifest.limits('gcond_arxiv.r0.01'), twin_root=tempfile.mkdtemp())\n"
        "for m in manifest.benchmark()['end_to_end'] + "
        "manifest.benchmark()['per_layer']:\n"
        "    manifest.reader(m['name'])\n")
    assert "graphslim_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_imports_no_port_and_no_jax():
    mods = _top_levels("import gsbench.reference, gsbench.check")
    assert not mods & (FORBIDDEN | {"graphslim_tpu_torch"})
    for f in ("reference.py", "check.py", "arith.py", "twins.py"):
        tree = ast.parse(open(os.path.join(HERE, f)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0].startswith("graphslim")
                           for n in names), (f, names)


def test_forbidden_names_compare_whole(monkeypatch):
    from gsbench import run

    fake = dict(sys.modules)
    fake.update({"graphslim_tpu_torch.x": None, "jaxtyping": None})
    for k in FORBIDDEN:
        fake.pop(k, None)
        for m in [m for m in fake if m.startswith(k + ".")]:
            fake.pop(m)
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["graphslim_tpu.kernels"] = None
    assert run.forbidden_modules() == ["graphslim_tpu"]
