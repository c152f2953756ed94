"""Cells, configurations, traffic mixes, limits and metric readers, found
by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell
names its configuration (``gsbench/configs/<config>.json``) and its
traffic mix (``gsbench/traffic/<traffic>.json``); its correctness limits
are ``gsbench/limits/<cell>.json``; every metric, end to end or per layer,
is read by ``gsbench/metrics/<metric>.py``.  A configuration names the
driver that runs its job (``gsbench/<driver>.py``).  Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return read_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return read_json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def reported(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell prints: with ``trace`` its per-layer
    metrics, else its end-to-end ones (those without a ``workloads`` list
    are every cell's)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module that reads ``metric``: ``UNIT``, ``LAYER``, ``MOVES``
    and ``read(ctx)``, which returns a number or None where the run gave
    it nothing to read."""
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       f"gsbench_metric_{metric.replace('.', '_')}")


def driver(cfg: dict):
    return importlib.import_module(f"gsbench.{cfg['driver']}")
