"""BENCHMARK.json against the contract's form, and every name it uses
found in gsbench/."""

import json
import os
import re

import pytest

from gsbench_tiny import ROOT
from gsbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark(ROOT)


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "gsbench/run.py"]
    assert bench["paths"] == ["gsbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_name_and_unit_is_allowed(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for c in bench["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in bench[group]]
        assert len(seen) == len(set(seen))
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_a_metric_every_listed_cell_reports(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            reported = [e["name"] for e in
                        manifest.reported(bench, cell, trace=False)]
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in manifest.reported(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.reported(bench, w["name"], True)
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_each_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cfg = manifest.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["reduction_rate"] > 0
        lim = manifest.limits(w["name"])
        assert lim["sample_invalid"] == 0 and lim["start_invalid"] == 0
        assert lim["nonfinite_steps"] == 0 and lim["loss_gap"] > 0
        # every group of leaves the stretches step has its change
        # compared, over the three steps or over the first
        for g in ("feat", "pge", "mp"):
            assert {f"change_gap.{g}", f"step_gap.{g}"} & set(lim), g
        assert manifest.driver(cfg).run
    for c in bench["configs"]:
        assert c["file"].startswith("gsbench/configs/")
        cfg = manifest.read_json(os.path.join(ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_every_metric_has_a_reader_that_agrees(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        r = manifest.reader(m["name"])
        assert r.UNIT == m["unit"], m["name"]
        if "layer" in m:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])


def test_the_check_fits_its_time(bench):
    """24 cells at this run length fit the check's 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_shares_are_in_percent(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    json.dumps(bench)
