"""The harness finds everything by name in data files: a copied workload
file is a new cell, a metric file dropped into the readers' directory is
read in a traced run; and ``BENCHMARK.json`` keeps to the names, units
and files that its format allows."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from slambench import harness
from slambench.cell import load_cell
from slambench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_slambench_copied_workload_is_a_cell(tmp_path):
    name = tiny.write_cell(tmp_path)
    shutil.copy(tmp_path / "workloads" / f"{name}.json",
                tmp_path / "workloads" / "copied.cell.json")
    cell = tiny.load(tmp_path, "copied.cell")
    assert cell.name == "copied.cell" and cell.config_name == "tiny-fast"
    with pytest.raises(FileNotFoundError):
        tiny.load(tmp_path, "absent.cell")


def test_slambench_dropped_metric_is_read(tmp_path, monkeypatch):
    mdir = tmp_path / "metrics"
    shutil.copytree(harness.METRICS_DIR, mdir)
    (mdir / "drives_in_window.py").write_text(
        'UNIT = "drives"\n\n\ndef read(run):\n    return run.window.drives\n')
    (mdir / "never.py").write_text('UNIT = "%"\n\n\ndef read(run):\n    return None\n')
    monkeypatch.setattr(harness, "METRICS_DIR", mdir)
    cell = tiny.load(tmp_path, tiny.write_cell(tmp_path, frames=16))
    res = harness.run_cell(cell, 11, 0.1, True, "cpu", time.time())
    assert res["metrics"]["drives_in_window"] == {"value": 1.0, "unit": "drives"}
    assert "never" not in res["metrics"]
    assert "step_ms" in res["metrics"] and "busy_s" in res["device"]


def test_slambench_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, [c["name"] for c in BENCH["configs"]],
                  [w["name"] for w in BENCH["workloads"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_slambench_files_agree_with_benchmark_json():
    assert BENCH["paths"] == ["slambench"]
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert "assumed" in f and "slam_config" in f
    for name, w in cells.items():
        cell = load_cell(name)
        assert (cell.config_name, cell.traffic.name, cell.chips, cell.why) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        assert set(cell.limits) == set(__import__("slambench.check").check.LIMITS)
    readers = harness.load_readers()
    for m in BENCH["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        assert set(m.get("workloads", cells)) <= set(cells)
