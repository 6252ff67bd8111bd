"""The manifest against the benchmark's contract, and finding
configurations, cells and per-layer metrics by name, a throwaway cell
added as files only included."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_manifest_keys_names_and_files():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert not any(w.startswith("/") or ".." in w for w in man["command"])
    assert 1 <= man["run_seconds"] <= 51
    names = [c["name"] for c in man["configs"]]
    assert len(set(names)) == len(names)
    for c in man["configs"]:
        assert set(c) == CONFIG_KEYS and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in man["workloads"])
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == CELL_KEYS and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "workloads"
                / f"{w['name']}.json").is_file()
    e2e = {m["name"] for m in man["end_to_end"]}
    assert {"px_dates_per_s", "setup_s"} <= e2e
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics"
                / f"{m['name']}.py").is_file()
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_each_cell_found_by_name(name):
    spec = harness.cell(name)
    assert spec["workload"]["limits"]
    assert spec["config"]["name"] == spec["entry"]["config"]
    assert harness.scenario_class(spec["config"]).__name__ == "Scenario"
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def _digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(tree.rglob("*")) if p.is_file()}


def test_cell_config_and_metric_added_as_files_only(tmp_path):
    """A later change adds a configuration, a cell and a metric as new
    files plus manifest entries; every file already there stays as it
    was, and the harness finds the new ones by name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    man = harness.manifest()
    conf = json.loads((ROOT / "benchmark/configs/modis_tip_tile.json")
                      .read_text())
    conf["name"] = "modis_tip_small"
    conf["tile"], conf["n_valid"] = [64, 64], 2048
    conf["reduced"] = ["tile", "n_valid"]
    (tmp_path / "benchmark/configs/modis_tip_small.json").write_text(
        json.dumps(conf))
    work = json.loads((ROOT / "benchmark/workloads/"
                       "modis_tip.daily_year.json").read_text())
    work.update(config="modis_tip_small", traffic="weekly",
                obs_step_days=7)
    (tmp_path / "benchmark/workloads/modis_tip_small.weekly.json")\
        .write_text(json.dumps(work))
    (tmp_path / "benchmark/metrics/engine.jobs.py").write_text(
        "def read(run):\n    return run.get('jobs')\n")
    man["configs"].append({"name": "modis_tip_small",
                           "source": conf["source"],
                           "file": "benchmark/configs/modis_tip_small.json",
                           "reduced": conf["reduced"], "why": "test"})
    man["workloads"].append({"name": "modis_tip_small.weekly",
                             "config": "modis_tip_small",
                             "traffic": "weekly", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "engine.jobs", "unit": "jobs",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "px_dates_per_s",
                             "workloads": ["modis_tip_small.weekly"]})
    spec = harness.cell("modis_tip_small.weekly", man,
                        here=tmp_path / "benchmark")
    assert spec["config"]["tile"] == [64, 64]
    assert spec["workload"]["obs_step_days"] == 7
    assert [m["name"] for m in spec["per_layer"]][-1] == "engine.jobs"
    assert "engine.jobs" not in [
        m["name"] for m in harness.cell("modis_tip.daily_year", man,
                                        here=tmp_path / "benchmark")
        ["per_layer"]]
    read = harness.metric_reader("engine.jobs", here=tmp_path / "benchmark")
    assert read({"jobs": 3}) == 3
    after = _digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/modis_tip_small.json",
        "workloads/modis_tip_small.weekly.json", "metrics/engine.jobs.py"}
