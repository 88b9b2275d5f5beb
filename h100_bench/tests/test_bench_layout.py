"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, generator, driver, reference and metric reader is found by
its name, and the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchtest_util import ROOT

from h100_bench import faults, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"][1:] == ["-m", "h100_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for item in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                 + BENCH["per_layer"]):
        assert NAME.match(item["name"]), item["name"]
        assert item["name"] not in seen
        seen.add(item["name"])
        if "unit" in item:
            assert UNIT.match(item["unit"]) and item["better"] in (
                "lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    c, config, traffic = harness.cell_parts(BENCH, cell)
    assert config["name"] == c["config"]
    generator, driver, reference = harness.path_modules(traffic)
    for fn in ("setup", "window", "collect", "release"):
        assert callable(getattr(driver, fn))
    assert callable(generator.generate)
    assert set(reference.LIMITS) and callable(reference.judge)
    assert callable(reference.failed)
    assert set(faults.of(traffic["driver"])) >= {
        "state_unchanged", "half_batch", "answer_altered"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_reports_its_metrics(cell, trace):
    c = {w["name"]: w for w in BENCH["workloads"]}[cell]
    specs = harness.metrics_of(BENCH, c, trace)
    names = [m["name"] for m in specs]
    if not trace:
        assert "setup_s" in names and len(names) >= 2
    else:
        assert names, "a traced run reports per-layer metrics"
    for m in specs:
        assert callable(harness.reader(m["name"]))


def test_per_layer_metrics_move_a_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("h100_bench/")
        assert os.path.exists(os.path.join(ROOT, f))


def test_paths_hold_only_names_the_contract_allows():
    bad = []
    for folder, _dirs, files in os.walk(os.path.join(ROOT, "h100_bench")):
        if "__pycache__" in folder:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(folder, f), ROOT)
            if not re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel):
                bad.append(rel)
    assert not bad
