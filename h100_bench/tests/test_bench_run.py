"""Whole runs of each path on the CPU at a small size, the look for a
card skipped: a sound program comes out correct; the control, and the
program broken underneath in each way a cell can break, do not.  And
without a card the benchmark stops with no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchtest_util import ROOT, SEED, tiny

from h100_bench import control, faults, harness

BENCH = harness.benchmark()
CELLS = {"sketch": "sketch_refseq_genomes", "screen": "screen_refseq_reads"}


def run(cell, seconds=1):
    c, config, traffic = harness.cell_parts(BENCH, cell)
    config, traffic = tiny(config, traffic)
    result, checks = harness.run_cell(
        c, config, traffic, SEED, seconds, False, torch.device("cpu"),
        time.perf_counter(), harness.metrics_of(BENCH, c, False))
    return result


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_a_sound_program_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) >= {"setup_s"}
    json.dumps(result)


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_the_control_is_not_correct(cell):
    _c, config, traffic = harness.cell_parts(BENCH, cell)
    config, traffic = tiny(config, traffic)
    found = control.control(config, traffic, SEED, torch.device("cpu"))
    limits = harness.path_modules(traffic)[2].LIMITS
    assert any(v > limits[k] for k, v in found.items())


# -- faults planted underneath the timed path ------------------------------

FAULTS = [(cell, name) for cell in sorted(CELLS.values())
          for name in ("state_unchanged", "half_batch", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_program_is_not_correct(cell, fault):
    traffic = harness.cell_parts(BENCH, cell)[2]
    with faults.planted(traffic["driver"], fault):
        result = run(cell)
    assert not result["correct"]
    assert result["failed"] > 0


# -- no card, no result ------------------------------------------------------

def cli(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload",
         "sketch_refseq_genomes", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")


def test_without_a_card_the_run_fails_and_prints_no_result():
    no_card()
    p = cli(ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_a_tree_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h100_bench"),
                    tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = cli(str(tmp_path))
    assert p.returncode != 0 and not p.stdout.strip()


def test_forbidden_modules_are_named_by_their_top_level():
    assert "mash_tpu" not in harness.forbidden_modules()
    sys.modules["mash_tpu_fake_child"] = sys  # a longer name is not a match
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["mash_tpu_fake_child"]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload",
         "sketch_refseq_genomes", "--seed", str(SEED), "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
