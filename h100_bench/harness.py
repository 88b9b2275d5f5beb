"""One run of one cell of the benchmark of mash_tpu_torch.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (its ``file``), its traffic (``traffic/<name>.json``),
which names the generator of its data (``generators/<kind>.py``) and the
path it drives (``drivers/<driver>.py``, with its plain reference in
``reference/<driver>.py`` and the faults it has to catch in
``faults/<driver>.py``), and each metric's reader
(``metrics/<metric>.py``).  A later cell, configuration, path or metric
is new files and new entries, not an edit.

A run: the data from the seed; the program's set-up and warm-up; a
window of ``--seconds`` in which the driver feeds the program (with
``--trace 1`` under the profiler, and with the program's stage timings
on); then, with the program's state freed, the reference and the
comparison; and one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "mash_tpu")
# the harness's own threads: few, and the same in every run
TORCH_THREADS = 4


class Spans:
    """The harness's host spans: ``(name, start_ns, end_ns)`` records on
    ``time.time_ns``, the profiler's clock, and seconds and calls by name."""

    def __init__(self):
        self.records = []
        self.totals = {}
        self.calls = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        a = time.time_ns()
        try:
            yield
        finally:
            b = time.time_ns()
            self.records.append((name, a, b))
            self.totals[name] = self.totals.get(name, 0.0) + (b - a) * 1e-9
            self.calls[name] = self.calls.get(name, 0) + 1


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(run)``
    returns a number, or None where the run has nothing to read)."""

    config: dict
    setup_s: float
    window_s: float
    outcome: object
    spans: Spans
    stages: dict = field(default_factory=dict)
    trace: dict | None = None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_parts(bench: dict, name: str):
    """``(cell, config, traffic)`` of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones (a metric without ``workloads``
    goes with every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def path_modules(traffic: dict):
    """``(generator, driver, reference)`` modules of a traffic mix."""
    return (importlib.import_module("h100_bench.generators."
                                    + traffic["kind"]),
            importlib.import_module("h100_bench.drivers."
                                    + traffic["driver"]),
            importlib.import_module("h100_bench.reference."
                                    + traffic["driver"]))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, config, traffic, seed, seconds, trace, device, t_start,
             metric_specs):
    """One run.  Returns ``(result, checks)``: the result line's object
    and ``{check: (value, limit)}``."""
    import torch
    from mash_tpu_torch.utils.profiling import pop_stage_totals

    from h100_bench import trace as tracing

    torch.set_num_threads(TORCH_THREADS)
    generator, driver, reference = path_modules(traffic)
    cuda = device.type == "cuda"
    spans = Spans()
    with spans("generate"):
        data = generator.generate(config, traffic, seed, device)
    if cuda:  # the peak is the program's, from its set-up on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with spans("setup"):
        ctx = driver.setup(config, traffic, data, device, spans)
        _sync(device)
    pop_stage_totals()
    gc.collect()
    gc.freeze()
    gc.disable()
    prof = tracing.start() if trace else None
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    outcome = driver.window(ctx, t0 + seconds, spans)
    _sync(device)
    t1 = time.perf_counter()
    t1_ns = time.time_ns()
    gc.enable()
    stages = pop_stage_totals()
    summary = tracing.finish(prof, spans, t0_ns, t1_ns) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.collect(outcome)
    driver.release(ctx)
    del ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    with spans("reference"):
        want = reference.expected(config, traffic, data, outcome, device)
        found = reference.judge(outcome, want)
    checks = {k: (v, reference.LIMITS[k]) for k, v in found.items()}
    correct = all(v <= lim for v, lim in checks.values())

    run = Run(config, t0 - t_start, t1 - t0, outcome, spans, stages,
              summary)
    metrics = {}
    for m in metric_specs:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    if cuda:
        dev["power_limit_w"] = power_limit()
    result = {"correct": correct, "attempted": outcome.units,
              "failed": reference.failed(found, outcome, correct),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["clock_edges_s"] = summary["edges_s"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stderr.write("phases: %s\n" % ", ".join(
        "%s %.3f s" % (k, spans.totals[k])
        for k in ("generate", "setup", "db_build", "reference")
        if k in spans.totals))
    return result, checks


def power_limit():
    """The card's power limit in watts (``nvidia-smi``), None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = benchmark()
    cell, config, traffic = cell_parts(bench, args.workload)
    trace = args.trace == 1
    # the program reads these when it is imported
    os.environ.pop("MASH_TPU_TORCH_TRACE", None)
    if trace:
        os.environ["MASH_TPU_TORCH_TIMINGS"] = "1"
    else:
        os.environ.pop("MASH_TPU_TORCH_TIMINGS", None)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: this benchmark measures the card "
                         "and has no other path\n")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write("the cell needs %d cards, %d are visible\n"
                         % (cell["chips"], torch.cuda.device_count()))
        return 2
    result, checks = run_cell(cell, config, traffic, args.seed,
                              args.seconds, trace, torch.device("cuda:0"),
                              t_start, metrics_of(bench, cell, trace))
    found = forbidden_modules()
    if found:
        sys.stderr.write("modules loaded that the run may not use: %s\n"
                         % ", ".join(found))
        return 3
    sys.stderr.flush()
    for name, (value, limit) in checks.items():
        sys.stderr.write("check %s: %r (limit %r)\n" % (name, value, limit))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
