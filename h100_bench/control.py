"""The control of a cell's comparison, and the faults it has to catch.

The control is the plain reference put in the program's place at half
the hash width the configuration states (32 bits for 64, 16 for 32),
judged as a run's answers are.  It has to come out as not correct; its
readings set the upper end of each limit.  With ``--fault``, each seed
is instead a whole run of the cell (its own sizes, a window of
``--seconds``) with that fault of ``h100_bench.faults`` planted
underneath the timed path, which has to come out as not correct too.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 \\
        [--fault <name> --seconds <s>]

At the cell's own size, on the card; one line of JSON a seed.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control(config, traffic, seed, device) -> dict:
    """``{check: value}`` of the control on the data of ``seed``."""
    from h100_bench.harness import path_modules

    generator, _driver, reference = path_modules(traffic)
    data = generator.generate(config, traffic, seed, device)
    outcome = reference.control_outcome(config, traffic, data, device)
    want = reference.expected(config, traffic, data, outcome, device)
    return reference.judge(outcome, want)


def faulty_run(bench, cell, config, traffic, fault, seed, seconds,
               device) -> dict:
    """A run of ``cell`` with ``fault`` planted: its result line."""
    from h100_bench import faults, harness

    with faults.planted(traffic["driver"], fault):
        result, _checks = harness.run_cell(
            cell, config, traffic, seed, seconds, False, device,
            time.perf_counter(), harness.metrics_of(bench, cell, False))
    return result


def main(argv=None) -> int:
    import torch

    from h100_bench import harness

    ap = argparse.ArgumentParser(prog="python3 -m h100_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device\n")
        return 2
    bench = harness.benchmark()
    cell, config, traffic = harness.cell_parts(bench, args.workload)
    limits = harness.path_modules(traffic)[2].LIMITS
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": cell["name"], "seed": seed}
        if args.fault:
            r = faulty_run(bench, cell, config, traffic, args.fault, seed,
                           args.seconds, device)
            line.update(fault=args.fault, correct=r["correct"],
                        attempted=r["attempted"], failed=r["failed"],
                        checks={k: v["value"]
                                for k, v in r["checks"].items()})
        else:
            found = control(config, traffic, seed, device)
            line.update(correct=all(v <= limits[k]
                                    for k, v in found.items()),
                        checks=found)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
