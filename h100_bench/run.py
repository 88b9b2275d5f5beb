"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up is timed from here, so it holds the imports of PyTorch and
of the program.
"""

import sys
import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    from h100_bench import harness

    return harness.main(sys.argv[1:] if argv is None else argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
