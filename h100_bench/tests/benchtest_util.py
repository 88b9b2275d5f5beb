"""Shared by the benchmark's CPU tests: the repository root on the path,
and each cell's configuration and traffic cut to a size a test run
holds."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's are


def tiny(config: dict, traffic: dict):
    """``(config, traffic)`` with the same keys, and a few genomes and
    reads of short rows against a DB of a few sketches."""
    t = dict(traffic, chunk_len=65536, batch_rows=8)
    if t["driver"] == "sketch":
        t.update(genomes=4, genome_mbase=[0.15, 0.4])
        if t["layout"] == "contigs":
            t.update(records=[5, 20])
        else:
            t.update(plasmid_kbase=[2, 20])
    else:
        t.update(present=4, absent=4, genome_mbase=[0.05, 0.1], parts=3,
                 reads_per_part=2000)
    if "db_sketches" in config:
        config = dict(config, db_sketches=40)
    return config, t
