"""Sketch a GRCh38-shaped FASTA file with the port's CLI and hold the
sketch to the plain reference.

    python3 scripts/grch38_cli_check.py [--seed N] [--dir D] [--counts]

Generates the assembly of the benchmark's ``grch38_k21s1000``
configuration on the card (``h100_bench/generators/chromosomes.py``:
25 records at GRCh38's published lengths, 3,088,286,401 bases, gapped
and soft-masked), writes it as FASTA at 50 columns under D (default: a
new folder under ``$TMPDIR``), runs ``python -m mash_tpu_torch sketch -o
D/grch38 D/grch38.fa`` (the native ingest and ``fold_batches`` route)
and ``info`` on the result, and compares the sketch's hashes and length
with ``h100_bench/reference/assembly.py``.  With ``--counts`` it also
runs ``sketch -M`` (the exact route, which stores each hash's count) and
compares hashes and counts.  Prints a JSON line after each run, the last
one whole; exits 1 on a difference.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100_bench import harness  # noqa: E402
from h100_bench.generators import chromosomes  # noqa: E402
from h100_bench.reference.assembly import assembly_sketch  # noqa: E402
from mash_tpu_torch.io.capnp_msh import read_msh  # noqa: E402

CELL = "sketch_grch38"


def cli(*args, timeout=1800):
    """``python -m mash_tpu_torch`` with ``args``: ``(seconds, stdout)``."""
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "mash_tpu_torch", *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode:
        raise SystemExit("mash_tpu_torch %s failed (%d): %s"
                         % (" ".join(args), p.returncode, p.stderr[-2000:]))
    return time.perf_counter() - t, p.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3_500_000_001)
    ap.add_argument("--dir")
    ap.add_argument("--counts", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device\n")
        return 2
    device = torch.device("cuda:0")
    _c, config, traffic = harness.cell_parts(harness.benchmark(), CELL)
    folder = args.dir or tempfile.mkdtemp(prefix="grch38_")
    os.makedirs(folder, exist_ok=True)
    fasta = os.path.join(folder, "grch38.fa")
    data = chromosomes.generate(config, traffic, args.seed, device)
    with open(fasta, "wb") as f:
        f.write(data.fasta(0))
    want_h, want_c = assembly_sketch(data.genomes[0], config, device)
    length = int(data.lengths()[0])
    del data
    torch.cuda.empty_cache()

    out = {"seed": args.seed, "fasta_bytes": os.path.getsize(fasta),
           "length": length, "device": torch.cuda.get_device_name(device)}
    total = config["total_bases"]
    ok = length == total
    runs = [("sketch", [])] + ([("sketch_M", ["-M"])] if args.counts else [])
    for name, opts in runs:
        msh = os.path.join(folder, name)
        out[name + "_s"], _ = cli("sketch", *opts, "-o", msh, fasta)
        _t, info = cli("info", msh + ".msh")
        ref = read_msh(msh + ".msh").references[0]
        got = {"hashes_equal": bool(np.array_equal(ref.hashes, want_h)),
               "length": int(ref.length),
               "info_has_length": (" %d " % total) in info}
        if opts:
            got["counts_equal"] = ref.counts is not None and bool(
                np.array_equal(ref.counts, want_c))
        out[name] = got
        ok = ok and all(v is True or v == total for v in got.values())
        out["ok"] = ok
        print(json.dumps(out), flush=True)  # one line after each run
    if not args.dir:
        shutil.rmtree(folder)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
