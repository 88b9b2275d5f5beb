#!/usr/bin/env python3
"""Smoke test of mash_tpu_torch on one GPU: sketch -> dist, screen, reads,
per-record sketches, triangles, windowed search and containment, then two
ranks on the card and the mesh functions.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N] [--profile | --host-profile]

Phases (any failure exits non-zero before the result lines):

1. device: the card's name and power limit;
2. build: the CUDA kernels (one nvcc per source, in parallel: K1-K6) and
   the native parser library;
3. kernels: each kernel at the main path's shapes against its plain
   PyTorch version on the same inputs (exact equality: every output is an
   integer; the DB table by what it holds, since the atomic inserts
   place the keys of one probe run in any order), timed with CUDA events
   (median of 7 after one warm-up); ``sketch_select`` on one genome
   file's rows, a full 32-row batch, k = 16, one file's rows at
   s = 5000 (m = 128), and the 16-row batches of ``sketch -i`` in the
   64 KiB and 256 KiB buckets; ``pairwise64`` at 64 x 64 and 1024 x 1024 and
   ``pairwise32`` at 1024 x 1024 and at the tile that
   ``stream_pair_stripes`` launches (512 x 4096 rows, 3072 of them
   zero-size pads, and none), each with the kernel's other route (a warp
   a pair) timed beside its thread route; ``screen_table`` on a DB
   of 10^7 hashes and ``screen_count`` on one ``screen`` ingest batch
   against 10^7, 1.1e5 and 23 449 DB hashes, beside a sort of the batch
   and two ``torch.searchsorted`` calls (the yardstick), and again with
   every lane invalid (the batch alone) and without hits; the plain work
   around them (hash pass, cardinality fold) at the screen path's shapes;
   ``hash_windows`` (the window hash, ``ops.kmers.hash_chunk`` on the
   card) on the screen batch [32, 1 MiB] at k = 21 (64-bit, canonical)
   and k = 16 (32-bit), on one 1 MiB row of the exact route and on one
   1 MiB piece of windowed mode's raw bytes; at the screen batch, k = 21,
   what sets its floor (the SASS a window takes by pipe, from
   ``cuobjdump``, its registers and the blocks an SM holds), and on the
   1 MiB rows, where CUDA events time the host's dispatch, the device
   time a launch (``torch.profiler``) and the registers a thread;
   ``fold_sorted`` (K6) on K1's candidates with the certificate (one
   genome file's rows, s = 5000, and the ``sketch -i`` buckets), on the
   state merges of ``sketch`` (6 x 1000), ``screen`` (33 x 1000) and a
   ``-s 100000`` sketch (33 x 100 000), and on the sorted 1 MiB rows of a
   recompute (a file's tail row, a full row), each with the device time a
   launch; then one genome file's device work beside K1 (its batch's
   unpacking, its tail row's recompute, its batch's fold into the state),
   each beside its plain version;
4. end to end through ``mash_tpu_torch.__main__.main``: ``sketch`` of 64
   synthetic 4 Mibase genomes, ``dist`` of those 64 sketches (4096 pairs,
   the 64-bit kernel) and of 1024 sketches with controlled overlap
   (10^6 pairs, rank compression + the 32-bit kernel); cross-checked
   against the CPU's plain path on two genomes and a 128 x 128 block;
5. screen through the same entry point: ``screen`` and ``screen -w`` of
   the 64 genomes (256 Mibase) against a DB of their sketches and 10 000
   random ones (about 10^7 distinct hashes), and ``taxscreen`` against
   the 64 sketches with taxid comments and a tiny taxonomy; ``screen``
   and ``taxscreen`` of one genome cross-checked against the CPU's plain
   path;
6. reads and per-record sketches: ``sketch -r`` (the ingest route) and
   ``sketch -r -m 2`` (hashes on the card, the native heap) of two FASTQ
   files of 500 000 reads of genome 0 (150 Mbase), each read sketch's
   nearest genome and its sharing with 1024 unrelated sketches, and
   ``sketch -i`` of 4096 plasmid-like records (256 families of 16);
   cross-checked against the CPU's plain path on the first 20 000 reads
   and the first 64 records;
7. ``triangle`` of the 4096 record sketches (the streamed path; then
   ``pairwise32`` on its last stripe against its plain version, timed as
   in phase 3), ``triangle -E -d 0.15`` of them (every edge within a
   family) and ``triangle`` of the 64 genome sketches (``pairwise64``);
   cross-checked against the CPU's plain path on the first 128 record
   sketches and the 64 genomes, and ``paste``, ``info`` and ``bounds``
   under the GPU's and the CPU's environment;
8. windowed search and containment: ``sketch -W -s 100`` of the first 16
   genomes (cut from 64: the ``.msw`` writer and the loci index touch
   each locus in Python), ``find -b 1`` of 64 fragments of 10 kb of genome
   0 (1 % substitutions, every other one reverse-complemented) against
   that ``.msw``, and ``find`` against genome 0's FASTA (equal to ``find``
   against its ``.msw``), ``within -s 10000`` of genome 0's FASTA (K1) against
   the 64 genome sketches, and ``within -e 1`` of the 4096 record sketches
   against the 64 genome sketches (262 144 pairs of the plain torch
   ``pairwise_containment``, whose CUDA-event time the line carries, as
   the ``sketch -W`` line carries the windowed hash's); cross-checked
   against the CPU's plain path on genome 0's ``.msw``, ``find`` of 8
   fragments, ``within`` of 128 record sketches and the ``within`` of
   genome 0's FASTA;
9. two ranks and the mesh: ``dist -d 0.15`` of the 4096 record sketches
   against themselves (streamed) in one process, then two processes of
   this script (``--rank-worker``) on the one card, joined by gloo
   (``MASH_TPU_TORCH_COORDINATOR``, ``..._NUM_PROCESSES``,
   ``..._PROCESS_ID``), run ``sketch -r`` of phase 6's two FASTQ files
   (one a rank), ``triangle`` of the 4096 record sketches, that ``dist
   -d 0.15``, ``screen`` and ``taxscreen`` of the 64 genomes (32 a rank),
   ``within -e 1`` of the record sketches against the genomes and
   ``find`` of 8 fragments against genome 0's FASTA; the ``.msh`` must
   equal phase 6's bytes, the stripes (512 rows, alternate ranks) in
   stripe order the single process's stdout, and rank 0's ``screen``,
   ``taxscreen``, ``within`` and ``find`` stdout the single process's,
   rank 1's empty; K1, K3, K4, the window hash and the fold (K6) must
   launch on both ranks.  Each command
   prints both ranks' walls beside the single process's (two ranks on one
   card check the assembly rules; they are no scaling figure).  Then
   ``parallel.mesh``'s ``sharded_sketch_chunks`` ([32, 1 MiB]),
   ``sharded_pairwise`` (64 x 64 and 1024 x 1024) and
   ``sharded_screen_counts`` (one ``screen`` batch against the ~10^7 DB
   in two ranges) over ``[cuda:0, cuda:0]`` must equal the one-device
   route exactly;
10. asynchronous dispatch: every main-path command of phases 4 to 9 must
   print the stdout the synchronous port printed at seed 0, and the
   reads' and records' ``.msh`` files must hold its bytes (rewritten
   under that run's folder name); then ``fold_batches`` over the 64
   genomes' ingest batches, ``triangle`` of the 4096 record sketches
   (stripes at depth 3) and the exact route over the first 10^5 reads of
   ``sketch -r -m 2`` each run as the package dispatches them beside a
   run the harness serializes (``torch.cuda.synchronize()`` after every
   batch and chunk, stripes at depth 1), with equal outputs, each wall
   and device busy share printed; and each of the three paths' steady
   state runs under ``torch.cuda.set_sync_debug_mode("error")``, where
   any host read raises, waiting only through ``Event.synchronize``.

Every kernel's launch count is reset just before each main-path command
of phases 4 to 9 and read just after it; the kernels that command runs
must have launched, and no ``torch.sort`` call of the screen counter may
be left on the screen commands' path.  No main-path command, in one
process or in a rank, may hash or fold on the card with the plain
``hash_chunk_plain`` or ``_fold_sorted`` (under K6's twins): counters of
their calls with a CUDA tensor (``plain_hash_on_card``,
``plain_fold_on_card``) must read 0.  Each main-path command prints one
JSON line with its wall seconds and the wall seconds of its stages
(``mash_tpu_torch.utils.stage``); with ``--profile`` the line also holds
the share of that wall time in which the card ran a kernel
(``torch.profiler``, CUDA activity only), the kernels that took most of
it, the elementwise kernels that took most, and the device time grouped
by kernel family (by kernel name); with
``--host-profile`` it holds the ten host functions (``cProfile``) with the
most time of their own.

The last three lines of stdout are the card's ``nvidia-smi`` name and
power limit, a ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks: HBM bandwidth (NVIDIA data sheet), and the
# rate of one integer pipe: 64 lanes per SM and clock for every 32-bit
# integer add, multiply(-add), shift, logic and compare (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0; the Hopper architecture white paper's 64 INT32 lanes per SM) x 132
# SMs x the 1.98 GHz boost clock at which the data sheet's 67 TFLOP/s
# float32 (128 lanes x 2 FLOPs) holds.  The kernels' operations are
# integer ones, counted in 32-bit instructions on the busier pipe.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_PER_S = 132 * 64 * 1.98e9

K = 21
S = 1000
N_GENOMES = 64
GENOME_LEN = 1 << 22  # 4 Mibase: files clear the 4 MiB fast-ingest gate
N_BIG = 1024
N_SCREEN_SYNTH = 10_000  # random DB sketches beside the 64 genomes'
N_CROSS_SYNTH = 1000
# DB sizes of the screen_count timings: the screen phase's DB (about
# 10^7), a mid-size one, and taxscreen's (the 64 genome sketches)
SCREEN_H = (10_000_000, 110_000, 23_449)
REPEATS = 7
# where the CLI runs: the card, or the plain path of the cross-checks
GPU = {"MASH_TPU_TORCH_DEVICE": "cuda"}
CPU = {"MASH_TPU_TORCH_DEVICE": "cpu"}


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want) -> float:
    """0.0 when the integer outputs are equal, else the largest gap."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


# A probe of sketch_select.cu's MurmurHash3 over one window, beside a
# kernel that only copies, to count the 32-bit instructions of the hash.
HASH_PROBE = r"""
#include "%s"
extern "C" __global__ void probe_copy(const u64* w, u64* o) {
  o[threadIdx.x] = w[threadIdx.x];
}
extern "C" __global__ void probe_hash(const u64* w, u64* o) {
  u64 words[PROBE_NW];
  for (int i = 0; i < PROBE_NW; ++i)
    words[i] = w[threadIdx.x * PROBE_NW + i];
  o[threadIdx.x] = mmh3_h1<PROBE_NW>(words, PROBE_K, 42);
}
"""
# SASS integer opcodes by the pipe that issues them on sm_90: multiplies
# (and the adds and shifts the compiler folds into IMAD) on the FMA pipe,
# adds, logic, shifts, byte permutes and compares on the ALU pipe.  Moves
# (MOV, IMAD.MOV) are left out: the hash needs none of them.
FMA_OPCODES = ("IMAD", "IMUL")
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "SEL", "ISETP",
               "IMNMX", "IABS")


def hash_instructions(k: int, folder: str) -> dict:
    """32-bit integer instructions, by pipe (``{"fma": n, "alu": n}``),
    that ``sketch_select.cu``'s MurmurHash3 takes for one k-byte window,
    as ``nvcc`` compiles it for sm_90a: the integer opcodes in
    ``cuobjdump -sass`` of a kernel that hashes one window, less those of
    one that only copies a word."""
    from mash_tpu_torch.ops import cuda_build

    src = os.path.join(ROOT, "mash_tpu_torch", "ops", "csrc",
                       "sketch_select.cu")
    probe = os.path.join(folder, "hash_probe_k%d.cu" % k)
    cubin = probe[:-3] + ".cubin"
    with open(probe, "w") as f:
        f.write(HASH_PROBE % src)
    nvcc = cuda_build.nvcc()
    built = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-cubin", "-DPROBE_K=%d" % k,
         "-DPROBE_NW=%d" % ((k + 7) // 8), "-o", cubin, probe],
        capture_output=True, text=True, timeout=300)
    require(built.returncode == 0, "hash probe build: %s" % built.stderr)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"fma": 0, "alu": 0}
            continue
        op = line.split("*/", 1)[1].split() if "*/" in line else []
        if op and op[0].startswith("@"):  # a predicate guard
            op = op[1:]
        if not (fn and op) or op[0].startswith("IMAD.MOV"):
            continue
        base = op[0].split(".")[0]
        pipe = ("fma" if base in FMA_OPCODES
                else "alu" if base in ALU_OPCODES else None)
        if pipe:
            counts[fn][pipe] += 1
    hashed, copied = counts.get("probe_hash"), counts.get("probe_copy")
    require(hashed is not None and copied is not None
            and hashed["fma"] > copied["fma"],
            "cuobjdump showed no hash instructions: %s" % counts)
    return {p: max(0, hashed[p] - copied[p]) for p in hashed}


def bound(nbytes: float, nops: float):
    """Least milliseconds for ``nbytes`` of device memory traffic and
    ``nops`` 32-bit integer instructions, and which of the two bounds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_INT32_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def device_profile(fn):
    """Run ``fn()`` under ``torch.profiler``; returns ``(result, wall
    seconds, busy seconds, {kernel name: seconds})``, busy being the
    union of the intervals in which a kernel ran on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        per_name[e.name] = per_name.get(e.name, 0.0) + (b - a) * 1e-6
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return result, wall, busy * 1e-6, per_name


# Kernel families by name, first match wins: the port's own kernels, then
# PyTorch's sorts (torch.sort), top-k selection, elementwise arithmetic
# (the folds and certificates) and copies.
KERNEL_FAMILIES = (
    ("hash_windows", ("hash_windows",)),
    ("fold_sorted", ("fold_sorted",)),
    ("screen_count", ("screen_count",)),
    ("screen_table", ("screen_table",)),
    ("sketch_select", ("sketch_select",)),
    ("pairwise", ("pairwise", "thread_kernel", "warp_kernel")),
    ("sort", ("sort",)),
    ("topk", ("topk",)),
    ("elementwise", ("elementwise",)),
    ("copy", ("memcpy", "memset", "copy")),
)


def kernel_family(name: str) -> str:
    """A kernel name's family (``KERNEL_FAMILIES``, else "other")."""
    low = name.lower()
    return next((f for f, keys in KERNEL_FAMILIES
                 if any(k in low for k in keys)), "other")


def kernel_families(per_name: dict) -> dict:
    """Device seconds by kernel family."""
    out: dict = {}
    for name, secs in per_name.items():
        fam = kernel_family(name)
        out[fam] = out.get(fam, 0.0) + secs
    return out


def timed_cli(name, argv, env, profile, extra=None, stderr=None):
    """``run_cli`` with the command's wall time, stage breakdown and
    stdout hash printed as one JSON line (with ``extra(wall)``'s keys, if
    given); returns stdout, the wall seconds and the line.  ``profile``
    "device" adds the card's busy share (``torch.profiler``), "host" the
    ten host functions with the most time of their own (``cProfile``)."""
    import torch

    from mash_tpu_torch.utils.profiling import (
        counter_totals,
        pop_records,
        pop_stage_totals,
    )

    pop_stage_totals()
    pop_records()
    torch.cuda.synchronize()
    reset_plain_on_card()
    line = {"command": name}
    if profile == "host":
        import cProfile
        import pstats

        prof = cProfile.Profile()
        t0 = time.perf_counter()
        out = prof.runcall(run_cli, argv, env, stderr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
        line["host_top_s"] = {"%s:%d(%s)" % (os.path.basename(f), ln, fn): t
                              for (f, ln, fn), (_, _, t, _, _) in top}
    elif profile == "device":
        out, wall, busy, per_name = device_profile(
            lambda: run_cli(argv, env, stderr))
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
        elementwise = sorted(
            ((n, t) for n, t in per_name.items()
             if kernel_family(n) == "elementwise"), key=lambda kv: -kv[1])
        line.update(device_busy_s=busy, device_busy_share=busy / wall,
                    top_kernels_s=dict(top),
                    top_elementwise_s=dict(elementwise[:10]),
                    kernel_families_s=kernel_families(per_name))
    else:
        t0 = time.perf_counter()
        out = run_cli(argv, env, stderr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the hash of stdout without the run's temporary folder (every path
    # argument lies in it), so that runs and commits compare
    stable = out.replace(os.path.dirname(argv[-1]) + os.sep, "")
    uploads = counter_totals(pop_records()[1])
    line.update(wall_s=wall, stages_s=pop_stage_totals(),
                upload_bytes={route: uploads.get("transfer:%s_bytes" % route,
                                                 0)
                              for route in ("direct", "staged")},
                stdout_sha256=hashlib.sha256(stable.encode()).hexdigest(),
                plain_hash_on_card=PLAIN_ON_CARD["hash_chunk_plain"],
                plain_fold_on_card=PLAIN_ON_CARD["_fold_sorted"])
    require(line["plain_hash_on_card"] == 0, "%s hashed on the card with "
            "the plain pass %d times" % (name, line["plain_hash_on_card"]))
    require(line["plain_fold_on_card"] == 0, "%s folded on the card with "
            "the plain fold %d times" % (name, line["plain_fold_on_card"]))
    if extra is not None:
        line.update(extra(wall))
    print(json.dumps(line), flush=True)
    TIMED[name] = line
    return out, wall, line


# every main-path command's JSON line, by name (phase 10 reads the hashes)
TIMED: dict = {}


def require_upload_route(line, direct: bool) -> None:
    """The command's uploads took the route its input asks for:
    ``IngestPipeline`` batches, which live in pinned memory, go up
    straight from it with no byte staged (``direct``); ``np.frombuffer``
    bytes, which are read-only, are all copied into a pinned slot
    first."""
    got = line["upload_bytes"]
    want, other = ("direct", "staged") if direct else ("staged", "direct")
    require(got[want] > 0 and got[other] == 0,
            "%s uploaded %s, not all %s" % (line["command"], got, want))


def run_cli(argv, env=None, stderr=None) -> str:
    """Drive ``mash_tpu_torch``'s CLI in-process; returns stdout.  With a
    list as ``stderr``, the command's stderr is appended to it (and still
    written to this process's stderr)."""
    from mash_tpu_torch.__main__ import main

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), contextlib.ExitStack() as st:
            if stderr is not None:
                st.enter_context(contextlib.redirect_stderr(err))
            rc = main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if stderr is not None:
            stderr.append(err.getvalue())
            sys.stderr.write(err.getvalue())
    require(rc in (0, None), "mash_tpu_torch %s exited %s" % (argv, rc))
    return buf.getvalue()


# -- inputs ---------------------------------------------------------------

def random_chunks(rng, rows: int, length: int):
    """ACGT bytes with ~0.1% N and some lowercase, like one fold batch."""
    import numpy as np

    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, length))]
    seq[rng.random((rows, length)) < 0.001] = ord("N")
    lower = rng.random((rows, length)) < 0.02
    seq[lower] += 32
    return np.ascontiguousarray(seq)


def overlap_sketches(rng, n: int, s: int, cluster: int = 32):
    """n sorted distinct uint64 sketches of size s in clusters whose
    members share 20-95% of their cluster's center."""
    import numpy as np

    out = np.empty((n, s), dtype=np.uint64)
    for c0 in range(0, n, cluster):
        center = rng.integers(0, 2**64 - 1, s, dtype=np.uint64)
        for i in range(c0, min(n, c0 + cluster)):
            keep = int(s * (0.2 + 0.75 * (i - c0) / max(1, cluster - 1)))
            fresh = rng.integers(0, 2**64 - 1, s - keep, dtype=np.uint64)
            row = np.unique(np.concatenate(
                [rng.choice(center, keep, replace=False), fresh]))
            while row.size < s:  # astronomically rare collision
                row = np.unique(np.concatenate(
                    [row, rng.integers(0, 2**64 - 1, 1, dtype=np.uint64)]))
            out[i] = row[:s]
    return out


def random_sketches(rng, n: int, s: int):
    """n sorted sketches of s random uint64 hashes each: n * s distinct
    hashes, short of a 2^-64 collision."""
    import numpy as np

    out = np.sort(rng.integers(0, 2**64 - 1, (n, s), dtype=np.uint64), 1)
    require(bool(np.all(out[:, 1:] > out[:, :-1])), "random sketch collision")
    return out


def random_i64(n: int, gen):
    """n random int64 bit patterns on the card from ``gen``."""
    import torch

    hi = torch.randint(0, 1 << 32, (n,), generator=gen, device="cuda")
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device="cuda")
    return (hi << 32) | lo


def write_genomes(rng, folder: str):
    """N_GENOMES FASTA files: mutated copies of one random genome."""
    import numpy as np

    base = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i in range(N_GENOMES):
        g = base.copy()
        mut = rng.random(GENOME_LEN) < 0.05 * i / (N_GENOMES - 1)
        g[mut] = (g[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        seq = acgt[g]
        seq[rng.random(GENOME_LEN) < 0.001] = ord("N")
        lo = int(rng.integers(0, GENOME_LEN - 10000))
        seq[lo : lo + 10000] += 32  # a lowercase stretch
        lines = np.full((GENOME_LEN // 64, 65), ord("\n"), np.uint8)
        lines[:, :64] = seq.reshape(-1, 64)
        path = os.path.join(folder, "genome%02d.fa" % i)
        with open(path, "wb") as f:
            f.write(b">genome%02d synthetic mutation copy\n" % i)
            f.write(lines.tobytes())
        paths.append(path)
    return paths


# -- phases ---------------------------------------------------------------

def sketch_select_case(report, chunks, k, use64, s, main, hash_instr,
                       launches_from=None, fold=False):
    """``sketch_select`` and ``sketch_chunks_fused`` on ``chunks`` against
    their plain versions, timed, with the kernel's bound; with ``fold``,
    K6's fold of the candidates (``fold_candidates``) too."""
    import torch

    from mash_tpu_torch.ops import sketch_kernel
    from mash_tpu_torch.ops.sketch_ops import candidate_budget

    rows, length = chunks.shape
    n = length - k + 1
    m = candidate_budget(s, sketch_kernel.C, n)
    kw = dict(alphabet=tuple(b"ACGT"), k=k, seed=42, use64=use64,
              noncanonical=False, preserve_case=False)
    got = sketch_kernel.sketch_select(chunks, **kw, m=m)
    want = sketch_kernel.sketch_select_plain(chunks, **kw, m=m)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0.0, "sketch_select k=%d [%d, %d] disagrees"
            % (k, rows, length))
    fused = sketch_kernel.sketch_chunks_fused(chunks, **kw, s=s)
    plain = sketch_kernel.sketch_chunks_plain(chunks, **kw, s=s)
    require(torch.equal(fused[0], plain[0])
            and torch.equal(fused[1], plain[1]),
            "sketch_chunks_fused k=%d [%d, %d] disagrees" % (k, rows, length))
    ms = cuda_ms(lambda: sketch_kernel.sketch_select(chunks, **kw, m=m))
    plain_ms = cuda_ms(
        lambda: sketch_kernel.sketch_select_plain(chunks, **kw, m=m))
    nbytes = rows * length + got[0].numel() * 8 + got[1].numel() * 8 \
        + got[2].numel() * 4
    # every window's hash on the busier of the two integer pipes; the
    # rolling, canonical choice and selection are left out, so this is
    # a lower bound
    bound_ms, bound_by = bound(nbytes, rows * n * max(hash_instr[k].values()))
    report.append(dict(
        name="sketch_select", shape="[%d, %d] k=%d use64=%s m=%d"
        % (rows, length, k, use64, m), max_abs_err=err, kernel_ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, main=main, launches_from=launches_from))
    if fold:
        from mash_tpu_torch.ops import fold_kernel

        cand, boundary, vcount = got
        R = cand.shape[0] // rows
        fold_case(
            report, "candidates [%d, %d x %d], s=%d" % (rows, R, m, s),
            lambda: fold_kernel.fold_candidates(cand, boundary, vcount, rows,
                                                s),
            lambda: fold_kernel.fold_candidates_plain(cand, boundary, vcount,
                                                      rows, s),
            8 * cand.numel() + 12 * boundary.numel() + (16 * s + 1) * rows,
            cand.numel(), main, launches_from)


def fold_case(report, shape, run, plain, nbytes, entries, main,
              launches_from=None):
    """K6 (``run``) against its twin (``plain``) on the same CUDA tensors
    (exact equality, the ``bad`` mask included), timed with CUDA events
    (which time the host's dispatch where it is the longer), with the
    device time a launch (``torch.profiler`` over 20 launches) and the
    bound of the ``nbytes`` it must move (a 64-bit compare, two 32-bit
    instructions, for each of its ``entries``)."""
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0.0, "fold_sorted %s disagrees" % shape)
    ms, plain_ms = cuda_ms(run), cuda_ms(plain)
    bound_ms, bound_by = bound(nbytes, 2 * entries)
    report.append(dict(
        name="fold_sorted", shape=shape, max_abs_err=err, kernel_ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, main=main, launches_from=launches_from,
        device_ms_a_launch=device_ms(run, "fold_sorted"),
        plain_device_ms=device_ms(plain)))


def device_ms(fn, kernel=None, n=20) -> float:
    """Device milliseconds a call of ``fn`` (``torch.profiler`` over ``n``
    calls): of the kernels whose name holds ``kernel``, else of all."""
    def calls():
        for _ in range(n):
            fn()

    _, _, _, per_name = device_profile(calls)
    return sum(t for name, t in per_name.items()
               if kernel is None or kernel in name) * 1e3 / n


def sorted_states(gen, rows: int, width: int):
    """``(h, c)`` int64 ``[rows, width]`` random states on the card: each
    row sorted in unsigned order, counts 1 to 3."""
    import torch

    from mash_tpu_torch.ops.sketch_ops import biased

    h = biased(torch.sort(biased(random_i64(rows * width, gen)).view(
        rows, width), dim=1).values)
    c = torch.randint(1, 4, (rows, width), generator=gen, device="cuda")
    return h.contiguous(), c


def sorted_row_needs(hs, s: int):
    """``(bytes, entries)`` that K6 must read and write, and the entries
    it must compare, for the sorted rows ``hs`` ``[B, L]`` (G = 1): a
    row's hashes and counts up to the end of its s-th run, or, when it
    has fewer runs, its hashes up to its last run's start and all its
    counts; 16 bytes a slot written."""
    nbytes, entries = 16 * s * hs.shape[0], 0
    for row in hs:
        starts = (row[1:] != row[:-1]).nonzero().flatten() + 1
        starts = [0] + starts.tolist()
        if len(starts) > s:
            nbytes += 16 * starts[s]
            entries += starts[s]
        else:
            nbytes += 8 * (starts[-1] + 1) + 8 * row.numel()
            entries += row.numel()
    return nbytes, entries


def fold_cases(rng, report, chunks, file_rows: int) -> None:
    """K6 at the paths' state merges and sorted rows (its candidate folds
    run in ``sketch_select_case``), then the sketch path's device work
    beside K1 for one genome file, each item beside its plain version:
    the unpacking of its packed batch, the recompute of its tail row and
    the fold of its batch into the state."""
    import torch

    from mash_tpu_torch.core.engine import DEFAULT_CHUNK
    from mash_tpu_torch.ops import fold_kernel, kmers, sketch_kernel
    from mash_tpu_torch.ops import sketch_ops as so

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    # the state merges: sketch's batch (5 rows and the state), screen's
    # (32 rows and the state), and a -s 100000 sketch's screen-sized merge
    for rows, width, frm in ((file_rows + 1, S, None), (33, S, "screen"),
                             (33, 100_000, None)):
        h, c = sorted_states(gen, rows, width)
        fold_case(
            report, "merge %d x %d, s=%d" % (rows, width, width),
            lambda: so.tree_merge(h, c, s=width),
            lambda: fold_kernel.fold_sorted_plain(
                h.view(-1), c.view(-1), width, segments=rows),
            16 * h.numel() + 16 * width, h.numel(), False, frm)
    # the recompute of a row without the certificate (G = 1, after its
    # sort): a file's tail row (80 bytes of sequence, then the batch's
    # zero padding: a few dozen valid windows) and a full row
    kw = dict(alphabet=tuple(b"ACGT"), k=K, seed=42, use64=True,
              noncanonical=False, preserve_case=False)
    tail = torch.zeros((1, DEFAULT_CHUNK), dtype=torch.uint8, device=dev)
    tail[0, :80] = torch.from_numpy(random_chunks(rng, 1, 80)[0]).to(dev)
    full = torch.from_numpy(random_chunks(rng, 1, DEFAULT_CHUNK)).to(dev)
    for name, row in (("tail row", tail), ("full row", full)):
        h, v = kmers.hash_chunk(row, **kw)
        hs, cs = so.sort_unsigned(torch.where(v, h, torch.full_like(
            h, so.EMPTY)), v.long())
        fold_case(
            report, "recompute, %s [1, %d] sorted, s=%d"
            % (name, hs.shape[1], S),
            lambda: fold_kernel.fold_sorted(hs, cs, S),
            lambda: fold_kernel.fold_sorted_plain(hs, cs, S),
            *sorted_row_needs(hs, S), False, None)

    # one genome file of the sketch path beside K1
    packed = torch.randint(0, 256, (file_rows, DEFAULT_CHUNK // 4
                                    + DEFAULT_CHUNK // 8),
                           dtype=torch.uint8, device=dev, generator=gen)
    rows = chunks[:file_rows].contiguous()
    m = so.candidate_budget(S, sketch_kernel.C, DEFAULT_CHUNK - K + 1)
    cand, boundary, vcount = sketch_kernel.sketch_select(rows, **kw, m=m)
    st_h, st_c = sorted_states(gen, 1, S)

    def recompute(fold):
        h, v = kmers.hash_chunk(tail, **kw)
        hs, cs = so.sort_unsigned(torch.where(v, h, torch.full_like(
            h, so.EMPTY)), v.long())
        return fold(hs, cs, S)

    def batch(fold_cand, fold):
        H, C, _ = fold_cand(cand, boundary, vcount, file_rows, S)
        return fold(torch.cat([st_h, H]).view(-1),
                    torch.cat([st_c, C]).view(-1), S,
                    segments=file_rows + 1)

    items = {
        "unpack_chunks [%d, %d]" % tuple(packed.shape):
            lambda: kmers.unpack_chunks(packed, DEFAULT_CHUNK),
        "tail-row recompute (hash_windows, sort, fold_sorted)":
            lambda: recompute(fold_kernel.fold_sorted),
        "tail-row recompute, plain fold":
            lambda: recompute(fold_kernel.fold_sorted_plain),
        "batch fold (fold_candidates, tree_merge %d x %d)"
        % (file_rows + 1, S):
            lambda: batch(fold_kernel.fold_candidates,
                          fold_kernel.fold_sorted),
        "batch fold, plain":
            lambda: batch(fold_kernel.fold_candidates_plain,
                          fold_kernel.fold_sorted_plain),
    }
    print(json.dumps({"sketch_file_items": {
        name: {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}
        for name, fn in items.items()}}), flush=True)


def phase_kernels(rng, report, folder):
    """Each kernel against its plain version at main-path shapes."""
    import numpy as np
    import torch

    from mash_tpu_torch.core.engine import DEFAULT_CHUNK
    from mash_tpu_torch.ops import distance, pairwise_kernel

    dev = torch.device("cuda")
    length = DEFAULT_CHUNK
    full = torch.from_numpy(random_chunks(rng, 32, length)).to(dev)
    # each genome file is one batch of the chunks its windows need; a
    # full 32-row batch (larger files), k = 16 and s = 5000 (m = 128, the
    # block sort instead of the warp merge) are off the main path
    file_rows = -(-(GENOME_LEN - K + 1) // (length - K + 1))
    hash_instr = {k: hash_instructions(k, folder) for k in (K, 16)}
    print("MurmurHash3 32-bit integer instructions per window by pipe "
          "(sm_90a SASS): %s" % json.dumps(hash_instr), flush=True)
    for k, use64, rows, s, main, fold in (
            (K, True, file_rows, S, True, True),
            (K, True, 32, S, False, False), (16, False, 32, S, False, False),
            (K, True, file_rows, 5000, False, True)):
        sketch_select_case(report, full[:rows].contiguous(), k, use64, s,
                           main, hash_instr, fold=fold)

    def pairs(hq, hr, sq, sr, fn, plain_fn, name, width_bytes, main,
              shape=None, other=None):
        """Times ``fn`` (its route for these shapes) and ``plain_fn``, and
        the kernel's ``other`` route beside them if given."""
        nq, nr = sq.numel(), sr.numel()
        got = fn(hq, sq, hr, sr, cap=S)
        want = plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0.0, "%s %dx%d disagrees" % (name, nq, nr))
        ms = cuda_ms(lambda: fn(hq, sq, hr, sr, cap=S))
        plain_ms = cuda_ms(plain_fn)
        extra = {}
        if other:
            err_other = max_abs_err(fn(hq, sq, hr, sr, cap=S, route=other),
                                    want)
            require(err_other == 0.0, "%s %dx%d route %s disagrees"
                    % (name, nq, nr, other))
            extra = {"other_route": other, "other_route_ms": cuda_ms(
                lambda: fn(hq, sq, hr, sr, cap=S, route=other))}
        nbytes = (nq + nr) * hq.shape[1] * width_bytes + (nq + nr) * 4 \
            + 2 * nq * nr * 4
        # the capped walk reads denom + common elements of a pair whose
        # rows are both full (it stops at the cap), none of a pair with a
        # zero-size row
        real = (sq[:, None] > 0) & (sr[None, :] > 0)
        nops = int(((want[0].long() + want[1].long()) * real).sum())
        bound_ms, bound_by = bound(nbytes, nops)
        report.append(dict(
            name=name, shape=shape or "%d x %d, s=%d" % (nq, nr, S),
            max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            main=main, **extra))
        return want

    sk = overlap_sketches(rng, N_BIG, S)
    H = torch.from_numpy(sk.view(np.int64)).to(dev)
    sizes = torch.full((N_BIG,), S, dtype=torch.int32, device=dev)
    small = H[:64].contiguous(), sizes[:64].contiguous()
    pairs(small[0], small[0], small[1], small[1],
          pairwise_kernel.pairwise64,
          lambda: distance.pairwise_common_denom(
              small[0], small[1], small[0], small[1], cap=S),
          "pairwise64", 8, True)
    want64 = pairs(H, H, sizes, sizes,
                   pairwise_kernel.pairwise64,
                   lambda: distance.pairwise_common_denom(
                       H, sizes, H, sizes, cap=S),
                   "pairwise64", 8, False)
    kq, kr = distance.rank_compress(H, H)
    wq = pairwise_kernel.keys32_to_64(kq)
    wr = pairwise_kernel.keys32_to_64(kr)
    # 10^6 pairs take the thread route; the warp route is timed beside it
    want32 = pairs(kq, kr, sizes, sizes,
                   pairwise_kernel.pairwise32,
                   lambda: distance.pairwise_common_denom(
                       wq, sizes, wr, sizes, cap=S),
                   "pairwise32", 4, True, other="warp")
    require(all(torch.equal(a, b) for a, b in zip(want64, want32)),
            "rank_compress changed (common, denom)")
    # from a child generator, so that the later inputs do not depend on
    # the stream tiles' draws
    child = rng.bit_generator.seed_seq.spawn(1)[0]
    stream_tiles(np.random.default_rng(child), pairs)
    # the per-record rows of ``sketch -i`` (16 to a launch) in the 64 KiB
    # and 256 KiB buckets, from a second child generator
    child = np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0])
    for bucket in (1 << 16, 1 << 18):
        rows = torch.from_numpy(random_chunks(child, 16, bucket)).to(dev)
        sketch_select_case(report, rows, K, True, S, False, hash_instr,
                           launches_from="sketch_i", fold=True)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    for H in SCREEN_H:
        screen_count_case(gen, H, H == SCREEN_H[0], report)
    screen_items(rng)
    # the window hash: the screen batch (``full``), then one 1 MiB row of
    # the exact route and one 1 MiB piece of windowed mode, from a third
    # child generator
    for k, use64 in ((K, True), (16, False)):
        hash_windows_case(
            report, full, dict(alphabet=tuple(b"ACGT"), k=k, seed=42,
                               use64=use64, noncanonical=False,
                               preserve_case=False),
            hash_instr, k == K, "[32, 1 MiB] k=%d use64=%s canonical"
            % (k, use64))
    child = np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0])
    row = torch.from_numpy(random_chunks(child, 1, length)[0]).to(dev)
    hash_windows_case(
        report, row, dict(alphabet=tuple(b"ACGT"), k=K, seed=42, use64=True,
                          noncanonical=False, preserve_case=False),
        hash_instr, False, "exact-route row [1 MiB] k=%d" % K,
        launches_from="sketch_reads_m2", one_row=True)
    hash_windows_case(
        report, row, dict(alphabet=(), k=K, seed=42, use64=True,
                          noncanonical=True, preserve_case=True),
        hash_instr, False, "windowed raw piece [1 MiB] k=%d" % K,
        launches_from="sketch_w", one_row=True)
    # K6 at the merges and sorted rows, from a fourth child generator
    fold_cases(np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0]),
               report, full, file_rows)
    print("phase kernels: ok", flush=True)


def stream_tiles(rng, pairs) -> None:
    """``pairwise32`` at the tile that ``stream_pair_stripes`` launches
    (``row_block`` 512 query rows against ``tile_r`` 4096 reference
    rows): a 1024-sketch reference set padded with 3072 zero-size rows,
    and 4096 real rows."""
    import numpy as np
    import torch

    from mash_tpu_torch.ops import distance, pairwise_kernel

    dev = torch.device("cuda")
    sk = overlap_sketches(rng, 4096, S)
    H = torch.from_numpy(sk.view(np.int64)).to(dev)
    full = torch.full((4096,), S, dtype=torch.int32, device=dev)
    for real in (1024, 4096):
        Hr, nr = H.clone(), full.clone()
        Hr[real:], nr[real:] = -1, 0  # EMPTY pads, as _pad_rows_np makes
        kq, kr = distance.rank_compress(H[:512].contiguous(), Hr)
        wq = pairwise_kernel.keys32_to_64(kq)
        wr = pairwise_kernel.keys32_to_64(kr)
        nq = full[:512].contiguous()
        pairs(kq, kr, nq, nr, pairwise_kernel.pairwise32,
              lambda: distance.pairwise_common_denom(wq, nq, wr, nr, cap=S),
              "pairwise32", 4, False,
              "stream tile 512 x 4096 (%d real), s=%d" % (real, S),
              other="warp")


def screen_items(rng) -> None:
    """Prints the device milliseconds of the work beside ``screen_count``
    on the screen path: the hash pass (``hash_chunk``: the kernel
    ``hash_windows``, with its plain twin beside it) and the cardinality
    fold of one ingest batch (``sketch_chunks_deferred``: ``sketch_select``
    and the candidate fold)."""
    import torch

    from mash_tpu_torch.core.engine import DEFAULT_CHUNK
    from mash_tpu_torch.core.loader import _fast_batch_rows
    from mash_tpu_torch.ops import kmers, sketch_kernel

    dev = torch.device("cuda")
    rows = torch.from_numpy(random_chunks(
        rng, _fast_batch_rows(dev), DEFAULT_CHUNK)).to(dev)
    kw = dict(alphabet=tuple(b"ACGT"), k=K, seed=42, use64=True,
              noncanonical=False, preserve_case=False)
    shape = "[%d, %d]" % tuple(rows.shape)
    items = {
        "hash_chunk (hash_windows) " + shape:
            cuda_ms(lambda: kmers.hash_chunk(rows, **kw)),
        "hash_chunk_plain " + shape:
            cuda_ms(lambda: kmers.hash_chunk_plain(rows, **kw)),
        "sketch_chunks_deferred (sketch_select, fold_candidates) " + shape:
            cuda_ms(lambda: sketch_kernel.sketch_chunks_deferred(
                rows, **kw, s=S)),
    }
    print(json.dumps({"screen_items_ms": items}), flush=True)


def cuobjdump(*args) -> str:
    """Standard output of the toolkit's ``cuobjdump`` with ``args``."""
    from mash_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    return subprocess.run([tool, *args], check=True, capture_output=True,
                          text=True, timeout=120).stdout


def kernel_registers(lib: str, instance: str) -> int:
    """Registers per thread of the kernel of the built library ``lib``
    whose mangled name holds ``instance`` (``cuobjdump -res-usage``)."""
    regs, fn = [], None
    for line in cuobjdump("-res-usage", lib).splitlines():
        if "Function " in line:
            fn = line.split("Function ", 1)[1].strip().rstrip(":")
        elif "REG:" in line and fn and instance in fn:
            regs.append(int(line.split("REG:", 1)[1].split()[0]))
    require(len(regs) == 1, "cuobjdump showed %d %s kernels"
            % (len(regs), instance))
    return regs[0]


def hash_windows_floor(lib: str, instance: str, k: int,
                       canonical: bool) -> dict:
    """What sets ``hash_windows``'s floor, for one ``instance`` (at ``k``,
    canonical or not) of the built library ``lib``: the SASS a window
    takes by pipe (``cuobjdump -sass``: the instructions from one hash's
    store to shared memory to the next in the unrolled loop of R = 8
    windows, averaged, the tie branch included), the instance's
    instructions in all, its registers a thread and the blocks an SM
    holds (the kernel's own occupancy query)."""
    import ctypes

    import torch

    from mash_tpu_torch.ops import cuda_build

    ops, fn = [], None
    for line in cuobjdump("-sass", lib).splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        op = line.split("*/", 1)[1].split() if "*/" in line else []
        if op and op[0].startswith("@"):
            op = op[1:]
        if fn and instance in fn and op:
            ops.append(op[0].rstrip(";"))
    stores = [i for i, op in enumerate(ops) if op == "STS.64"]
    require(len(stores) >= 8, "no unrolled window loop in %s" % instance)
    window = {"fma": 0, "alu": 0, "other": 0}
    for op in ops[stores[0]:stores[7]]:  # the loop's 8 hash stores first
        base = op.split(".")[0]
        pipe = ("fma" if base in FMA_OPCODES and not op.startswith(
            "IMAD.MOV") else "alu" if base in ALU_OPCODES else "other")
        window[pipe] += 1
    grid = cuda_build.load("hash_windows").hash_windows_grid
    grid.restype = ctypes.c_int
    blocks = grid(k, int(not canonical))
    require(blocks > 0, "hash_windows_grid failed")
    return {"instance": instance,
            "sass_a_window": {p: c / 7 for p, c in window.items()},
            "sass_in_all": len(ops),
            "registers": kernel_registers(lib, instance),
            "blocks_per_sm": blocks / torch.cuda.get_device_properties(
                0).multi_processor_count}


def hash_windows_case(report, seq, kw, hash_instr, main, shape,
                      launches_from=None, one_row=False):
    """``hash_windows`` on ``seq`` against its twin ``hash_chunk_plain``
    (exact equality of h and v on every window), timed, with its bound:
    the bytes read once and the hashes and flags written once, or the
    hash's instructions a window, whichever is longer.  For ``one_row``
    shapes, whose CUDA-event time is the host's dispatch, the line also
    holds the device time a launch (``torch.profiler`` over 20 launches)
    and the registers per thread of the instance that ran."""
    import torch

    from mash_tpu_torch.ops import cuda_build, hash_kernel, kmers

    got = hash_kernel.hash_windows(seq, **kw)
    want = kmers.hash_chunk_plain(seq, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0.0, "hash_windows %s disagrees" % shape)
    ms = cuda_ms(lambda: hash_kernel.hash_windows(seq, **kw))
    plain_ms = cuda_ms(lambda: kmers.hash_chunk_plain(seq, **kw))
    windows = got[0].numel()
    bound_ms, bound_by = bound(seq.numel() + 9 * windows,
                               windows * max(hash_instr[kw["k"]].values()))
    lib = cuda_build._paths("hash_windows")[1]
    canonical = not kw["noncanonical"]
    instance = "hash_windows_kernelILi%dELb%dE" % (kw["k"], canonical)
    extra = {}
    if main:
        extra = {"floor": hash_windows_floor(lib, instance, kw["k"],
                                             canonical)}
    if one_row:
        def launches():
            for _ in range(20):
                hash_kernel.hash_windows(seq, **kw)

        _, _, _, per_name = device_profile(launches)
        extra = {
            "device_ms_a_launch": sum(
                t for name, t in per_name.items()
                if "hash_windows" in name) * 1e3 / 20,
            "registers": kernel_registers(lib, instance)}
    report.append(dict(
        name="hash_windows", shape=shape, max_abs_err=err, kernel_ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, main=main, launches_from=launches_from, **extra))


def screen_count_case(gen, H: int, main: bool, report):
    """``screen_table`` and ``screen_count`` against their plain versions
    on one ingest batch of the screen path: a random DB of H hashes, one
    of them 2^64-1; a ``[rows, L - K + 1]`` batch with a quarter of its
    hashes planted from the DB (with repeats), some valid 2^64-1 lanes and
    1% invalid ones, in random order; totals starting just below 2^32."""
    import torch

    from mash_tpu_torch.core.engine import DEFAULT_CHUNK
    from mash_tpu_torch.core.loader import _fast_batch_rows
    from mash_tpu_torch.ops import screen_kernel as sk
    from mash_tpu_torch.ops.sketch_ops import EMPTY, biased

    dev = torch.device("cuda")
    rows, n = _fast_batch_rows(dev), DEFAULT_CHUNK - K + 1
    db = biased(torch.unique(biased(random_i64(H - 1, gen))))
    db = torch.cat([db[db != EMPTY],
                    torch.full((1,), EMPTY, dtype=torch.int64, device=dev)])
    H = db.numel()
    h = random_i64(rows * n, gen)
    q = h.numel() // 4
    h[:q] = db[torch.randint(0, H, (q,), generator=gen, device=dev)]
    h[q : q + 1000] = EMPTY
    h = h[torch.randperm(h.numel(), generator=gen, device=dev)].view(rows, n)
    v = torch.rand((rows, n), generator=gen, device=dev) >= 0.01

    table = sk.build_table(db)
    plain_table = sk.build_table_plain(db)
    torch.cuda.synchronize()
    occ, by_index = sk.table_contents(table)
    occ_p, by_index_p = sk.table_contents(plain_table)
    # DB indices whose stored key differs, and slots occupied in one table
    # only
    table_err = float(int((by_index != by_index_p).sum())
                      + int((occ != occ_p).sum()))
    require(table_err == 0.0 and torch.equal(by_index, db),
            "screen_table H=%d disagrees" % H)
    totals0 = torch.randint(2**32 - 1000, 2**32, (H,), generator=gen,
                            device=dev)
    got, want = totals0.clone(), totals0.clone()
    sk.screen_count(h, v, table, got)
    sk.screen_count_plain(h, v, table, want)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    require(err == 0.0, "screen_count n=%d H=%d disagrees" % (h.numel(), H))
    require(int((got - totals0).sum()) >= q * 0.98, "screen_count missed "
            "planted hashes")
    work = totals0.clone()
    ms = cuda_ms(lambda: sk.screen_count(h, v, table, work))
    plain_ms = cuda_ms(lambda: sk.screen_count_plain(h, v, table, work))
    # where the time goes: the batch alone (every lane invalid, so no
    # probe), and probes without hits (random hashes, none from the DB)
    stream_ms = cuda_ms(lambda: sk.screen_count(h, torch.zeros_like(v),
                                                table, work))
    misses = random_i64(h.numel(), gen).view(rows, n)
    nohit_ms = cuda_ms(lambda: sk.screen_count(misses, v, table, work))
    del misses
    # yardstick: the same counts from the unsorted batch with a sort and
    # two searches (the masked keys are made before the clock starts)
    keys = torch.where(v, biased(h), torch.full_like(h, 2**63 - 1)).view(-1)
    sd = biased(db)

    def library():
        sb = torch.sort(keys).values
        return (torch.searchsorted(sb, sd, side="right")
                - torch.searchsorted(sb, sd, side="left"))

    library_ms = cuda_ms(library)
    # what the function must move: the batch read once (8 + 1 bytes a
    # lane), one 32-byte sector a probe that can hit (a valid lane other
    # than 2^64-1) but at most the DB once (8 bytes a hash), and the totals
    # read and written once
    probes = int((v & (h != EMPTY)).sum())
    bound_ms, bound_by = bound(
        9 * h.numel() + min(32 * probes, 8 * H) + 16 * H, h.numel())
    report.append(dict(
        name="screen_count", shape="batch [%d, %d], H=%d" % (rows, n, H),
        max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, main=main,
        stream_ms=stream_ms, nohit_ms=nohit_ms))
    if main:
        ms = cuda_ms(lambda: sk.build_table(db))
        plain_ms = cuda_ms(lambda: sk.build_table_plain(db))
        # the DB read once and the table written once; an insert each
        bound_ms, bound_by = bound(8 * H + 13 * (1 << table.bits), H)
        report.append(dict(
            name="screen_table", shape="H=%d, 2^%d slots" % (H, table.bits),
            max_abs_err=table_err, kernel_ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            main=main))


@contextlib.contextmanager
def sort_sizes():
    """Records, by calling module, the largest input of each
    ``torch.sort`` call made inside the block."""
    import torch

    real, seen = torch.sort, {}

    def sort(x, *args, **kwargs):
        mod = sys._getframe(1).f_globals.get("__name__", "?")
        seen[mod] = max(seen.get(mod, 0), x.numel())
        return real(x, *args, **kwargs)

    torch.sort = sort
    try:
        yield seen
    finally:
        torch.sort = real


def _launch_counters():
    from mash_tpu_torch.ops import (
        fold_kernel,
        hash_kernel,
        pairwise_kernel,
        screen_kernel,
        sketch_kernel,
    )

    return (sketch_kernel.LAUNCHES, pairwise_kernel.LAUNCHES,
            screen_kernel.LAUNCHES, hash_kernel.LAUNCHES,
            fold_kernel.LAUNCHES)


# calls with a CUDA tensor of the plain hash pass and of the plain fold,
# which both of K6's twins run (count_plain_on_card)
PLAIN_ON_CARD = {"hash_chunk_plain": 0, "_fold_sorted": 0}


def count_plain_on_card() -> None:
    """Wraps ``ops.kmers.hash_chunk_plain`` and ``ops.fold_kernel.
    _fold_sorted`` (the plain fold under ``fold_sorted_plain`` and
    ``fold_candidates_plain``), in every module of the package that holds
    them, so that each call with a CUDA tensor adds one to
    ``PLAIN_ON_CARD``: the card's path must hash and fold through the
    kernels."""
    from mash_tpu_torch.commands import command_registry
    from mash_tpu_torch.ops import fold_kernel, kmers

    command_registry()  # every module that may hold the names, first
    for owner, fn in ((kmers, "hash_chunk_plain"),
                      (fold_kernel, "_fold_sorted")):
        real = getattr(owner, fn)

        def counted(x, *args, _real=real, _fn=fn, **kw):
            if x.device.type == "cuda":
                PLAIN_ON_CARD[_fn] += 1
            return _real(x, *args, **kw)

        for name, mod in list(sys.modules.items()):
            if (name.split(".")[0] == "mash_tpu_torch"
                    and getattr(mod, fn, None) is real):
                setattr(mod, fn, counted)


def reset_plain_on_card() -> None:
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0


def reset_launches() -> None:
    for c in _launch_counters():
        for name in c:
            c[name] = 0


def read_launches() -> dict:
    return {name: n for c in _launch_counters() for name, n in c.items()}


def phase_end_to_end(rng, folder, profile=None):
    """sketch -> dist through the CLI, with every counter reset first."""
    import numpy as np

    from mash_tpu_torch.commands import command_registry
    from mash_tpu_torch.core.params import default_nucleotide_params
    from mash_tpu_torch.core.sketch import SketchRef
    from mash_tpu_torch.io import capnp_msh
    from mash_tpu_torch.ops import fold_kernel, pairwise_kernel, sketch_kernel

    t0 = time.perf_counter()
    paths = write_genomes(rng, folder)
    print("wrote %d genomes in %.1f s" % (len(paths),
          time.perf_counter() - t0), flush=True)
    params = default_nucleotide_params(K, S, 42)
    big = overlap_sketches(rng, N_BIG, S)
    refs = [SketchRef(name="s%04d" % i, comment="", length=4_000_000,
                      hashes=big[i]) for i in range(N_BIG)]
    big_msh = os.path.join(folder, "big.msh")
    capnp_msh.write_msh(big_msh, params, refs)
    sub_msh = os.path.join(folder, "sub.msh")
    capnp_msh.write_msh(sub_msh, params, refs[:128])
    all_msh = os.path.join(folder, "all.msh")
    gpu = GPU

    command_registry()  # import every command before the clocks start
    reset_launches()

    _, t_sketch, line = timed_cli(
        "sketch", ["sketch", "-k", str(K), "-s", str(S), "-o", all_msh,
                   *paths], gpu, profile)
    require_upload_route(line, direct=True)
    bases = N_GENOMES * GENOME_LEN
    require(sketch_kernel.LAUNCHES["sketch_select"] > 0,
            "sketch did not launch sketch_select")
    require(fold_kernel.LAUNCHES["fold_sorted"] > 0,
            "sketch did not launch fold_sorted")
    print("sketch: %d bases in %.3f s = %.4g bases/s"
          % (bases, t_sketch, bases / t_sketch), flush=True)

    out, t_dist, _ = timed_cli("dist_4096", ["dist", all_msh, all_msh], gpu,
                            profile)
    require(pairwise_kernel.LAUNCHES["pairwise64"] > 0,
            "dist of 4096 pairs did not launch pairwise64")
    lines = out.splitlines()
    require(len(lines) == N_GENOMES ** 2, "dist printed %d lines"
            % len(lines))
    diag = [ln.split("\t") for ln in lines[:: N_GENOMES + 1]]
    require(all(f[0] == f[1] and f[2:] == ["0", "0", "%d/%d" % (S, S)]
                for f in diag), "dist diagonal is not 0 0 %d/%d" % (S, S))
    print("dist 4096 pairs in %.3f s; e.g. %s" % (t_dist, lines[1]),
          flush=True)

    big_out, t_big, _ = timed_cli("dist_1M", ["dist", big_msh, big_msh], gpu,
                               profile)
    require(pairwise_kernel.LAUNCHES["pairwise32"] > 0,
            "dist of 10^6 pairs did not launch pairwise32")
    big_lines = big_out.splitlines()
    require(len(big_lines) == N_BIG ** 2, "big dist printed %d lines"
            % len(big_lines))
    print("dist %d pairs in %.3f s = %.4g pairs/s"
          % (N_BIG ** 2, t_big, N_BIG ** 2 / t_big), flush=True)
    launches = read_launches()
    print("main-path launches: %s" % json.dumps(launches), flush=True)

    # cross-checks against the CPU's plain path
    cpu = CPU
    two_gpu = os.path.join(folder, "two_gpu.msh")
    two_cpu = os.path.join(folder, "two_cpu.msh")
    run_cli(["sketch", "-o", two_gpu, *paths[:2]], gpu)
    run_cli(["sketch", "-o", two_cpu, *paths[:2]], cpu)
    with open(two_gpu, "rb") as a, open(two_cpu, "rb") as b:
        require(a.read() == b.read(), "GPU and CPU .msh bytes differ")
    sub_out = run_cli(["dist", sub_msh, sub_msh], cpu).splitlines()
    block = [big_lines[i * N_BIG + j] for i in range(128)
             for j in range(128)]
    require(sub_out == block, "128 x 128 block differs from the CPU's")
    msh = capnp_msh.read_msh(all_msh)
    require(len(msh.references) == N_GENOMES
            and all(len(r.hashes) == S
                    and np.all(r.hashes[1:] > r.hashes[:-1])
                    for r in msh.references),
            "all.msh does not hold %d sorted sketches of %d" % (N_GENOMES, S))
    print("phase end to end: ok", flush=True)
    return launches, paths, all_msh


TAX_NODES = ("1\t|\t1\t|\tno rank\t|\n561\t|\t1\t|\tgenus\t|\n"
             "562\t|\t561\t|\tspecies\t|\n563\t|\t561\t|\tspecies\t|\n")
TAX_NAMES = ("1\t|\troot\t|\t\t|\tscientific name\t|\n"
             "561\t|\tEscherichia\t|\t\t|\tscientific name\t|\n"
             "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n"
             "563\t|\tEscherichia other\t|\t\t|\tscientific name\t|\n")


def phase_screen(rng, folder, paths, all_msh, profile=None):
    """screen, screen -w and taxscreen of the 64 genomes through the CLI,
    each with every launch counter reset just before it; then screen and
    taxscreen of one genome on the card and on the CPU."""
    import dataclasses

    import numpy as np

    from mash_tpu_torch.core.sketch import SketchRef
    from mash_tpu_torch.io import capnp_msh

    genomes = capnp_msh.read_msh(all_msh)
    params = genomes.params
    synth = random_sketches(rng, N_SCREEN_SYNTH, S)

    def synth_refs(m, comment=""):
        return [SketchRef(name="synth%05d" % i, comment=comment,
                          length=4_000_000, hashes=synth[i])
                for i in range(m)]

    # taxids: the first half of the genomes one species, the rest another
    tax_refs = [dataclasses.replace(
        r, comment="taxid %d" % (562 if i < N_GENOMES // 2 else 563))
        for i, r in enumerate(genomes.references)]
    db_msh, tax_msh, cross_msh = (os.path.join(folder, n) for n in (
        "screen_db.msh", "tax_db.msh", "cross_db.msh"))
    capnp_msh.write_msh(db_msh, params,
                        genomes.references + synth_refs(N_SCREEN_SYNTH))
    capnp_msh.write_msh(tax_msh, params, tax_refs)
    capnp_msh.write_msh(cross_msh, params,
                        tax_refs + synth_refs(N_CROSS_SYNTH, "taxid 561"))
    taxdir = os.path.join(folder, "taxonomy")
    os.makedirs(taxdir)
    with open(os.path.join(taxdir, "nodes.dmp"), "w") as f:
        f.write(TAX_NODES)
    with open(os.path.join(taxdir, "names.dmp"), "w") as f:
        f.write(TAX_NAMES)
    genome_hashes = np.unique(np.concatenate(
        [r.hashes for r in genomes.references]))
    union = len(genome_hashes)
    db_hashes = len(np.unique(np.concatenate([synth.ravel(),
                                              genome_hashes])))
    bases = N_GENOMES * GENOME_LEN

    def run_screen(name, argv):
        counts = {}
        with sort_sizes() as sorts:
            out, line = counted_cli(
                name, argv, SCREEN_KERNELS, profile, counts,
                lambda w: {"bases": bases, "bases_per_s": bases / w})
        require_select_per_batch(name, counts[name])
        require_upload_route(line, direct=True)
        require(not any(m.startswith("mash_tpu_torch.ops.screen_")
                        for m in sorts),
                "%s sorted in the screen counter: %s" % (name, sorts))
        print("%s largest torch.sort by module: %s"
              % (name, json.dumps(sorts)), flush=True)
        return out, line["wall_s"], counts[name]

    out, wall, launches = run_screen("screen", ["screen", db_msh, *paths])
    print("screen: %d bases against %d DB hashes in %.3f s = %.4g bases/s"
          % (bases, db_hashes, wall, bases / wall), flush=True)
    rows = [ln.split("\t") for ln in out.splitlines()]
    require(len(rows) >= N_GENOMES, "screen printed %d lines" % len(rows))
    by_name = {f[4]: f for f in rows if len(f) == 6}
    full = "%d/%d" % (S, S)
    require(all(p in by_name and by_name[p][:2] == ["1", full]
                for p in paths),
            "a genome did not screen at identity 1 with %s" % full)

    out_w, _, _ = run_screen("screen_w", ["screen", "-w", db_msh, *paths])
    shared = [int(ln.split("\t")[1].split("/")[0])
              for ln in out_w.splitlines()]
    # every DB hash of the genomes occurs in the mixture and goes to one
    # winner; no random DB hash occurs
    require(sum(shared) == union, "screen -w shared %d of the genomes' %d "
            "distinct hashes" % (sum(shared), union))

    out_t, _, _ = run_screen("taxscreen", ["taxscreen", "-t", taxdir, tax_msh,
                                           *paths])
    report = [ln.split("\t") for ln in out_t.splitlines()[1:]]
    require(report and report[0][1] == report[0][3] == str(union)
            and report[0][6] == "1", "taxscreen root is not %d/%d hashes"
            % (union, union))
    names = {f[-1].strip() for f in report}
    require({"Escherichia", "Escherichia coli", "Escherichia other"}
            <= names, "taxscreen report lacks a taxon: %s" % sorted(names))
    print("screen -w and taxscreen: %d distinct genome hashes all counted"
          % union, flush=True)

    # cross-checks against the CPU's plain path
    for argv in (["screen", cross_msh, paths[0]],
                 ["taxscreen", "-t", taxdir, cross_msh, paths[0]]):
        require(run_cli(argv, GPU) == run_cli(argv, CPU),
                "%s of one genome differs from the CPU's" % argv[0])
    print("phase screen: ok", flush=True)
    return launches

# -- reads, per-record sketches and triangles (phases 6 and 7) -------------

N_READS = 500_000  # per file; two files: 150 Mbase, about 36x of a genome
READ_LEN = 150
N_FAMILIES = 256
FAMILY_SIZE = 16
FAMILY_LEN = (2000, 256000)  # log-uniform, bases
N_CROSS_READS = 20_000  # a file over the 4 MiB fast-ingest gate


def complement_table():
    import numpy as np

    comp = np.arange(256, dtype=np.uint8)
    for a, b in (b"AT", b"CG", b"at", b"cg"):
        comp[a], comp[b] = b, a
    return comp


def read_genome(path: str):
    """The bases of a one-record FASTA file of ``write_genomes`` (uint8)."""
    import numpy as np

    with open(path, "rb") as f:
        f.readline()
        return np.frombuffer(f.read().replace(b"\n", b""), np.uint8)


def write_reads(rng, genome, path, n, tag: bytes):
    """FASTQ of n reads of ``genome`` (uint8 bases): every other read
    reverse-complemented, 1 % substitutions, records of fixed width."""
    import numpy as np

    pos = rng.integers(0, genome.size - READ_LEN + 1, n)
    seq = genome[pos[:, None] + np.arange(READ_LEN)]
    hit = rng.random(seq.shape) < 0.01
    seq[hit] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, int(hit.sum()))]
    seq[1::2] = complement_table()[seq[1::2, ::-1]]
    head = 2 + 7 + 1  # "@" tag digits "\n"
    rec = np.empty((n, head + READ_LEN + 3 + READ_LEN + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = tag[0]
    rec[:, 2:9] = (np.arange(n)[:, None] // 10 ** np.arange(6, -1, -1)) \
        % 10 + ord("0")
    rec[:, 9] = ord("\n")
    rec[:, head : head + READ_LEN] = seq
    rec[:, head + READ_LEN : head + READ_LEN + 3] = np.frombuffer(b"\n+\n",
                                                                 np.uint8)
    rec[:, head + READ_LEN + 3 : -1] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def write_plasmids(rng, path) -> int:
    """A multi-FASTA of N_FAMILIES families of FAMILY_SIZE members: each
    family a random sequence of log-uniform length over FAMILY_LEN, each
    member a copy with 0.5-5 % substitutions.  Returns its bases."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    lengths = np.exp(rng.uniform(*np.log(FAMILY_LEN),
                                 N_FAMILIES)).astype(np.int64)
    with open(path, "wb") as f:
        for fam, length in enumerate(lengths):
            base = rng.integers(0, 4, length)
            for j in range(FAMILY_SIZE):
                hit = rng.random(length) < rng.uniform(0.005, 0.05)
                codes = base.copy()
                codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))
                              ) % 4
                f.write(b">fam%03d_m%02d family %d member %d\n%s\n"
                        % (fam, j, fam, j, acgt[codes].tobytes()))
    return int(lengths.sum()) * FAMILY_SIZE


# stdout, stderr and wall seconds of each main-path command of phases 4 to
# 8, by name: phase 9 holds its two-rank runs against them
MAIN_RUNS: dict = {}


# what screen and taxscreen launch: the DB's table once, and a batch's
# window hash and count (K5, K4) and its cardinality fold (K1, K6)
SCREEN_KERNELS = ("screen_table", "screen_count", "hash_windows",
                  "sketch_select", "fold_sorted")


def require_select_per_batch(name, launches):
    """The screen fold selects each batch's bottom hashes with one
    ``sketch_select`` launch, as the counter probes it with one
    ``screen_count`` launch (one device)."""
    require(launches["sketch_select"] == launches["screen_count"],
            "%s launched sketch_select %d times for %d batches"
            % (name, launches["sketch_select"], launches["screen_count"]))


def counted_cli(name, argv, kernels, profile, cmd_launches, extra,
                stderr=None):
    """``timed_cli`` on the card with every launch counter reset just
    before; the kernels named must have launched.  The counts go to
    ``cmd_launches[name]``, the outputs and wall to ``MAIN_RUNS[name]``;
    returns stdout and the JSON line."""
    reset_launches()
    err = [] if stderr is None else stderr
    out, _, line = timed_cli(name, argv, GPU, profile, extra, err)
    MAIN_RUNS[name] = {"out": out, "err": err[-1], "wall_s": line["wall_s"]}
    cmd_launches[name] = launches = read_launches()
    for kernel in kernels:
        require(launches[kernel] > 0, "%s did not launch %s" % (name, kernel))
    print("%s launches: %s" % (name, json.dumps(launches)), flush=True)
    return out, line


def shared_by_name(dist_out: str) -> dict:
    """``{reference: shared hashes}`` from ``dist`` lines."""
    return {f[0]: int(f[4].split("/")[0])
            for f in (ln.split("\t") for ln in dist_out.splitlines())}


def phase_reads(rng, folder, paths, all_msh, cmd_launches,
                profile=None):
    """sketch -r, sketch -r -m 2 and sketch -i through the CLI, each with
    every launch counter reset just before it; then the reads' nearest
    genomes and cross-checks against the CPU."""
    import numpy as np

    from mash_tpu_torch.io import capnp_msh

    genome = read_genome(paths[0])
    t0 = time.perf_counter()
    reads = [os.path.join(folder, "reads_R%d.fq" % i) for i in (1, 2)]
    for i, path in enumerate(reads):
        write_reads(rng, genome, path, N_READS, b"ab"[i : i + 1])
    plasmids = os.path.join(folder, "plasmids.fa")
    plasmid_bases = write_plasmids(rng, plasmids)
    print("wrote 2 x %d reads and %d plasmid records (%d bases) in %.1f s"
          % (N_READS, N_FAMILIES * FAMILY_SIZE, plasmid_bases,
             time.perf_counter() - t0), flush=True)
    read_bases = 2 * N_READS * READ_LEN

    def run(name, argv, bases, kernels):
        msh = argv[argv.index("-o") + 1]

        def extra(wall):
            with open(msh, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            return {"bases": bases, "bases_per_s": bases / wall,
                    "msh_sha256": digest}

        err = []
        out, line = counted_cli(name, argv, kernels, profile, cmd_launches,
                                extra, err)
        return out, err[0], line

    reads_msh = os.path.join(folder, "reads.msh")
    m2_msh = os.path.join(folder, "reads_m2.msh")
    _, err, line = run("sketch_reads", ["sketch", "-r", "-o", reads_msh,
                                        *reads], read_bases,
                       ["sketch_select", "fold_sorted"])
    require_upload_route(line, direct=True)
    print("sketch -r estimates: %s" % " | ".join(
        ln for ln in err.splitlines() if ln.startswith("Estimated")))
    _, err, line = run("sketch_reads_m2", ["sketch", "-r", "-m", "2", "-o",
                                           m2_msh, *reads], read_bases,
                       ["hash_windows"])
    require("engine:hash_bytes" in line["stages_s"],
            "sketch -r -m 2 did not take the exact route")
    require_upload_route(line, direct=False)
    print("sketch -r -m 2 estimates: %s" % " | ".join(
        ln for ln in err.splitlines() if ln.startswith("Estimated")))

    # the reads' sketches against the 64 genomes (genome 1 differs from
    # genome 0 in 0.08 % of its bases, so it may tie) and against the
    # 1024 unrelated synthetic sketches of phase 4
    big_msh = os.path.join(folder, "big.msh")
    for msh in (reads_msh, m2_msh):
        shared = shared_by_name(run_cli(["dist", all_msh, msh], GPU))
        g0 = shared[paths[0]]
        require(g0 == max(shared.values()) and g0 > shared[paths[-1]],
                "genome 0 is not the nearest to the reads: %s" % shared)
        unrelated = shared_by_name(run_cli(["dist", big_msh, msh], GPU))
        require(max(unrelated.values()) <= S // 100,
                "an unrelated sketch shares more than 1%% of s with the "
                "reads: %d" % max(unrelated.values()))
        print("%s: genome 0 shares %d/%d, genome %d %d; unrelated at most %d"
              % (os.path.basename(msh), g0, S, N_GENOMES - 1,
                 shared[paths[-1]], max(unrelated.values())), flush=True)

    plasmids_msh = os.path.join(folder, "plasmids.msh")
    run("sketch_i", ["sketch", "-i", "-o", plasmids_msh, plasmids],
        plasmid_bases, ["sketch_select", "fold_sorted"])
    msh = capnp_msh.read_msh(plasmids_msh)
    require(len(msh.references) == N_FAMILIES * FAMILY_SIZE
            and all(len(r.hashes) and np.all(r.hashes[1:] > r.hashes[:-1])
                    for r in msh.references),
            "plasmids.msh does not hold %d sorted sketches"
            % (N_FAMILIES * FAMILY_SIZE))

    # cross-checks against the CPU's plain path
    head = os.path.join(folder, "reads_head.fq")
    with open(reads[0], "rb") as f, open(head, "wb") as g:
        g.write(f.read(N_CROSS_READS * (2 * READ_LEN + 14)))
    first = os.path.join(folder, "plasmids_head.fa")
    with open(plasmids, "rb") as f, open(first, "wb") as g:
        g.writelines(f.readline() for _ in range(2 * 64))
    for opts, src in ((["-r"], head), (["-r", "-m", "2"], head),
                      (["-i"], first)):
        got = []
        for dev, env in (("gpu", GPU), ("cpu", CPU)):
            out = os.path.join(folder, "cross_%s" % dev)
            run_cli(["sketch", *opts, "-o", out, src], env, [])
            with open(out + ".msh", "rb") as f:
                got.append(f.read())
        require(got[0] == got[1], "sketch %s .msh bytes differ from the "
                "CPU's" % " ".join(opts))
    print("phase reads: ok", flush=True)
    return plasmids_msh


def triangle_stripe_case(report, plasmids_msh):
    """``pairwise32`` on the last stripe of the plasmids' streamed
    triangle (512 query rows against 4095 columns of rank keys, in the
    stream's tiles of 2048) against its plain version."""
    import torch

    from mash_tpu_torch.io import capnp_msh
    from mash_tpu_torch.ops import distance, pairwise_kernel

    refs = capnp_msh.read_msh(plasmids_msh).references
    n = len(refs)
    H, N = distance.pad_sketches([r.hashes for r in refs],
                                 max(S, max(len(r.hashes) for r in refs)))
    Hd, Nd = distance._upload(H, N, "cuda")
    keys, _ = distance.rank_compress(Hd, Hd[:0])
    i0, rows, tile_r = n - 512, 512, 2048
    cols = i0 + rows - 1
    q, nq = keys[i0:].contiguous(), Nd[i0:].contiguous()

    def stripe():
        out = [pairwise_kernel.pairwise32(q, nq, keys[ri : ri + tile_r],
                                          Nd[ri : ri + tile_r], cap=S)
               for ri in range(0, cols, tile_r)]
        return [torch.cat([o[j] for o in out], dim=1)[:, :cols]
                for j in (0, 1)]

    wq = pairwise_kernel.keys32_to_64(q)
    wr = pairwise_kernel.keys32_to_64(keys[:cols].contiguous())

    def plain():
        return distance.pairwise_common_denom(wq, nq, wr, Nd[:cols], cap=S)

    got, want = stripe(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0.0, "pairwise32 on the triangle's last stripe disagrees")
    ms, plain_ms = cuda_ms(stripe), cuda_ms(plain)
    nbytes = (rows + cols) * keys.shape[1] * 4 + (rows + cols) * 4 \
        + 2 * rows * cols * 4
    real = (nq[:, None] > 0) & (Nd[None, :cols] > 0)
    nops = int(((want[0].long() + want[1].long()) * real).sum())
    bound_ms, bound_by = bound(nbytes, nops)
    report.append(dict(
        name="pairwise32", shape="triangle stripe %d x %d of %d sketches "
        "(tiles of %d), s=%d" % (rows, cols, n, tile_r, S),
        max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, main=False,
        launches_from="triangle_4096"))


def phase_triangle(report, folder, paths, all_msh, plasmids_msh,
                   cmd_launches, profile=None):
    """triangle of the plasmids (streamed) and of the 64 genomes through
    the CLI, each with every launch counter reset just before it; then
    the host commands and cross-checks against the CPU."""
    from mash_tpu_torch.io import capnp_msh

    n = N_FAMILIES * FAMILY_SIZE

    def run(name, argv, kernels, cells):
        return counted_cli(name, argv, kernels, profile, cmd_launches,
                           lambda w: {"cells": cells,
                                      "cells_per_s": cells / w})[0]

    cells = n * (n - 1) // 2
    out = run("triangle_4096", ["triangle", plasmids_msh], ["pairwise32"],
              cells)
    lines = out.splitlines()
    require(lines[0] == "\t%d" % n and len(lines) == n + 1
            and all(ln.count("\t") == i for i, ln in enumerate(lines[1:])),
            "triangle of %d sketches is not a lower triangle" % n)
    triangle_stripe_case(report, plasmids_msh)

    edges = run("triangle_edges", ["triangle", "-E", "-d", "0.15",
                                   plasmids_msh], ["pairwise32"], cells)
    pairs = [ln.split("\t")[:2] for ln in edges.splitlines()]
    require(pairs and all(a[:6] == b[:6] for a, b in pairs),
            "an edge joins two families")
    print("triangle -E -d 0.15: %d edges, all within a family (%d pairs "
          "within families)" % (len(pairs), N_FAMILIES * FAMILY_SIZE
                                * (FAMILY_SIZE - 1) // 2), flush=True)

    out_64 = run("triangle_64", ["triangle", all_msh], ["pairwise64"],
                 N_GENOMES * (N_GENOMES - 1) // 2)

    # cross-checks against the CPU's plain path
    head = os.path.join(folder, "plasmids_128.msh")
    msh = capnp_msh.read_msh(plasmids_msh)
    capnp_msh.write_msh(head, msh.params, msh.references[:128])
    require(run_cli(["triangle", head], CPU).splitlines()[2:129]
            == lines[2:129], "rows 1-127 of the plasmid triangle differ "
            "from the CPU's")
    got = [[run_cli(["triangle", all_msh], env, err), err]
           for env, err in ((GPU, []), (CPU, []))]
    require(got[0][0] == out_64 and got[0] == got[1],
            "triangle of the 64 genomes differs from the CPU's")
    for argv in (["info", "-t", plasmids_msh], ["info", "-d", all_msh],
                 ["bounds"]):
        require(run_cli(argv, GPU) == run_cli(argv, CPU),
                "%s differs between the GPU's and the CPU's environment"
                % " ".join(argv[:2]))
    pasted = []
    for dev, env in (("gpu", GPU), ("cpu", CPU)):
        out = os.path.join(folder, "pasted_%s" % dev)
        run_cli(["paste", out, all_msh, plasmids_msh], env)
        with open(out + ".msh", "rb") as f:
            pasted.append(f.read())
    require(pasted[0] == pasted[1], "paste .msh bytes differ")
    print("phase triangle: ok", flush=True)


# -- windowed search and containment (phase 8) -----------------------------

# genomes in ``sketch -W``: cut from 64, since the .msw writer and the loci
# index (``SketchSet.loci_by_hash``) touch each locus in Python
N_WINDOWED = 16
WINDOW_S = 100  # the minmers per window ``find`` picks itself: L / f
N_FRAGMENTS = 64
FRAGMENT_LEN = 10_000
N_CROSS_FRAGMENTS = 8
N_CROSS_PLASMIDS = 128


def write_fragments(rng, genome, path):
    """A FASTA of N_FRAGMENTS fragments of ``genome`` at random offsets
    outside its lowercase stretch (``find`` uppercases a query, while the
    ``.msw`` hashes the reference's bytes as they are), 1 % substitutions,
    every other one reverse-complemented; returns the offsets."""
    import numpy as np

    lower = np.flatnonzero(genome >= ord("a"))
    offsets = []
    while len(offsets) < N_FRAGMENTS:
        p = int(rng.integers(0, genome.size - FRAGMENT_LEN + 1))
        if not np.any((lower >= p) & (lower < p + FRAGMENT_LEN)):
            offsets.append(p)
    comp = complement_table()
    with open(path, "wb") as f:
        for i, p in enumerate(offsets):
            seq = genome[p : p + FRAGMENT_LEN].copy()
            hit = rng.random(seq.size) < 0.01
            seq[hit] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, int(hit.sum()))]
            if i % 2:
                seq = comp[seq[::-1]]
            f.write(b">frag%02d offset %d\n%s\n" % (i, p, seq.tobytes()))
    return offsets


def containment_ms(ref_msh, qry_msh) -> float:
    """CUDA-event milliseconds of ``pairwise_containment`` on the padded
    sketches that ``within ref_msh qry_msh`` builds."""
    import torch

    from mash_tpu_torch.io import capnp_msh
    from mash_tpu_torch.ops import distance

    refs = capnp_msh.read_msh(ref_msh).references
    qrys = capnp_msh.read_msh(qry_msh).references
    width = max(len(r.hashes) for r in refs + qrys)
    dev = torch.device("cuda")
    rh, rn = distance._upload(*distance.pad_sketches(
        [r.hashes for r in refs], width), dev)
    qh, qn = distance._upload(*distance.pad_sketches(
        [r.hashes for r in qrys], width), dev)
    return cuda_ms(lambda: distance.pairwise_containment(rh, rn, qh, qn))


def windowed_hash_ms() -> float:
    """CUDA-event milliseconds of ``windowed_hash`` of one 1 MiB piece, as
    ``SketchEngine.windowed_positions`` hashes it before its read-back."""
    import numpy as np
    import torch

    from mash_tpu_torch.core.engine import DEFAULT_CHUNK, windowed_hash

    row = torch.from_numpy(random_chunks(np.random.default_rng(8), 1,
                                         DEFAULT_CHUNK)[0]).cuda()
    return cuda_ms(lambda: windowed_hash(row, K, 42))


def find_hits(out: str) -> dict:
    """``{query: [[reference, start, end, strand, score], ...]}`` of
    ``find`` lines, best first.  ``find``'s ``-b`` is shadowed by the
    sketch options' ``-b`` (the Bloom filter size, added later), in
    ``mash_tpu`` as here, so ``-b 1`` prints every hit over the
    threshold."""
    hits = {}
    for ln in out.splitlines():
        f = ln.split("\t")
        hits.setdefault(f[0], []).append(
            [f[1], int(f[2]), int(f[3]), f[4], float(f[5])])
    return hits


def phase_windowed(folder, rng, paths, all_msh, plasmids_msh, cmd_launches,
                   profile=None):
    """sketch -W, find and within through the CLI, each with every launch
    counter reset just before it; then cross-checks against the CPU.
    Returns the 8-fragment FASTA, its ``find`` stdout against genome 0
    and that call's wall seconds."""
    import torch

    from mash_tpu_torch.io import capnp_msh

    frags = os.path.join(folder, "fragments.fa")
    offsets = write_fragments(rng, read_genome(paths[0]), frags)
    genome0 = "genome00"

    def run(name, argv, kernels, extra=None, stderr=None):
        return counted_cli(name, argv, kernels, profile, cmd_launches,
                           extra or (lambda w: {}), stderr)

    print("sketch_w: cut from %d genomes to the first %d (the .msw writer "
          "and the loci index touch each locus in Python)"
          % (N_GENOMES, N_WINDOWED), flush=True)
    msw = os.path.join(folder, "windowed.msw")
    bases = N_WINDOWED * GENOME_LEN

    def sketch_w_extra(wall):
        loci = sum(len(a) for a in capnp_msh.read_msh(msw).position_hashes)
        return {"bases": bases, "bases_per_s": bases / wall, "loci": loci,
                "windowed_hash_ms_per_MiB": windowed_hash_ms()}

    _, line = run("sketch_w", ["sketch", "-W", "-s", str(WINDOW_S), "-o", msw,
                               *paths[:N_WINDOWED]], ["hash_windows"],
                  sketch_w_extra)
    require(0.005 * bases < line["loci"] < 0.05 * bases,
            "sketch -W stored %d loci of %d bases" % (line["loci"], bases))

    out, _ = run("find_msw", ["find", "-b", "1", msw, frags],
                 ["hash_windows"])
    hits = find_hits(out)
    require(len(hits) == N_FRAGMENTS, "find hit %d of %d fragments"
            % (len(hits), N_FRAGMENTS))
    for i, p in enumerate(offsets):
        frag = hits["frag%02d" % i]
        # every genome is a copy of genome 0 with substitutions, so each
        # hit lies at the fragment's origin; the best is genome 0's or
        # genome 1's (0.08 % away, which may tie)
        require(frag[0][0] in (genome0, "genome01") and all(
            start < p + FRAGMENT_LEN and end >= p and strand == "+-"[i % 2]
            for _ref, start, end, strand, _score in frag),
            "frag%02d (offset %d, %s) hit %s" % (i, p, "+-"[i % 2], frag))
    best = [h[0][4] for h in hits.values()]
    print("find: every fragment hit its origin on its strand, best first "
          "genome 0 or 1; best scores %.3f-%.3f; %d hits"
          % (min(best), max(best), len(out.splitlines())), flush=True)

    # genome 0 alone, windowed on the card and on the CPU
    msw0 = {}
    for dev, env in (("gpu", GPU), ("cpu", CPU)):
        msw0[dev] = os.path.join(folder, "genome0_%s.msw" % dev)
        run_cli(["sketch", "-W", "-s", str(WINDOW_S), "-o", msw0[dev],
                 paths[0]], env, [])
    with open(msw0["gpu"], "rb") as a, open(msw0["cpu"], "rb") as b:
        require(a.read() == b.read(), "sketch -W .msw bytes of genome 0 "
                "differ from the CPU's")
    fasta_out, _ = run("find_fasta", ["find", paths[0], frags],
                       ["hash_windows"])
    require(fasta_out == run_cli(["find", msw0["gpu"], frags], GPU),
            "find against genome 0's FASTA differs from find against its "
            ".msw")
    require(len(fasta_out.splitlines()) >= N_FRAGMENTS,
            "find against genome 0 printed %d lines"
            % len(fasta_out.splitlines()))

    err = []
    out, _ = run("within_fasta", ["within", "-s", "10000", paths[0],
                                  all_msh], ["sketch_select", "fold_sorted"],
                   stderr=err)
    score = {f[3]: float(f[0]) for f in
             (ln.split("\t") for ln in out.splitlines())}
    require(len(score) == N_GENOMES and score[paths[0]] == 1.0
            and score[paths[-1]] < score[paths[1]],
            "within of genome 0: %d rows, genome 0 %s, genome 1 %s, "
            "genome %d %s" % (len(score), score.get(paths[0]),
                              score.get(paths[1]), N_GENOMES - 1,
                              score.get(paths[-1])))
    print("within_fasta: genome 0 scores 1, genome 1 %.4f, genome %d %.4f"
          % (score[paths[1]], N_GENOMES - 1, score[paths[-1]]), flush=True)
    within_gpu = (out, err[0])

    n_pairs = N_GENOMES * N_FAMILIES * FAMILY_SIZE
    out, _ = run("within_plasmids", ["within", "-e", "1", all_msh,
                                     plasmids_msh], [],
                 lambda w: {"pairs": n_pairs, "containment_ms":
                            containment_ms(all_msh, plasmids_msh)})
    rows = [ln.split("\t") for ln in out.splitlines()]
    require(rows and all(float(f[0]) < 0.05 for f in rows),
            "a plasmid sketch is contained in a genome's: %s"
            % max((f for f in rows), key=lambda f: float(f[0]),
                  default=None))
    print("within_plasmids: %d of %d pairs with a consumed query hash"
          % (len(rows), n_pairs), flush=True)

    # cross-checks against the CPU's plain path
    head = os.path.join(folder, "fragments_head.fa")
    with open(frags, "rb") as f, open(head, "wb") as g:
        g.writelines(f.readline() for _ in range(2 * N_CROSS_FRAGMENTS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    find_head = run_cli(["find", msw0["gpu"], head], GPU)
    torch.cuda.synchronize()
    find_head_wall = time.perf_counter() - t0
    require(find_head == run_cli(["find", msw0["gpu"], head], CPU),
            "find of %d fragments differs from the CPU's" % N_CROSS_FRAGMENTS)
    first = os.path.join(folder, "plasmids_first.msh")
    msh = capnp_msh.read_msh(plasmids_msh)
    capnp_msh.write_msh(first, msh.params, msh.references[:N_CROSS_PLASMIDS])
    argv = ["within", "-e", "1", all_msh, first]
    require(run_cli(argv, GPU) == run_cli(argv, CPU),
            "within of %d plasmid sketches differs from the CPU's"
            % N_CROSS_PLASMIDS)
    err = []
    cpu_out = run_cli(["within", "-s", "10000", paths[0], all_msh], CPU, err)
    require((cpu_out, err[0]) == within_gpu,
            "within_fasta differs from the CPU's")
    print("phase windowed: ok", flush=True)
    return head, find_head, find_head_wall


# -- two ranks on one card, and the mesh (phase 9) -------------------------

RANKS = 2
RANK_TIMEOUT_S = 600
# ``stream_pair_stripes``' row block on CUDA: the stripes' unit of
# ownership (rank j % RANKS owns stripe j)
STRIPE_ROWS = 512
TWO_RANK_NOTE = ("two ranks on one card and one host: a check of the "
                 "assembly rules, not a scaling figure")
# the mesh of phase 9: the one card, twice
MESH_DEVICES = ("cuda:0", "cuda:0")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_worker(cfg_path: str) -> int:
    """One rank of phase 9 (``chip_smoke.py --rank-worker CFG``): joins
    the gloo group that ``MASH_TPU_TORCH_COORDINATOR``,
    ``..._NUM_PROCESSES`` and ``..._PROCESS_ID`` describe, runs each of
    the config's commands through ``mash_tpu_torch.__main__.main`` on the
    card with every launch counter (and the plain hash pass's count on the
    card) reset just before it, and writes its stdout, its stderr, its
    wall seconds and those counts to files."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    sys.path.insert(0, ROOT)
    import torch

    from mash_tpu_torch.__main__ import main as cli
    from mash_tpu_torch.parallel import multihost as mh

    require(mh.maybe_init_distributed() and mh.process_count() == RANKS,
            "no process group of %d ranks" % RANKS)
    rank = mh.process_index()
    count_plain_on_card()
    results = {}
    for name, argv in cfg["commands"]:
        reset_launches()
        reset_plain_on_card()
        torch.cuda.synchronize()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc in (0, None), "rank %d: %s exited %s:\n%s"
                % (rank, name, rc, err.getvalue()[-2000:]))
        base = os.path.join(cfg["folder"], "rank%d_%s" % (rank, name))
        for ext, text in ((".out", out.getvalue()), (".err", err.getvalue())):
            with open(base + ext, "w") as f:
                f.write(text)
        results[name] = {"wall_s": wall, "launches": read_launches(),
                         "plain_hash_on_card": PLAIN_ON_CARD[
                             "hash_chunk_plain"],
                         "plain_fold_on_card": PLAIN_ON_CARD["_fold_sorted"]}
    with open(os.path.join(cfg["folder"], "rank%d.json" % rank), "w") as f:
        json.dump(results, f)
    return 0


def run_ranks(folder, commands) -> list:
    """``commands`` (``[name, argv]`` pairs) in RANKS processes of this
    script on the one card, joined by gloo; returns each rank's results.
    Every rank must exit 0 within RANK_TIMEOUT_S: on the first failure
    the others are killed, and no process outlives the call."""
    import subprocess

    cfg = os.path.join(folder, "ranks.json")
    with open(cfg, "w") as f:
        json.dump({"folder": folder, "commands": commands}, f)
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(RANKS):
            env = dict(os.environ, **GPU, MASH_TPU_TORCH_COORDINATOR=(
                "127.0.0.1:%d" % port), MASH_TPU_TORCH_NUM_PROCESSES=str(
                RANKS), MASH_TPU_TORCH_PROCESS_ID=str(rank))
            logs.append(open(os.path.join(folder, "rank%d.log" % rank), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 cfg], env=env, cwd=ROOT, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-3000:])
            log.close()
    for rank, p in enumerate(procs):
        require(p.returncode == 0, "rank %d exited %s:\n%s"
                % (rank, p.returncode, tails[rank]))
    out = []
    for rank in range(RANKS):
        with open(os.path.join(folder, "rank%d.json" % rank)) as f:
            out.append(json.load(f))
    return out


def rank_text(folder, rank, name, ext=".out") -> str:
    with open(os.path.join(folder, "rank%d_%s%s" % (rank, name, ext))) as f:
        return f.read()


def in_stripe_order(texts, stripe_of_line) -> str:
    """The ranks' outputs concatenated in stripe order; each line must
    come from the rank that owns its stripe."""
    by_stripe: dict = {}
    for rank, text in enumerate(texts):
        for ln in text.splitlines(keepends=True):
            j = stripe_of_line(ln)
            require(j % RANKS == rank, "rank %d printed a line of stripe %d"
                    % (rank, j))
            by_stripe.setdefault(j, []).append(ln)
    return "".join("".join(by_stripe[j]) for j in sorted(by_stripe))


def phase_ranks(folder, paths, all_msh, plasmids_msh, find_head):
    """The main-path commands in two ranks on the one card (gloo), each
    held against its single-process output."""
    from mash_tpu_torch.io import capnp_msh

    t_phase = time.perf_counter()
    names = [r.name for r in capnp_msh.read_msh(plasmids_msh).references]
    row = {name: i for i, name in enumerate(names)}
    reads = [os.path.join(folder, "reads_R%d.fq" % i) for i in (1, 2)]
    pooled = os.path.join(folder, "reads_2rank.msh")
    dist_argv = ["dist", "-d", "0.15", plasmids_msh, plasmids_msh]
    single_dist = {}
    counted_cli("dist_d", dist_argv, ["pairwise32"], None, single_dist,
                lambda w: {})
    taxdir = os.path.join(folder, "taxonomy")
    commands = [
        ["sketch_reads", ["sketch", "-r", "-o", pooled, *reads]],
        ["triangle_4096", ["triangle", plasmids_msh]],
        ["dist_d", dist_argv],
        ["screen", ["screen", os.path.join(folder, "screen_db.msh"),
                    *paths]],
        ["taxscreen", ["taxscreen", "-t", taxdir,
                       os.path.join(folder, "tax_db.msh"), *paths]],
        ["within_plasmids", ["within", "-e", "1", all_msh, plasmids_msh]],
        ["find_head", ["find", paths[0], find_head[0]]],
    ]
    kernels = {"sketch_reads": ["sketch_select", "fold_sorted"],
               "triangle_4096": ["pairwise32"], "dist_d": ["pairwise32"],
               "screen": SCREEN_KERNELS, "taxscreen": SCREEN_KERNELS}
    t0 = time.perf_counter()
    results = run_ranks(folder, commands)
    print("phase ranks: %d ranks ran %d commands in %.1f s (startup "
          "included)" % (RANKS, len(commands), time.perf_counter() - t0),
          flush=True)
    for name, _argv in commands:
        for rank in range(RANKS):
            require(results[rank][name]["plain_hash_on_card"] == 0,
                    "rank %d's %s hashed on the card with the plain pass"
                    % (rank, name))
            require(results[rank][name]["plain_fold_on_card"] == 0,
                    "rank %d's %s folded on the card with the plain fold"
                    % (rank, name))
            for kernel in kernels.get(name, ()):
                require(results[rank][name]["launches"][kernel] > 0,
                        "rank %d's %s did not launch %s" % (rank, name,
                                                              kernel))
            if kernels.get(name) is SCREEN_KERNELS:
                require_select_per_batch("rank %d's %s" % (rank, name),
                                         results[rank][name]["launches"])
        single = (MAIN_RUNS[name] if name != "find_head"
                  else {"out": find_head[1], "wall_s": find_head[2]})
        print(json.dumps({
            "command": "ranks2_" + name, "note": TWO_RANK_NOTE,
            "rank_walls_s": [r[name]["wall_s"] for r in results],
            "single_wall_s": single["wall_s"],
            "rank_launches": [r[name]["launches"] for r in results],
            "rank_plain_hash_on_card": [r[name]["plain_hash_on_card"]
                                        for r in results],
            "rank_plain_fold_on_card": [r[name]["plain_fold_on_card"]
                                        for r in results]}),
            flush=True)
    with open(pooled, "rb") as a, open(os.path.join(folder, "reads.msh"),
                                       "rb") as b:
        require(a.read() == b.read(), "the two-rank sketch -r .msh differs "
                "from the single process's")
    outs = [rank_text(folder, r, "triangle_4096") for r in range(RANKS)]
    require(outs[0].startswith("\t%d\n" % len(names))
            and not outs[1].startswith("\t"), "the PHYLIP header is not "
            "on rank 0 alone")
    require(in_stripe_order(outs, lambda ln: 0 if ln.startswith("\t") else
                            row[ln.split("\t", 1)[0].rstrip("\n")]
                            // STRIPE_ROWS)
            == MAIN_RUNS["triangle_4096"]["out"], "the two ranks' triangle "
            "in stripe order differs from the single process's")
    max_p = [ln for ln in MAIN_RUNS["triangle_4096"]["err"].splitlines()
             if ln.startswith("Max p-value")]
    errs = [rank_text(folder, r, "triangle_4096", ".err")
            for r in range(RANKS)]
    require(len(max_p) == 1 and max_p[0] in errs[0].splitlines()
            and "Max p-value" not in errs[1], "Max p-value is not rank 0's "
            "alone, or differs")
    outs = [rank_text(folder, r, "dist_d") for r in range(RANKS)]
    require(in_stripe_order(outs, lambda ln: row[ln.split("\t")[1]]
                            // STRIPE_ROWS) == MAIN_RUNS["dist_d"]["out"],
            "the two ranks' dist -d 0.15 in stripe order differs from the "
            "single process's")
    require(all(outs), "a rank printed no dist line")
    for name in ("screen", "taxscreen", "within_plasmids", "find_head"):
        want = find_head[1] if name == "find_head" else MAIN_RUNS[name]["out"]
        require(rank_text(folder, 0, name) == want and want,
                "rank 0's %s differs from the single process's" % name)
        require(rank_text(folder, 1, name) == "", "rank 1 printed %s" % name)
    print("phase ranks: ok in %.1f s" % (time.perf_counter() - t_phase),
          flush=True)


def phase_mesh(rng, folder, paths):
    """The mesh functions over ``[cuda:0, cuda:0]`` against the one-device
    route on the same inputs: exact equality."""
    import numpy as np
    import torch

    from mash_tpu_torch.core.params import default_nucleotide_params
    from mash_tpu_torch.io import capnp_msh
    from mash_tpu_torch.io.ingest import IngestPipeline
    from mash_tpu_torch.ops import distance, screen_ops, sketch_ops
    from mash_tpu_torch.ops.kmers import alphabet_bytes
    from mash_tpu_torch.ops.sketch_kernel import sketch_chunks_fused
    from mash_tpu_torch.parallel import mesh
    from mash_tpu_torch.utils.profiling import pop_stage_totals

    t_phase = time.perf_counter()
    devices = [torch.device(d) for d in MESH_DEVICES]
    params = default_nucleotide_params(K, S, 42)

    def check(name, shape, sharded, single, kernels, equal):
        reset_launches()
        t0 = time.perf_counter()
        got = sharded()
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        launches = read_launches()
        t0 = time.perf_counter()
        want = single()
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        require(equal(got, want), "%s on %s differs from one device's"
                % (name, shape))
        for kernel, n in kernels.items():  # n None: at least once
            require(launches[kernel] == n if n is not None
                    else launches[kernel] > 0, "%s on %s launched %s %d "
                    "times, not %s" % (name, shape, kernel, launches[kernel],
                                       n or "once or more"))
        print(json.dumps({"mesh": name, "devices": list(MESH_DEVICES),
                          "shape": shape, "equal": True,
                          "sharded_s": t_sharded, "single_s": t_single,
                          "launches": launches}), flush=True)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    chunks = torch.from_numpy(random_chunks(rng, 32, 1 << 20)).to(devices[0])
    kw = dict(alphabet=alphabet_bytes(params.alphabet), k=K, seed=42,
              use64=True, noncanonical=False, preserve_case=False)
    check("sharded_sketch_chunks", "[32, 1 MiB] k=%d s=%d" % (K, S),
          lambda: mesh.sharded_sketch_chunks(devices, params, chunks, S),
          lambda: sketch_ops.tree_merge(*sketch_chunks_fused(chunks, **kw,
                                                             s=S), s=S),
          {"sketch_select": 2, "fold_sorted": 5}, same)
    for n in (64, 1024):
        H, N = distance._upload(*distance.pad_sketches(
            list(overlap_sketches(rng, n, S)), S), devices[0])
        check("sharded_pairwise", "%d x %d s=%d 64-bit" % (n, n, S),
              lambda: mesh.sharded_pairwise(devices, H, N, H, N, S),
              lambda: distance.pairwise_common_denom_auto(H, N, H, N, cap=S),
              {"pairwise64": 2} if n == 64 else {"pairwise32": 2}, same)
    db = np.unique(np.concatenate([r.hashes for r in capnp_msh.read_msh(
        os.path.join(folder, "screen_db.msh")).references]))
    pipe = IngestPipeline(paths[:8], K, 1 << 20, 32, pack_mode=0)
    try:
        batch = torch.from_numpy(next(iter(pipe.batches()))).to(devices[0])
    finally:
        pipe.close()

    def one_device():
        _f, fold_rows, c0, finalize = screen_ops.make_screen_fold(
            params, db, S, devices[0])
        c0, state = fold_rows(c0, sketch_ops.empty_state(S, devices[0]),
                              batch)
        return finalize(c0), state

    def same_counts(a, b):
        return bool(np.array_equal(a[0], b[0])) and same(a[1], b[1])

    check("sharded_screen_counts", "batch %s against %d DB hashes in %d "
          "ranges" % (list(batch.shape), len(db), len(devices)),
          lambda: mesh.sharded_screen_counts(devices, params, db, [batch], S),
          # hash_windows: each range's counts, then the recompute of any
          # rows that lack K1's certificate
          one_device, {"screen_table": 2, "screen_count": 2,
                       "hash_windows": None, "sketch_select": 1,
                       "fold_sorted": None}, same_counts)
    pop_stage_totals()  # the one-device fold's stage: no command's
    print("phase mesh: ok in %.1f s" % (time.perf_counter() - t_phase),
          flush=True)


# -- asynchronous dispatch (phase 10) ---------------------------------------

# What the synchronous port printed at seed 0 on an NVIDIA H100 80GB HBM3
# (700 W): each command's stdout hash, and the .msh files' hashes.  The
# reads' sketches are named after their file, so their bytes hold that
# run's temporary folder: phase 10 writes this run's sketches again under
# that folder's name before it hashes them.
SYNC_SEED = 0
SYNC_FOLDER = "/tmp/mash_smoke_92rokmrf"
SYNC_STDOUT_SHA256 = {
    "sketch": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "dist_4096": "f6dd7d4adf5a2c52c342f1946583dcabc95f3d3495fd775cd03917922da48fef",
    "dist_1M": "4dabaa6b5f0d4fee0cca2bcc9fb9e6d8f29e65230dff6029733187f6a64fb053",
    "screen": "b6fa4447dd0506a69d951fa228783533dcfbfb0c83bd69ea8d5d5b680b5a59b9",
    "screen_w": "2eee79f6b26f9244d9cb9a774fe5fd16cb0264877917b4ee895c5879534e9acd",
    "taxscreen": "3b799d2a4b3a94e6e6fea2d2db08600bfacdd6b2c2e5e98fe019dd552e9fb3a0",
    "sketch_reads": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "sketch_reads_m2": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "sketch_i": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "triangle_4096": "42747ecea97308491bac139d3b950046e609678d7f06745f417e2dbbc1fe32ff",
    "triangle_edges": "5f8f1679ffa9b9251614cac5846488a77939ef9037efa7383a63d7051755a9f5",
    "triangle_64": "26ad808b47db71c3085f6a82784d2e8b4a6de368c183d713d817c2fc6317427f",
    "sketch_w": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "find_msw": "5d961f52c56ba5b6d4ed457881d59f045f61e5fe02f0a4fedf6b8cddd92c87f8",
    "find_fasta": "b95465e11b61ef003fbf6c7630f9a65fe02bd299adc61bc4b91a659cb0d34a0d",
    "within_fasta": "b4abf3949b307b2c1f44ae2162fe67a89fe07edb0e494c6ccbca023c904d0582",
    "within_plasmids": "a1d20eed3ff9b227837f369036dfbeade02f1a74ed24a06c20da635c91bc1304",
    "dist_d": "c2cd0409cefcb22e6c8d3c5afb9ad2f530a56e9752ec9283e9bb2cecd04060a9",
}
SYNC_MSH_SHA256 = {
    "reads.msh": "270f92e9e2286b4ed1fa0507bd62984ed8a5f74dcea9a5396afa8bdb0f0b8418",
    "reads_m2.msh": "4dd925b37fb532f3e14453824190a57a1159bcef99eb22b921b836569b1a1f50",
    "plasmids.msh": "f1c3c3c34864494e6d689981e9855f8a7ab974da6a6d637ac3a8b6fd492998ef",
}
N_ASYNC_READS = 100_000  # the exact route's comparison: sketch -r -m 2's head


def msh_sha256_in(path: str, folder: str, as_folder: str) -> str:
    """The hash of ``path``'s ``.msh`` bytes as they would be had the run's
    ``folder`` been ``as_folder``: the sketches are read and written again
    with the folder renamed in their names and comments (the writer gives
    back the file's own bytes when nothing is renamed)."""
    from mash_tpu_torch.io import capnp_msh

    with open(path, "rb") as f:
        raw = f.read()
    msh = capnp_msh.read_msh(path)
    again = path + ".again"
    capnp_msh.write_msh(again, msh.params, msh.references)
    with open(again, "rb") as f:
        require(f.read() == raw, "%s does not survive a read and a write"
                % os.path.basename(path))
    for ref in msh.references:
        ref.name = ref.name.replace(folder, as_folder)
        ref.comment = ref.comment.replace(folder, as_folder)
    capnp_msh.write_msh(again, msh.params, msh.references)
    with open(again, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    os.remove(again)
    return digest


def pipelined_vs_serialized(name, run, serialized, extra=None):
    """``run()`` as the package dispatches it beside ``serialized()`` (the
    same work with the harness waiting for the card after every batch),
    each twice in the order pipelined, serialized, serialized, pipelined,
    then once each under ``torch.profiler`` for the device busy share.
    The outputs must agree.  Prints one JSON line."""
    import torch

    from mash_tpu_torch.utils.profiling import pop_stage_totals

    walls = {"pipelined": [], "serialized": []}
    outs = {}
    for mode in ("pipelined", "serialized", "serialized", "pipelined"):
        fn = run if mode == "pipelined" else serialized
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[mode] = fn()
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
    require(outs["pipelined"] == outs["serialized"],
            "%s: the pipelined run differs from the serialized one" % name)
    line = {"async": name}
    for mode, fn in (("pipelined", run), ("serialized", serialized)):
        _, wall, busy, _ = device_profile(fn)
        line.update({mode + "_wall_s": walls[mode],
                     mode + "_profiled_wall_s": wall,
                     mode + "_device_busy_s": busy,
                     mode + "_device_busy_share": busy / wall})
    line.update(extra or {})
    pop_stage_totals()
    print(json.dumps(line), flush=True)
    return outs["pipelined"]


@contextlib.contextmanager
def no_host_sync(events):
    """Every synchronizing CUDA call raises
    (``torch.cuda.set_sync_debug_mode("error")``); the waits by design,
    ``torch.cuda.Event.synchronize``, are counted in ``events``."""
    import torch

    sync = torch.cuda.Event.synchronize

    def counted(self):
        events.append(1)
        return sync(self)

    torch.cuda.synchronize()
    torch.cuda.Event.synchronize = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.Event.synchronize = sync


def phase_async(folder, paths, plasmids_msh, seed):
    """The outputs of phases 4-9 against the synchronous port's (seed 0),
    then the three streaming paths pipelined beside a run the harness
    serializes, and each path's steady state under the sync debug mode."""
    import functools
    import itertools

    import numpy as np
    import torch

    from mash_tpu_torch.commands import triangle as triangle_cmd
    from mash_tpu_torch.core import engine as engine_mod
    from mash_tpu_torch.core.params import default_nucleotide_params
    from mash_tpu_torch.io.fastx import read_fastx
    from mash_tpu_torch.io.ingest import IngestPipeline
    from mash_tpu_torch.ops import distance
    from mash_tpu_torch.utils.profiling import pop_stage_totals

    t_phase = time.perf_counter()
    if seed == SYNC_SEED:
        for name, want in SYNC_STDOUT_SHA256.items():
            require(TIMED[name]["stdout_sha256"] == want,
                    "%s prints another stdout than the synchronous port"
                    % name)
        for msh, want in SYNC_MSH_SHA256.items():
            got = msh_sha256_in(os.path.join(folder, msh), folder,
                                SYNC_FOLDER)
            require(got == want, "%s differs from the synchronous port's"
                    % msh)
        print("async: the %d commands' stdout and the %d .msh files equal "
              "the synchronous port's" % (len(SYNC_STDOUT_SHA256),
                                          len(SYNC_MSH_SHA256)), flush=True)
    else:
        print("async: no synchronous outputs for seed %d; phase 10 holds "
              "pipelined runs against serialized ones only" % seed,
              flush=True)

    # fold_batches over the 64 genomes' ingest batches (one state)
    params = default_nucleotide_params(K, S, 42)
    pipe = IngestPipeline(paths, K, engine_mod.DEFAULT_CHUNK, 32,
                          pack_mode=1)
    try:
        batches = list(pipe.batches())
    finally:
        pipe.close()
    eng = engine_mod.SketchEngine(params, device="cuda:0")

    def fold(stream):
        state = eng.fold_batches(eng.empty_state(), stream, packed=True)
        ref = eng.state_to_ref(state)
        return ref.hashes.tobytes() + ref.counts.tobytes()

    def each_waited(items):
        for item in items:
            yield item
            torch.cuda.synchronize()  # after the batch's dispatch

    pipelined_vs_serialized(
        "fold_batches", lambda: fold(iter(batches)),
        lambda: fold(each_waited(batches)),
        {"batches": len(batches), "rows": sum(b.shape[0] for b in batches),
         "genomes": len(paths)})
    events = []
    with no_host_sync(events):
        state = eng.fold_batches(eng.empty_state(), iter(batches),
                                 packed=True)
    require(len(events) <= 2 * len(batches), "fold_batches waited %d "
            "times over %d batches" % (len(events), len(batches)))
    eng.state_to_ref(state)
    sync_checks = {"fold_batches": [len(batches), len(events)]}

    # the stripes of triangle_4096: the command, and the stripes alone
    serial = functools.partial(distance.stream_pair_stripes, depth=1)
    real = triangle_cmd.stream_pair_stripes

    def triangle(stripes):
        triangle_cmd.stream_pair_stripes = stripes
        try:
            return run_cli(["triangle", plasmids_msh], GPU)
        finally:
            triangle_cmd.stream_pair_stripes = real

    n = N_FAMILIES * FAMILY_SIZE
    pipelined_vs_serialized("triangle_4096", lambda: triangle(real),
                            lambda: triangle(serial),
                            {"sketches": n, "depth": 3})
    from mash_tpu_torch.io import capnp_msh

    H, N = distance.pad_sketches(
        [r.hashes for r in capnp_msh.read_msh(plasmids_msh).references], S)
    stripes = distance.stream_pair_stripes(H, N, H, N, S, "cuda",
                                           triangle=True, depth=3)
    seen = [next(stripes)]  # the set-up: one upload and the ranks
    events = []
    with no_host_sync(events):
        seen += list(stripes)
    tiles = sum(-(-st.shape[1] // 2048) for _, st in seen[1:])
    require(len(events) <= tiles, "the stripes waited %d times for %d "
            "tiles" % (len(events), tiles))
    sync_checks["stripes"] = [len(seen) - 1, len(events)]

    # the exact route over the first 10^5 reads of sketch -r -m 2
    reads_path = os.path.join(folder, "reads_R1.fq")
    records = list(itertools.islice(read_fastx(reads_path), N_ASYNC_READS))
    exact_params = default_nucleotide_params(K, S, 42)
    exact_params.reads = True
    exact_params.min_cov = 2
    exact = engine_mod.SketchEngine(exact_params, device="cuda:0")
    dispatch = engine_mod.SketchEngine.hash_bytes_async

    def exact_route():
        ref, _, count, _ = engine_mod.sketch_records_exact(
            exact, records, reads_path)
        return (ref.hashes.tobytes(), ref.counts.tobytes(), ref.comment,
                ref.length, count)

    def each_waited_chunk(self, data):
        out = dispatch(self, data)
        torch.cuda.synchronize()
        return out

    def exact_serialized():
        exact.hash_bytes_async = functools.partial(each_waited_chunk, exact)
        try:
            return exact_route()
        finally:
            del exact.hash_bytes_async

    bases = sum(len(r.seq) for r in records)
    chunks = -(-bases // engine_mod.DEFAULT_CHUNK)
    pipelined_vs_serialized("exact_route", exact_route, exact_serialized,
                            {"reads": len(records), "bases": bases,
                             "chunks_about": chunks})
    events = []
    with no_host_sync(events):
        engine_mod.sketch_records_exact(exact, records, reads_path)
    require(len(events) <= 3 * (chunks + 1), "the exact route waited %d "
            "times over about %d chunks" % (len(events), chunks))
    sync_checks["exact_route"] = [chunks, len(events)]
    pop_stage_totals()  # the sync checks' stages: no command's
    print(json.dumps({"sync_debug": "error", "paths": {
        k: {"batches": b, "event_waits": e}
        for k, (b, e) in sync_checks.items()}}), flush=True)
    print("phase async: ok in %.1f s" % (time.perf_counter() - t_phase),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_const", const="device",
                    help="also measure each main-path command's device "
                    "busy share with torch.profiler")
    ap.add_argument("--host-profile", action="store_const", const="host",
                    dest="profile", help="instead, run each main-path "
                    "command under cProfile and list its ten costliest "
                    "host functions")
    ap.add_argument("--rank-worker", metavar="CFG", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "mash_tpu_torch")):
        raise SmokeError("run chip_smoke.py from a checkout of the "
                         "repository (mash_tpu_torch/ is missing)")
    sys.path.insert(0, ROOT)
    if args.rank_worker:
        return rank_worker(args.rank_worker)
    # stage timings are switched on when the package is first imported
    os.environ["MASH_TPU_TORCH_TIMINGS"] = "1"
    import numpy as np
    import torch

    # phase 1: device
    require(torch.cuda.is_available(), "no CUDA device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print("device: %s | %s | torch %s, CUDA %s" % (
        kind, smi, torch.__version__, torch.version.cuda), flush=True)

    # phase 2: build
    from mash_tpu_torch import native
    from mash_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(["sketch_select", "pairwise", "screen_count",
                      "hash_windows", "fold_sorted"])
    require(native.load_library() is not None, "native library build")
    print("phase build: ok in %.1f s" % (time.perf_counter() - t0),
          flush=True)

    count_plain_on_card()
    rng = np.random.default_rng(args.seed)
    report = []
    with tempfile.TemporaryDirectory(prefix="mash_smoke_") as folder:
        phase_kernels(rng, report, folder)
        launches, paths, all_msh = phase_end_to_end(rng, folder, args.profile)
        screen_launches = phase_screen(rng, folder, paths, all_msh,
                                       args.profile)
        cmd_launches = {"screen": screen_launches}
        plasmids_msh = phase_reads(rng, folder, paths, all_msh, cmd_launches,
                                   args.profile)
        phase_triangle(report, folder, paths, all_msh, plasmids_msh,
                       cmd_launches, args.profile)
        find_head = phase_windowed(folder, rng, paths, all_msh, plasmids_msh,
                                   cmd_launches, args.profile)
        phase_ranks(folder, paths, all_msh, plasmids_msh, find_head)
        phase_mesh(rng, folder, paths)
        phase_async(folder, paths, plasmids_msh, args.seed)
    # each kernel's count from the run of the path that calls it
    for name in ("screen_table", "screen_count", "hash_windows"):
        launches[name] = screen_launches[name]

    sources = {
        "sketch_select": ("mash_tpu_torch/ops/csrc/sketch_select.cu",
                          "mash_tpu/ops/pallas_sketch.py:224"),
        "pairwise64": ("mash_tpu_torch/ops/csrc/pairwise.cu",
                       "mash_tpu/ops/pallas_pairwise.py:63"),
        "pairwise32": ("mash_tpu_torch/ops/csrc/pairwise.cu",
                       "mash_tpu/ops/pallas_pairwise.py:137"),
        "screen_count": ("mash_tpu_torch/ops/csrc/screen_count.cu",
                         "mash_tpu/ops/pallas_screen.py:77"),
        # the DB's table: K4's port keeps the DB in it instead of the TPU
        # kernel's sorted tiles
        "screen_table": ("mash_tpu_torch/ops/csrc/screen_count.cu",
                         "mash_tpu/ops/pallas_screen.py:77"),
        # a jax.jit function that XLA fuses, not a Pallas kernel
        "hash_windows": ("mash_tpu_torch/ops/csrc/hash_windows.cu",
                         "mash_tpu/ops/kmers.py:129"),
        # jax.jit functions that XLA fuses (_fold_sorted, merge_states,
        # tree_merge, sketch_chunks_pallas' fold tail), not a Pallas kernel
        "fold_sorted": ("mash_tpu_torch/ops/csrc/fold_sorted.cu",
                        "mash_tpu/ops/sketch_ops.py:52"),
    }
    kernels = []
    for r in report:
        # a shape off phases 4-5 reports the launches of the command that
        # runs it
        runs = cmd_launches.get(r.get("launches_from"), launches)
        print(json.dumps({**{k: v for k, v in r.items()
                             if k not in ("main", "launches_from")},
                          "launches": runs[r["name"]]}), flush=True)
        if r["main"]:
            src, rep = sources[r["name"]]
            kernels.append(dict(
                name=r["name"], route="cuda", source=src, replaces=rep,
                launches=launches[r["name"]], max_abs_err=r["max_abs_err"],
                ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"]))
    require(sorted(k["name"] for k in kernels) == sorted(sources),
            "kernel summary incomplete")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # every phase's failure ends the run
        import traceback

        traceback.print_exc()
        sys.stderr.write("chip_smoke: FAILED: %s\n" % e)
        code = 1
    sys.stdout.flush()
    raise SystemExit(code)
