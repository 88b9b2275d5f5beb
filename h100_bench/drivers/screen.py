"""The screen path of mash_tpu_torch: a mixture streamed against a DB.

Set-up sketches the present genomes with the program's engine, builds
the DB as ``commands/screen.py`` does (``screen_ops.build_db_table``,
then ``screen_ops.make_screen_fold``, whose counter lays out the K4 table
of the DB), parses each mixture part once with ``IngestPipeline`` into
host batches, and streams the pool once and reports to warm up; the
counter is then built again, so the window's counts are the window's.

The window streams parts as ``commands/screen.py::stream_fold_fast``
does (a batch's padding rows cut, the upload through the program's
``Uploader``, ``unpack_chunks``, ``fold_rows``), cycling the pool until
its time is up, then computes the report as ``commands/screen.py`` does
after ``screen:counts``: ``finalize``, the cardinality, ``tally_shared``,
the sorted depths, and each reported DB sketch's identity, median
multiplicity and p-value.  No text is written.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch

from mash_tpu_torch.core import stats
from mash_tpu_torch.core.engine import SketchEngine
from mash_tpu_torch.ops import screen_ops, sketch_ops
from mash_tpu_torch.ops.kmers import unpack_chunks
from mash_tpu_torch.utils.transfer import Uploader

from h100_bench import feed
from h100_bench.drivers.sketch import params_of, sketch
from h100_bench.outcome import Outcome


class Setup:
    def __init__(self, config, traffic, data, device, spans):
        self.params = p = params_of(config)
        self.device = device
        self.chunk_len = L = traffic["chunk_len"]
        rows = traffic["batch_rows"]
        engine = SketchEngine(p, chunk_len=L, device=device)
        present = [sketch(engine, feed.ingest(data.fasta(i), p.kmer_size,
                                              L, rows)).hashes
                   for i in range(len(data.present))]
        del engine
        lists = [r for r in data.random_db]
        for j, slot in enumerate(data.present_slots):
            lists.insert(int(slot), present[j])
        self.sizes = [len(h) for h in lists]
        with spans("db_build"):
            self.db, self.seg_starts, self.ref_ids = \
                screen_ops.build_db_table(lists)
            self.fold = screen_ops.make_screen_fold(
                p, self.db, p.sketch_size, device)
            _sync(device)
        del lists
        self.parts = [feed.ingest(data.fastq(q), p.kmer_size, L, rows)
                      for q in range(data.parts)]
        self.part_bases = [data.part_bases(q) for q in range(data.parts)]
        self.part_windows = [data.part_windows(q, p.kmer_size)
                             for q in range(data.parts)]
        self.uploader = Uploader(device)
        # warm-up: the pool once and the report, on a counter then dropped
        self.stream(range(len(self.parts)), self.fold,
                    lambda name: contextlib.nullcontext())
        self.fold = None
        self.fold = screen_ops.make_screen_fold(p, self.db, p.sketch_size,
                                                device)

    def stream(self, parts, fold, spans, deadline=None):
        _, fold_rows, counts, finalize = fold
        state = sketch_ops.empty_state(self.params.sketch_size, self.device)
        done = bases = windows = 0
        for q in parts:
            with spans("stream"):
                for batch in self.parts[q]:
                    rows = batch.shape[0]
                    while rows > 1 and not batch[rows - 1].any():
                        rows -= 1
                    dev = unpack_chunks(self.uploader.upload(batch[:rows]),
                                        self.chunk_len)
                    counts, state = fold_rows(counts, state, dev)
            done += 1
            bases += self.part_bases[q]
            windows += self.part_windows[q]
            if deadline is not None and time.perf_counter() >= deadline:
                break
        with spans("report"):
            answers = self.report(finalize(counts), state)
        # the DB's hashes read once, their uint32 counts written once
        return Outcome(units=done, bases=bases, windows=windows,
                       out_bytes=12 * len(self.db), answers=answers)

    def report(self, counts: np.ndarray, state) -> dict:
        p = self.params
        k = p.kmer_size
        set_size = int(sketch_ops.estimate_set_size(state, p.use64))
        shared, depths = screen_ops.tally_shared(
            counts, self.seg_starts, self.ref_ids, len(self.sizes), 1)
        depths = [np.sort(d) for d in depths]
        kmer_space = p.kmer_space
        idx = np.flatnonzero(shared)
        sh = shared[idx]
        identity = [stats.screen_identity(int(a), self.sizes[i], k)
                    for i, a in zip(idx, sh)]
        pvalue = [stats.pvalue_within(int(a), set_size, kmer_space,
                                      self.sizes[i])
                  for i, a in zip(idx, sh)]
        median = [int(depths[i][a // 2]) for i, a in zip(idx, sh)]
        h, c = state
        return {
            "db_hashes": self.db, "counts": counts,
            "state": (h, c), "set_size": set_size,
            "report": {"ref": idx, "shared": sh, "median": np.array(median),
                       "identity": np.array(identity),
                       "pvalue": np.array(pvalue)},
        }


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config, traffic, data, device, spans) -> Setup:
    return Setup(config, traffic, data, device, spans)


def window(ctx: Setup, deadline: float, spans) -> Outcome:
    n = len(ctx.parts)
    return ctx.stream((q % n for q in itertools.count()), ctx.fold, spans,
                      deadline)


def collect(outcome: Outcome) -> None:
    """After the window: the cardinality sketch read back for the
    comparison, its filled entries."""
    h, c = outcome.answers.pop("state")
    h, c = h.cpu().numpy(), c.cpu().numpy()
    keep = c > 0
    outcome.answers["state_h"] = h[keep].view(np.uint64)
    outcome.answers["state_c"] = c[keep]


def release(ctx: Setup) -> None:
    ctx.fold = None
    ctx.parts = None
    ctx.uploader = None
