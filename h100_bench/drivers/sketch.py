"""The sketch path of mash_tpu_torch, one genome after another.

Set-up parses each pool genome once with the program's
``IngestPipeline`` into host batches and sketches the whole pool once to
warm up.  The window then does for each genome what
``core/loader.py::_sketch_file_fast`` does for a file once it is parsed:
``SketchEngine.fold_batches(..., packed=True)`` on a fresh state, then
``SketchEngine.state_to_ref``, which settles the certificate and reads
the sketch back.  The pool is cycled until the window's time is up.
"""

from __future__ import annotations

import time

from mash_tpu_torch.core.engine import SketchEngine
from mash_tpu_torch.core.params import default_nucleotide_params

from h100_bench import feed
from h100_bench.outcome import Outcome


def params_of(config: dict):
    p = default_nucleotide_params(kmer_size=config["kmer_size"],
                                  sketch_size=config["sketch_size"],
                                  seed=config["hash_seed"])
    if p.use64 != (config["hash_bits"] == 64):
        raise ValueError("the configuration's hash_bits is not Mash's "
                         "width for k = %d" % config["kmer_size"])
    return p


def sketch(engine: SketchEngine, batches):
    return engine.state_to_ref(
        engine.fold_batches(engine.empty_state(), batches, packed=True))


class Setup:
    def __init__(self, config, traffic, data, device, spans):
        p = params_of(config)
        self.engine = SketchEngine(p, chunk_len=traffic["chunk_len"],
                                   device=device)
        n = len(data.genomes)
        self.batches = [feed.ingest(data.fasta(i), p.kmer_size,
                                    traffic["chunk_len"],
                                    traffic["batch_rows"])
                        for i in range(n)]
        self.bases = [int(x) for x in data.lengths()]
        self.windows = [data.windows(i, p.kmer_size) for i in range(n)]
        # a finished sketch: s hashes of 8 bytes and s counts of 4
        self.sketch_bytes = 12 * p.sketch_size
        for b in self.batches:  # warm-up: every batch shape of the pool
            sketch(self.engine, b)


def setup(config, traffic, data, device, spans) -> Setup:
    return Setup(config, traffic, data, device, spans)


def window(ctx: Setup, deadline: float, spans) -> Outcome:
    engine, batches = ctx.engine, ctx.batches
    n = len(batches)
    results = []
    done = bases = windows = 0
    while True:
        g = done % n
        with spans("fold"):
            state = engine.fold_batches(engine.empty_state(), batches[g],
                                        packed=True)
        with spans("read_sketch"):
            ref = engine.state_to_ref(state)
        results.append((g, ref.hashes, ref.counts))
        done += 1
        bases += ctx.bases[g]
        windows += ctx.windows[g]
        if time.perf_counter() >= deadline:
            break
    return Outcome(units=done, bases=bases, windows=windows,
                   out_bytes=done * ctx.sketch_bytes,
                   answers={"sketches": results})


def collect(outcome: Outcome) -> None:
    """After the window: nothing more to read, the sketches are on the
    host."""


def release(ctx: Setup) -> None:
    ctx.engine = None
    ctx.batches = None
