"""Plain reference of the sketch path: each genome's bottom-s sketch.

A genome's sketch holds the s smallest distinct canonical k-mer hashes
of all its records, in unsigned order, each with the number of windows
that gave it (``MinHashHeap``'s counts in Mash).  Computed here from the
harness's own sequences with :mod:`h100_bench.reference.kmers`, never
from anything the program made.

The comparison: every genome the window finished is held against the
sketch of its pool genome, hashes and counts, exactly.  The control is
this reference in the program's place with hashes of half the width the
configuration states (32 bits for 64, 16 for 32).
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.outcome import Outcome
from h100_bench.reference.kmers import biased, window_hashes

# every check is a count of wrong answers: exact, so its limit is 0
LIMITS = {"sketches_wrong": 0}


def bottom_s(hashes: torch.Tensor, s: int):
    """The s smallest distinct values of ``hashes`` (int64 bits) in
    unsigned order with their multiplicities, as numpy uint64 and
    uint32."""
    u, c = torch.unique(biased(hashes), sorted=True, return_counts=True)
    u, c = biased(u[:s]), c[:s]
    return (u.cpu().numpy().view(np.uint64).copy(),
            c.cpu().numpy().astype(np.uint32))


def genome_sketch(records, config: dict, device, bits: int | None = None):
    """Sketch of one genome given as uint8 ASCII records."""
    bits = config["hash_bits"] if bits is None else bits
    # records joined by a 0 byte, which is no base: no valid window spans
    # two records, so this is each record's windows, in one call
    seq = np.concatenate([np.append(r, np.uint8(0)) for r in records])
    h, v = window_hashes(torch.from_numpy(seq).to(device),
                         config["kmer_size"], config["hash_seed"], bits)
    return bottom_s(h[v], config["sketch_size"])


def pool_sketches(config, data, device, bits=None):
    return [genome_sketch(recs, config, device, bits) for recs in data.genomes]


def expected(config, traffic, data, outcome, device):
    """The reference sketch of every pool genome."""
    return pool_sketches(config, data, device)


def judge(outcome, want) -> dict:
    """``sketches_wrong``: finished genomes whose sketch is not the
    reference's, hashes or counts, plus genomes due but missing."""
    results = outcome.answers["sketches"]
    wrong = outcome.units - len(results)
    for g, h, c in results:
        wh, wc = want[g]
        if not (np.array_equal(np.asarray(h, np.uint64), wh)
                and np.array_equal(np.asarray(c, np.uint32), wc)):
            wrong += 1
    return {"sketches_wrong": wrong}


def failed(found: dict, outcome, correct: bool) -> int:
    """Units whose answer was wrong: each wrong or missing sketch."""
    return int(found["sketches_wrong"])


def control_outcome(config, traffic, data, device):
    """The control: the reference in the program's place at half the
    hash width, one pass over the pool."""
    bits = config["hash_bits"] // 2
    results = [(g, h, c) for g, (h, c)
               in enumerate(pool_sketches(config, data, device, bits))]
    return Outcome(units=len(results), bases=int(data.lengths().sum()),
                   windows=0, answers={"sketches": results})
