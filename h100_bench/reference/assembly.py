"""Plain reference of the assembly path: the assembly's bottom-s sketch,
computed in blocks so that a 3.09 Gbase genome fits on one card.

The records are one stream, each ended by a 0 byte (no base, so no valid
window spans two records).  The stream is cut into blocks of at most
``BLOCK`` bytes, each overlapping the next by k - 1 bytes, so that each
window lies in exactly one block.  Each block gives its s smallest
distinct hashes with their counts (:func:`h100_bench.reference.sketch.
bottom_s` of :func:`h100_bench.reference.kmers.window_hashes`); the union
of the blocks' lists, with the counts of equal hashes summed and cut to
the s smallest, is the genome's sketch.  That is exact: a hash of the
final bottom s has fewer than s distinct hashes below it in the whole
genome, so fewer in any block, and each block that holds it kept it with
its count.

The comparison is the sketch path's (:mod:`h100_bench.reference.sketch`):
every file the window finished against the reference, hashes and counts,
exactly.  The control is this reference in the program's place at half
the configuration's hash width.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.outcome import Outcome
from h100_bench.reference.kmers import window_hashes
from h100_bench.reference.sketch import (  # noqa: F401  (the path's API)
    LIMITS,
    bottom_s,
    failed,
    judge,
)

BLOCK = 256_000_000  # bytes of the stream in one block


def stream_blocks(records, k: int, block: int = BLOCK):
    """The blocks of the records' stream (each record and a 0 byte), as
    uint8 numpy arrays of at most ``block`` bytes, each starting k - 1
    bytes before the last one's end."""
    if block < k:
        raise ValueError("a block must hold a window")
    parts = []
    for r in records:
        parts += [r, np.zeros(1, np.uint8)]
    sizes = np.array([len(p) for p in parts], np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    total = int(starts[-1])
    lo = 0
    while True:
        hi = min(lo + block, total)
        first = int(np.searchsorted(starts, lo, side="right")) - 1
        out, at, i = np.empty(hi - lo, np.uint8), lo, first
        while at < hi:
            a = at - starts[i]
            take = min(hi - at, sizes[i] - a)
            out[at - lo: at - lo + take] = parts[i][a: a + take]
            at += take
            i += 1
        yield out
        if hi == total:
            return
        lo = hi - (k - 1)


def union_bottom_s(lists, s: int):
    """The s smallest distinct hashes of ``(hashes, counts)`` lists
    (uint64, uint32), each hash's counts summed."""
    h = np.concatenate([x for x, _ in lists])
    c = np.concatenate([y for _, y in lists]).astype(np.int64)
    u, inv = np.unique(h, return_inverse=True)  # unsigned order
    total = np.zeros(len(u), np.int64)
    np.add.at(total, inv, c)
    return u[:s].copy(), total[:s].astype(np.uint32)


def assembly_sketch(records, config: dict, device, bits: int | None = None,
                    block: int = BLOCK):
    """The sketch of one genome given as uint8 ASCII records."""
    bits = config["hash_bits"] if bits is None else bits
    k, s = config["kmer_size"], config["sketch_size"]
    lists = []
    for piece in stream_blocks(records, k, block):
        h, v = window_hashes(torch.from_numpy(piece).to(device), k,
                             config["hash_seed"], bits)
        lists.append(bottom_s(h[v], s))
        del h, v
    return union_bottom_s(lists, s)


def expected(config, traffic, data, outcome, device):
    """The reference sketch of the assembly."""
    return [assembly_sketch(data.genomes[0], config, device)]


def control_outcome(config, traffic, data, device):
    """The control: the reference in the program's place at half the
    hash width, one file."""
    h, c = assembly_sketch(data.genomes[0], config, device,
                           config["hash_bits"] // 2)
    return Outcome(units=1, bases=int(data.lengths().sum()), windows=0,
                   answers={"sketches": [(0, h, c)]})
