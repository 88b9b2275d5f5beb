"""``mash find`` — windowed local similarity search (reference
``CommandFind.cpp``, compile-gated behind ``COMMAND_FIND`` there).

The reference (windowed .msw sketch) stores minmer (position, hash) loci;
each query sequence's minmers (both strands) are looked up in the
reference's hash->loci index and clustered into query-length windows;
clusters scoring above the threshold are reported (optionally only the
best N).  The query minmers' hashes run on the device
(:meth:`SketchEngine.windowed_positions`); the lookup and clustering run
on the host.  Under a multi-process launch rank 0 alone computes and
writes everything.
"""

from __future__ import annotations

import heapq
import sys

import numpy as np

from mash_tpu_torch.cli.command import Command, Option
from mash_tpu_torch.cli.setup import sketch_parameter_setup
from mash_tpu_torch.core.engine import SketchEngine
from mash_tpu_torch.core.loader import (
    SUFFIX_SKETCH,
    SUFFIX_SKETCH_WINDOWED,
    has_suffix,
    init_from_files,
)
from mash_tpu_torch.io.fastx import read_fastx
from mash_tpu_torch.io.formatting import cpp_double
from mash_tpu_torch.parallel import multihost as mh
from mash_tpu_torch.utils import resolve_device

# find's uppercase rule: c > 90 -> c - 32 for every byte
# (``CommandFind.cpp:216-222``)
_FIND_UPPER = bytes(c - 32 if c > 90 else c for c in range(256))
# complement used by find's minus strand: ACGT only, others unchanged
# (``CommandFind.cpp:259-266`` switch)
_FIND_COMP = bytes(
    {65: 84, 84: 65, 67: 71, 71: 67}.get(c, c) for c in range(256)
)


def _hit_key(ref: int, start: int, end: int, minus: bool, score: float):
    """heapq key such that heap[0] equals the reference pq's top (the hit
    popped first: lowest score, then largest ref/start, minus first
    (``CommandFind.cpp:403-423``))."""
    return (score, -ref, -start, 0 if minus else 1)


class CommandFind(Command):
    name = "find"
    summary = (
        "Find regions of references that have similarity to query "
        "sequences."
    )
    description = (
        "Compare query sequences to a reference. <reference> can be a "
        "fasta file (gzipped or not) or a mash windowed sketch file "
        "(.msw). <query> can be fasta or fastq, gzipped or not. Multiple "
        'query files can be provided, or "-" can be given to read from '
        "standard input."
    )
    argument_string = "<reference> <query> [<query>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "threshold",
            Option(
                Option.NUMBER,
                "t",
                "Output",
                "Threshold. This fraction of the query sequence's "
                "min-hashes must appear in a query-sized window of a "
                "reference sequence for the match to be reported.",
                "0.2",
                0.0,
                1.0,
            ),
        )
        self.add_option(
            "best",
            Option(
                Option.INTEGER,
                "b",
                "Output",
                "Best hit count. This many of the best hits will be "
                "reported (0 to report all hits). Score ties are broken "
                "by keeping the hit to the earlier reference or to the "
                "left-most position.",
                "0",
            ),
        )
        self.add_option(
            "self",
            Option(
                Option.BOOLEAN,
                "self",
                "Output",
                "Ignore self matches if query ID appears in reference.",
                "",
            ),
        )
        self.use_sketch_options()
        self.use_option("windowed")
        self.use_option("window")
        self.use_option("factor")

    def run(self) -> int:
        if len(self.arguments) < 2 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        # small-output command: rank 0 computes and writes everything
        # (a multi-process launch joins the group for every command;
        # without this gate every process would print the full output)
        if mh.process_index() != 0:
            return 0
        threshold = self.get_option("threshold").get_argument_as_number()
        best = int(self.get_option("best").get_argument_as_number())
        if best < 0:
            err.write("ERROR: The argument to -b cannot be negative.\n")
            return 1
        self_matches = not self.get_option("self").active

        params = sketch_parameter_setup(self)
        if params is None:
            return 1
        params.windowed = True
        params.concatenated = False

        file_reference = self.arguments[0]
        if has_suffix(file_reference, SUFFIX_SKETCH):
            err.write(
                "ERROR: Reference (%s) looks like a sketch but is not "
                "windowed.\n" % file_reference
            )
            return 1
        if has_suffix(file_reference, SUFFIX_SKETCH_WINDOWED):
            for name in ("kmer", "sketchSize", "window"):
                if self.get_option(name).active:
                    err.write(
                        "ERROR: The options k, s and L cannot be used when "
                        "a sketch is provided; these are inherited from "
                        "the sketch.\n"
                    )
                    return 1
        else:
            factor = self.get_option("factor").get_argument_as_number()
            if factor <= 0:
                err.write(
                    "ERROR: The argument to -f must be positive.\n"
                )
                return 1
            window_size = int(
                self.get_option("window").get_argument_as_number()
            )
            err.write(
                'Sketching %s (provide sketch file made with "mash '
                'sketch" to skip)...\n' % file_reference
            )
            params.min_hashes_per_window = int(window_size / factor)
            params.window_size = window_size

        device = resolve_device()
        sketch = init_from_files([file_reference], params, device=device)
        loci_by_hash = sketch.loci_by_hash()
        k = sketch.params.kmer_size

        engine = SketchEngine(sketch.params.copy(), device=device)

        for path in self.arguments[1:]:
            for rec in read_fastx(path):
                if len(rec.seq) < k:
                    continue
                self._find_record(
                    out,
                    sketch,
                    loci_by_hash,
                    engine,
                    rec,
                    threshold,
                    best,
                    self_matches,
                )
        return 0

    def _find_record(
        self,
        out,
        sketch,
        loci_by_hash,
        engine,
        rec,
        threshold,
        best,
        self_matches,
    ):
        seq = rec.seq.translate(_FIND_UPPER)
        length = len(seq)
        self_index = sketch.reference_index(rec.name)
        heap = []  # (key, ref, start, end, minus, score)

        for minus in (False, True):
            strand_seq = seq[::-1].translate(_FIND_COMP) if minus else seq
            _pos, hashes = engine.windowed_positions(strand_seq)
            min_hashes = set(hashes.tolist())
            if not min_hashes:
                continue

            hits_by_ref = {}
            for h in min_hashes:
                for ref_idx, pos in loci_by_hash.get(h, ()):
                    if ref_idx != self_index or self_matches:
                        hits_by_ref.setdefault(ref_idx, set()).add(pos)

            for ref_idx in sorted(hits_by_ref):
                positions = sorted(hits_by_ref[ref_idx])
                n = len(positions)
                w = 0  # window start index
                j = 0
                while j < n:
                    # drop positions too far behind (cluster wider than
                    # the query length)
                    while (
                        w != j
                        and positions[j] > length
                        and positions[w] < positions[j] - length + 1
                    ):
                        w += 1
                    # extend right while the span stays under the query
                    # length
                    while (
                        j + 1 < n
                        and positions[j + 1] - positions[w] < length
                    ):
                        j += 1
                    count = j - w + 1
                    score = float(
                        np.float32(count) / np.float32(len(min_hashes))
                    )
                    if score >= threshold:
                        key = _hit_key(
                            ref_idx,
                            positions[w],
                            positions[j],
                            minus,
                            score,
                        )
                        if (
                            best == 0
                            or len(heap) < best
                            or key > heap[0][0]
                        ):
                            heapq.heappush(
                                heap,
                                (
                                    key,
                                    ref_idx,
                                    positions[w],
                                    positions[j],
                                    minus,
                                    score,
                                ),
                            )
                            if best != 0 and len(heap) > best:
                                heapq.heappop(heap)
                    j += 1

        # best hits first (reverse pop order, ``CommandFind.cpp:179-206``)
        for key, ref_idx, start, end, minus, score in sorted(
            heap, key=lambda x: x[0], reverse=True
        ):
            out.write(
                "%s\t%s\t%d\t%d\t%c\t%s\n"
                % (
                    rec.name,
                    sketch.references[ref_idx].name,
                    start,
                    end,
                    "-" if minus else "+",
                    cpp_double(score),
                )
            )
