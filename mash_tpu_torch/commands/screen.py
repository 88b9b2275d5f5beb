"""``mash screen`` (reference ``CommandScreen.cpp``).

Streams mixture files read-packed into chunks (the reference's 1 MiB
``*``-separated blocks, ``CommandScreen.cpp:192-270``), hashes them on
the device, counts DB membership with the ``screen_count`` kernel, a
probe of a hash table of the DB (``ops.screen_ops.ScreenCounter``), and
estimates the mixture's cardinality with the bottom-s fold.  Identity,
p-value and median post-processing happen on the host.  Under a
multi-process launch the mixture files are sharded over the processes,
their counts summed and their cardinality states merged
(``parallel.multihost``); rank 0 alone writes the report.
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch

from mash_tpu_torch.cli.command import Command, Option
from mash_tpu_torch.core import stats
from mash_tpu_torch.core.loader import (
    SUFFIX_SKETCH,
    _fast_batch_rows,
    has_suffix,
    init_from_files,
)
from mash_tpu_torch.core.params import ALPHABET_PROTEIN, SketchParams
from mash_tpu_torch.io.fastx import read_fastx_multi
from mash_tpu_torch.io.formatting import cpp_double
from mash_tpu_torch.io.ingest import IngestPipeline, fast_ingest_eligible
from mash_tpu_torch.ops import screen_ops, sketch_ops
from mash_tpu_torch.ops.kmers import unpack_chunks
from mash_tpu_torch.parallel import multihost as mh
from mash_tpu_torch.utils import resolve_device, stage
from mash_tpu_torch.utils.transfer import Uploader

# The chunk sizes ``mash_tpu`` pads to (tiny inputs / full chunks), kept
# so both packages hash chunks of the same shapes.
_BUCKETS = (1 << 14, 1 << 20)


def _packed_chunks(records, k: int, chunk_len: int) -> Iterator[bytes]:
    """Pack whole records into ~chunk_len blocks with 0x00 separators.

    No record spans two chunks and records shorter than k are dropped,
    mirroring ``CommandScreen.cpp:224-261``.
    """
    buf = bytearray()
    for rec in records:
        ln = len(rec.seq)
        if ln < k:
            continue
        if buf and len(buf) + ln + 1 > chunk_len:
            yield bytes(buf)
            buf.clear()
        if buf:
            buf.append(0)
        buf += rec.seq
    if buf:
        yield bytes(buf)


def _pad_to_bucket(chunk: bytes, chunk_len: int) -> bytes:
    for b in _BUCKETS:
        if len(chunk) <= b:
            return chunk + b"\x00" * (b - len(chunk))
    m = ((len(chunk) + chunk_len - 1) // chunk_len) * chunk_len
    return chunk + b"\x00" * (m - len(chunk))


def stream_fold(fold, counts, state, records, k, trans, device,
                chunk_len=1 << 20):
    """Drive a screen fold over packed record chunks.

    Shared by ``screen`` and ``taxscreen``: packs records into
    0x00-separated ~1MiB chunks (the reference's '*'-separated blocks,
    ``CommandScreen.cpp:192-270``), optionally 6-frame translates them,
    and folds each through the device step.  Returns
    ``(counts, state, saw_any)``.

    ``saw_any`` reflects record PRESENCE, not k-validity: the reference
    counts every record (``CommandTaxScreen.cpp:331``) and only errors
    when none exist at all — a pool of records all shorter than k gets
    the no-valid-k-mers WARNING and a report, not an error.

    Chunks go up through pinned memory (``utils.transfer.Uploader``),
    so the host packs the next chunk while the card folds this one.
    """
    seen = {"any": False}
    uploader = Uploader(device)

    def upload(raw: bytes) -> torch.Tensor:
        return uploader.upload(np.frombuffer(raw, dtype=np.uint8))

    def _tracked(rs):
        for rec in rs:
            seen["any"] = True
            yield rec

    for raw in _packed_chunks(_tracked(records), k, chunk_len):
        if trans:
            arr = np.frombuffer(raw, dtype=np.uint8)
            arr = np.where(
                (arr > 96) & (arr < 123), arr - 32, arr
            ).astype(np.uint8)
            for frame in screen_ops.translate_frames(arr):
                if len(frame) < k:
                    continue
                padded = _pad_to_bucket(frame.tobytes(), chunk_len)
                counts, state = fold(counts, state, upload(padded))
        else:
            padded = _pad_to_bucket(raw, chunk_len)
            counts, state = fold(counts, state, upload(padded))
    return counts, state, seen["any"]


def stream_fold_fast(fold_rows, counts, state, files, k, params, device,
                     chunk_len=1 << 20):
    """Overlapped-ingest drive of a screen fold (raw or packed rows).

    The native pipeline's k-1-overlap rows count every k-mer window
    exactly once, as the record path's packing does, so counts and
    cardinality are unchanged.  Each batch holds filled rows only and is
    uploaded as given, through pinned memory (``utils.transfer.Uploader``)
    without waiting for the card.
    """
    pack = 0
    if params.alphabet_string() == "ACGT":
        pack = 2 if params.preserve_case else 1
    pipe = IngestPipeline(
        files, k, chunk_len, _fast_batch_rows(device), pack_mode=pack
    )
    uploader = Uploader(device)
    try:
        for batch in pipe.batches():
            dev = uploader.upload(batch)
            if pack:
                dev = unpack_chunks(dev, chunk_len)
            counts, state = fold_rows(counts, state, dev)
    finally:
        pipe.close()
    # record presence, not k-validity: a skipped (too-short) record
    # still counts as "saw input" (see stream_fold)
    saw_any = any(m.count > 0 or m.skipped for m in pipe.metas)
    return counts, state, saw_any


def load_screen_db(command, err):
    """Shared set-up of ``screen`` and ``taxscreen``: argument checks,
    parameters adopted from the DB sketch (``CommandScreen.cpp:81-91``).
    Returns ``(sketch, params, trans)``."""
    if not has_suffix(command.arguments[0], SUFFIX_SKETCH):
        err.write(
            "ERROR: %s does not look like a sketch (.msh)\n"
            % command.arguments[0]
        )
        raise SystemExit(1)
    # '-' (stdin) may only be the first mixture argument
    # (CommandScreen.cpp:240-244)
    for f, arg in enumerate(command.arguments[1:]):
        if arg == "-" and f > 0:
            err.write("ERROR: '-' for stdin must be first query\n")
            raise SystemExit(1)
    params = SketchParams()
    sketch = init_from_files([command.arguments[0]], params)
    params.parallelism = int(
        command.get_option("threads").get_argument_as_number()
    )
    params.kmer_size = sketch.params.kmer_size
    params.noncanonical = sketch.params.noncanonical
    params.preserve_case = sketch.params.preserve_case
    params.seed = sketch.params.seed
    params.min_hashes_per_window = sketch.params.min_hashes_per_window
    alphabet = sketch.params.alphabet_string()
    params.set_alphabet(alphabet)
    return sketch, params, alphabet == ALPHABET_PROTEIN


def stream_mixture(params, db_hashes, inputs, trans, err, device):
    """Stream the mixture through a screen fold on ``device``.

    Writes the reference's "Streaming from"/"Translating from" line
    first.  Returns ``(finalize, counts, state, saw_any)``:
    ``finalize(counts)`` gives this process's DB counts as uint32 numpy
    ``[H]``.  Under a multi-process launch this process streams its
    round-robin shard of ``inputs``; the returned state and ``saw_any``
    are already merged over every process, and the counts are summed
    with ``multihost.sum_counts_across_hosts``.
    """
    err.write(
        "%s%s...\n"
        % (
            "Translating from " if trans else "Streaming from ",
            inputs[0] if len(inputs) == 1 else "%d inputs" % len(inputs),
        )
    )
    s = params.min_hashes_per_window
    k = params.kmer_size
    fold, fold_rows, counts, finalize = screen_ops.make_screen_fold(
        params, db_hashes, s, device
    )
    state = sketch_ops.empty_state(s, device)
    # counts are plain per-hash totals and the cardinality state merges
    # associatively, so the reduction over the processes is exact
    inputs = mh.shard_paths(inputs)
    if not trans and fast_ingest_eligible(inputs):
        counts, state, saw_any = stream_fold_fast(
            fold_rows, counts, state, inputs, k, params, device
        )
    else:
        records = read_fastx_multi(inputs, round_robin=True)
        # record length gate: translated mode packs by nucleotide
        # length >= k, matching l >= kmerSize in the reference (the
        # translated k-mer needs 3k bases, but the gate is on bases, as
        # there).
        counts, state, saw_any = stream_fold(
            fold, counts, state, records, k, trans, device
        )
    state = mh.merge_states_across_hosts(state, s)
    _c, _t, saw_any = mh.reduce_meta_across_hosts(0, 0, saw_any)
    return finalize, counts, state, saw_any


class CommandScreen(Command):
    name = "screen"
    summary = (
        "Determine whether query sequences are within a larger mixture of "
        "sequences."
    )
    description = (
        "Determine how well query sequences are contained within a "
        "mixture of sequences. The queries must be formatted as a single "
        "Mash sketch file (.msh), created with the `mash sketch` command. "
        "The <mixture> files can be contigs or reads, in fasta or fastq, "
        'gzipped or not, and "-" can be given for <mixture> to read from '
        "standard input. The <mixture> sequences are assumed to be "
        "nucleotides, and will be 6-frame translated if the <queries> are "
        "amino acids. The output fields are [identity, shared-hashes, "
        "median-multiplicity, p-value, query-ID, query-comment], where "
        "median-multiplicity is computed for shared hashes, based on the "
        "number of observations of those hashes within the mixture."
    )
    argument_string = "<queries>.msh <mixture> [<mixture>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.use_option("threads")
        self.add_option(
            "winning!",
            Option(
                Option.BOOLEAN,
                "w",
                "",
                "Winner-takes-all strategy for identity estimates. After "
                "counting hashes for each query, hashes that appear in "
                "multiple queries will be removed from all except the one "
                "with the best identity (ties broken by larger query), and "
                "other identities will be reduced. This removes output "
                "redundancy, providing a rough compositional outline.",
                "",
            ),
        )
        self.add_option(
            "identity",
            Option(
                Option.NUMBER,
                "i",
                "Output",
                "Minimum identity to report. Inclusive unless set to zero, "
                "in which case only identities greater than zero (i.e. "
                "with at least one shared hash) will be reported. Set to "
                "-1 to output everything.",
                "0",
                -1.0,
                1.0,
            ),
        )
        self.add_option(
            "pvalue",
            Option(
                Option.NUMBER,
                "v",
                "Output",
                "Maximum p-value to report.",
                "1.0",
                0.0,
                1.0,
            ),
        )

    def run(self) -> int:
        if len(self.arguments) < 2 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        with stage("screen:load_msh"):
            sketch, params, trans = load_screen_db(self, err)
        pvalue_max = self.get_option("pvalue").get_argument_as_number()
        identity_min = self.get_option("identity").get_argument_as_number()
        device = resolve_device()

        err.write("Loading %s...\n" % self.arguments[0])
        refs = sketch.references
        with stage("screen:db_table"):
            db_hashes, seg_starts, ref_ids = screen_ops.build_db_table(
                [r.hashes for r in refs]
            )
        err.write("   %d distinct hashes.\n" % len(db_hashes))

        with stage("screen:stream"):
            finalize, counts, state, saw_any = stream_mixture(
                params, db_hashes, self.arguments[1:], trans, err, device
            )
        if not saw_any:
            err.write("\nERROR: Did not find sequence records in inputs\n")
            raise SystemExit(1)

        set_size = int(sketch_ops.estimate_set_size(state, params.use64))
        err.write(
            "   Estimated distinct%s k-mers in mixture: %d\n"
            % (" (translated)" if trans else "", set_size)
        )
        if set_size == 0:
            err.write("WARNING: no valid k-mers in input.\n")

        err.write("Summing shared...\n")
        with stage("screen:counts"):
            counts_host = mh.sum_counts_across_hosts(finalize(counts))
        if mh.process_index() != 0:
            return 0  # rank 0 writes the report
        min_cov = 1
        shared, depths = screen_ops.tally_shared(
            counts_host, seg_starts, ref_ids, len(refs), min_cov
        )

        k = params.kmer_size
        kmer_space = sketch.params.kmer_space
        if self.get_option("winning!").active:
            err.write("Reallocating to winners...\n")
            scores = np.array(
                [
                    stats.screen_identity(
                        int(shared[i]), len(refs[i].hashes), k
                    )
                    for i in range(len(refs))
                ]
            )
            lengths = np.array([r.length for r in refs], dtype=np.int64)
            shared, depths = screen_ops.winner_takes_all(
                counts_host, seg_starts, ref_ids, scores, lengths, min_cov
            )

        err.write("Computing coverage medians...\n")
        depths = [np.sort(d) for d in depths]

        err.write("Writing output...\n")
        for i, ref in enumerate(refs):
            sh = int(shared[i])
            if sh == 0 and identity_min >= 0.0:
                continue
            identity = stats.screen_identity(sh, len(ref.hashes), k)
            if identity < identity_min:
                continue
            pvalue = stats.pvalue_within(
                sh, set_size, kmer_space, len(ref.hashes)
            )
            if pvalue > pvalue_max:
                continue
            median = int(depths[i][sh // 2]) if sh > 0 else 0
            out.write(
                "%s\t%d/%d\t%d\t%s\t%s\t%s\n"
                % (
                    cpp_double(identity),
                    sh,
                    len(ref.hashes),
                    median,
                    cpp_double(pvalue),
                    ref.name,
                    ref.comment,
                )
            )
        return 0
