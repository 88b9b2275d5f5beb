"""Streaming FASTA/FASTQ reader (gzip-transparent).

Functional equivalent of the reference's vendored ``kseq.h`` (Heng Li's
parser macro over ``gzread``): records expose ``name`` (up to the first
whitespace), ``comment`` (remainder of the header line) and the sequence
bytes; FASTA sequences may span lines; FASTQ quality is read and discarded.
Reading from ``-`` means stdin.  This is host I/O and stays off-device.
"""

from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class Record:
    name: str
    comment: str
    seq: bytes

    def __len__(self) -> int:
        return len(self.seq)


def _open_stream(path: str):
    """Open ``path`` (or stdin for '-') with transparent gzip decoding."""
    if path == "-":
        raw = sys.stdin.buffer
    else:
        raw = open(path, "rb")
    head = raw.peek(2) if hasattr(raw, "peek") else b""
    if not hasattr(raw, "peek"):
        raw = io.BufferedReader(raw)
        head = raw.peek(2)
    if head[:2] == b"\x1f\x8b":
        return gzip.open(raw, "rb")
    return raw


def read_fastx(path: str) -> Iterator[Record]:
    """Yield records from a FASTA or FASTQ file (gzipped or not)."""
    stream = _open_stream(path)
    try:
        yield from parse_fastx(stream)
    finally:
        if path != "-":
            stream.close()


# kseq keeps only printable non-space bytes in sequences
# (``kseq.h:184-190``: isgraph, 33..126); everything else — newlines,
# CR, spaces, tabs, control bytes — is dropped wherever it appears.
_NON_GRAPH = bytes(c for c in range(256) if c < 33 or c > 126)
# quality bytes count when in [33, 127] (``kseq.h:206-207``)
_NON_QUAL = bytes(c for c in range(256) if c < 33 or c > 127)


def parse_fastx(stream) -> Iterator[Record]:
    """Parse an open binary stream of FASTA or FASTQ records.

    kseq ends a sequence at any of '>', '+' or '@' (``kseq.h:183``):
    a '+' introduces a quality section sized by the sequence (even
    after a '>' header), and a header marker ends the record directly
    (a truncated FASTQ record missing its '+' line must not swallow
    the next record into its sequence).
    """
    line = stream.readline()
    # skip leading blank lines
    while line and line.strip() == b"":
        line = stream.readline()
    while line:
        if line[:1] not in (b">", b"@"):
            # garbage line outside a record; mirror kseq by scanning
            # for the next marker
            line = stream.readline()
            continue
        header = line[1:].rstrip(b"\r\n")
        parts = []
        line = stream.readline()
        while line and line[:1] not in (b">", b"@", b"+"):
            s = line.translate(None, _NON_GRAPH)
            if s:
                parts.append(s)
            line = stream.readline()
        seq = b"".join(parts)
        if line and line[:1] == b"+":
            # quality: read as many qualifying bytes as the sequence
            qlen = 0
            line = stream.readline()
            while line and qlen < len(seq):
                qlen += len(line.translate(None, _NON_QUAL))
                line = stream.readline()
        yield _make_record(header, seq)


def _make_record(header: bytes, seq: bytes) -> Record:
    header_s = header.decode("utf-8", "replace")
    if not header_s:
        return Record("", "", seq)
    # kseq: name = up to first whitespace, comment = remainder (after the
    # single separator character).
    for i, ch in enumerate(header_s):
        if ch in " \t":
            return Record(header_s[:i], header_s[i + 1 :], seq)
    return Record(header_s, "", seq)


def read_fastx_multi(
    paths, round_robin: bool = False, with_pos: bool = False
) -> Iterator:
    """Read several files; optionally round-robin one record per file.

    The reference's reads mode interleaves records round-robin across all
    input files (``src/mash/Sketch.cpp:1200-1270``); bottom-s selection is
    order-independent so the default is sequential, but round-robin is
    available for exact-streaming parity paths.  ``with_pos`` yields
    ``(record, ordinal, file_index)`` instead of bare records (used by
    the multi-host reads path to elect the globally-first record).
    """
    if not round_robin:
        for fi, p in enumerate(paths):
            for r, rec in enumerate(read_fastx(p)):
                yield (rec, r, fi) if with_pos else rec
        return
    iters = [(fi, read_fastx(p)) for fi, p in enumerate(paths)]
    rnd = 0
    while iters:
        nxt = []
        for fi, it in iters:
            rec: Optional[Record] = next(it, None)
            if rec is not None:
                yield (rec, rnd, fi) if with_pos else rec
                nxt.append((fi, it))
        iters = nxt
        rnd += 1
