"""Overlapped host ingest pipeline: file -> parse/pack -> device batches.

The replacement for the reference's I/O<->compute overlap
(``src/mash/ThreadPool.hxx:12-230`` ordered producer/consumer pool;
``src/mash/CommandScreen.cpp:155-270`` round-robin chunk streaming): a
background thread reads raw file blocks, decompresses gzip, and runs the
native C++ parser/packer (``native/mash_native.cpp`` ``mash_ingest_*``)
to produce ready-to-upload ``[rows, chunk_len]`` uint8 batches in the
engine's chunk layout.  The main thread drains the bounded queue and
dispatches device uploads + folds, so parsing overlaps device work.
``mash_tpu.io.ingest`` with the imports renamed, except that the last
batch carries its filled rows only, where ``mash_tpu`` pads it with zero
rows to the fixed shape its compiled folds need, and that on a host with
CUDA the parser writes each batch straight into pinned (page-locked)
memory, which ``utils.transfer.Uploader`` sends to the card as it is.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from mash_tpu_torch.io.fastx import _open_stream
from mash_tpu_torch.utils.profiling import count

DEFAULT_BLOCK = 8 << 20
DEFAULT_DEPTH = 4


@dataclass
class FileMeta:
    """Per-file record metadata gathered by the native parser."""

    path: str
    count: int            # records with len >= k
    total_len: int        # summed length of those records
    skipped: bool         # any record shorter than k was seen
    first_ordinal: int    # stream index of the first valid record (-1: none)
    first_header: str     # its raw header line (name + comment)

    def name_comment(self, is_stdin: bool) -> tuple:
        """(name, comment) under the reference's naming rules.

        ``sketchFile`` uses the file name and the full first header as
        the comment for files, and the first record's name/comment for
        stdin (``src/mash/Sketch.cpp:1216-1236``).
        """
        header = self.first_header
        name = header
        rest = ""
        for i, ch in enumerate(header):
            if ch in " \t":
                name, rest = header[:i], header[i + 1 :]
                break
        if is_stdin:
            return name, rest
        return self.path, name + " " + rest


class IngestPipeline:
    """Background parse/pack of one or more files into device batches.

    Yields C-contiguous ``[rows, row_bytes]`` uint8 arrays: every batch
    but the last holds ``batch_rows`` rows, and the last holds only its
    filled rows (1 to ``batch_rows``), so a consumer never sees a padding
    row.  The rows cut from the last batch are counted as
    ``ingest:padding_rows_cut``.  After the generator is exhausted,
    ``metas`` holds one :class:`FileMeta` per input path, in order.

    Where CUDA is available each batch lives in pinned memory (a
    ``.numpy()`` view of a pinned tensor from torch's caching host
    allocator, which recycles the blocks of dropped batches), so that
    ``utils.transfer.Uploader`` sends it to the card without copying it
    first; elsewhere it is a plain ``np.empty`` array.  Either way it is
    a writable C-contiguous uint8 ``np.ndarray`` of the same bytes.  The
    pipeline hands each batch over for good and never writes it again,
    and no holder may write it either while an upload of it can still
    be in flight.
    """

    def __init__(
        self,
        paths: Sequence[str],
        k: int,
        chunk_len: int,
        batch_rows: int,
        block: int = DEFAULT_BLOCK,
        depth: int = DEFAULT_DEPTH,
        pack_mode: int = 0,
    ):
        self.paths = list(paths)
        self.k = k
        self.chunk_len = chunk_len
        self.batch_rows = batch_rows
        self.block = block
        self.pack_mode = pack_mode
        self.row_bytes = (
            chunk_len // 4 + chunk_len // 8 if pack_mode else chunk_len
        )
        self.metas: List[FileMeta] = []
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(depth)
        self._err: Optional[BaseException] = None
        self._abandoned = False  # consumer dropped batches() mid-stream
        self._pinned = torch.cuda.is_available()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    # -- producer (background thread) ------------------------------------

    def _put(self, item) -> None:
        """Bounded put that gives up if the consumer abandoned the
        generator (otherwise the thread and its open file would block
        forever on a full queue)."""
        while True:
            if self._abandoned:
                raise GeneratorExit
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _buffer(self) -> np.ndarray:
        """A fresh ``[batch_rows, row_bytes]`` batch buffer, pinned where
        CUDA is available."""
        shape = (self.batch_rows, self.row_bytes)
        if self._pinned:
            return torch.empty(shape, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(shape, dtype=np.uint8)

    def _work(self) -> None:
        from mash_tpu_torch.native import NativeIngest

        try:
            R, L = self.batch_rows, self.chunk_len
            W = self.row_bytes
            step = L - (self.k - 1)
            spill_cap = (self.block + L) // step + 3
            spill = np.empty((spill_cap, W), dtype=np.uint8)
            batch = self._buffer()
            fill = 0
            put = self._put

            def ship():
                # hand the full buffer over and start a fresh one — the
                # consumer owns shipped batches (no reuse)
                nonlocal batch, fill
                put(batch)
                batch = self._buffer()
                fill = 0

            def absorb(rows: np.ndarray, n: int):
                # copy spill/finish rows into the batch buffer
                nonlocal fill
                i = 0
                while i < n:
                    take = min(R - fill, n - i)
                    batch[fill : fill + take] = rows[i : i + take]
                    fill += take
                    i += take
                    if fill == R:
                        ship()

            for path in self.paths:
                ing = NativeIngest(L, self.k, self.pack_mode)
                stream = _open_stream(path)
                try:
                    while True:
                        blk = stream.read(self.block)
                        if not blk:
                            break
                        m, sp = ing.feed_into(blk, batch, fill, spill)
                        fill += m
                        if fill == R:
                            ship()
                        if sp:
                            absorb(spill, sp)
                finally:
                    if path != "-":
                        stream.close()
                tail_rows = ing.finish()
                absorb(tail_rows, tail_rows.shape[0])
                self.metas.append(
                    FileMeta(
                        path=path,
                        count=ing.count,
                        total_len=ing.total_len,
                        skipped=ing.skipped,
                        first_ordinal=ing.first_ordinal,
                        first_header=ing.first_header,
                    )
                )
            if fill:
                count("ingest:padding_rows_cut", R - fill)
                put(batch[:fill])
            put(None)
        except GeneratorExit:
            pass  # consumer abandoned the stream; just exit
        except BaseException as e:  # surfaced to the consumer
            self._err = e
            try:
                self._put(None)
            except GeneratorExit:
                pass

    # -- consumer ---------------------------------------------------------

    def batches(self) -> Iterator[np.ndarray]:
        try:
            while True:
                b = self._q.get()
                if b is None:
                    self._thread.join()
                    if self._err is not None:
                        raise self._err
                    return
                yield b
        finally:
            # unblock the producer if we are abandoned mid-stream
            self.close()

    def close(self) -> None:
        """Abandon the stream: unblock and stop the producer (idempotent).

        Consumers call this in a ``finally`` block — a generator that
        is never iterated runs no ``finally`` of its own, so an error
        raised between pipeline construction and the first batch would
        otherwise leave the producer thread spinning on a full queue
        with its input file open for the life of the process.
        """
        self._abandoned = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)


def ingest_available() -> bool:
    """Whether the native parser/packer can be used."""
    from mash_tpu_torch.native import load_library

    return load_library() is not None


# Inputs at least this large (total) take the overlapped pipeline;
# smaller ones stay on the record paths (cheaper compiles, and the
# golden fixtures always exercise the parity-pinned paths).
FAST_INGEST_MIN_BYTES = 4 << 20


def fast_ingest_eligible(paths: Sequence[str]) -> bool:
    """Shared gate for the fast paths: real files, big enough, native
    library present.  Callers add their own mode conditions (e.g. not
    translated, not exact-streaming)."""
    import os

    paths = list(paths)
    if not paths or any(p == "-" for p in paths):
        return False
    try:
        total = sum(os.path.getsize(p) for p in paths)
    except OSError:
        return False
    return total >= FAST_INGEST_MIN_BYTES and ingest_available()
