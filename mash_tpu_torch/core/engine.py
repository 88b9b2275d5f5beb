"""Host-side orchestration: stream sequence bytes through device kernels.

The counterpart of ``mash_tpu.core.engine``.  Sequences are concatenated
with 0x00 separators, cut into overlapping chunks, hashed and
bottom-s-reduced on the device (``ops.sketch_kernel``), and folded into
a running sketch state with the associative merge.  The state stays on
the device until the caller reads it back.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.core.sketch import SketchRef
from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.ops.kmers import alphabet_bytes, unpack_chunks
from mash_tpu_torch.ops.sketch_kernel import sketch_chunks_auto
from mash_tpu_torch.utils import resolve_device, stage

DEFAULT_CHUNK = 1 << 20


def chunk_stream(
    seqs: Iterable[bytes], k: int, chunk_len: int
) -> Iterator[Tuple[bytes, int]]:
    """Cut a stream of sequences into overlapping fixed-size chunks.

    Sequences are separated by a 0x00 byte (never in an alphabet, so
    cross-sequence windows are masked, like the reference ``screen``'s
    ``*`` separators).  Consecutive chunks overlap by k-1 bytes so no
    window is lost.  Yields ``(chunk_bytes, used_len)``; the final chunk
    may be shorter than ``chunk_len``.
    """
    buf = bytearray()
    step = chunk_len - (k - 1)
    if step <= 0:
        raise ValueError("chunk_len must exceed k - 1")
    first = True
    for seq in seqs:
        if not first:
            buf.append(0)
        first = False
        buf += seq
        while len(buf) >= chunk_len:
            yield bytes(buf[:chunk_len]), chunk_len
            del buf[:step]
    if len(buf) >= k:
        yield bytes(buf), len(buf)


class SketchEngine:
    """Sketching pipeline for one parameter set on one device.

    ``device`` defaults to ``cuda`` (or ``$MASH_TPU_TORCH_DEVICE``); the
    CPU runs only when asked for.
    """

    def __init__(
        self,
        params: SketchParams,
        chunk_len: int = DEFAULT_CHUNK,
        device=None,
    ):
        self.params = params
        self.chunk_len = chunk_len
        self.device = resolve_device(device)
        self._alpha = alphabet_bytes(params.alphabet)

    def _fold_rows(self, state, chunks: torch.Tensor):
        """Fold a ``[B, L]`` uint8 device batch into ``state``."""
        p = self.params
        s = p.sketch_size
        sh, sc = sketch_chunks_auto(
            chunks,
            alphabet=self._alpha,
            k=p.kmer_size,
            seed=p.seed,
            use64=p.use64,
            noncanonical=p.noncanonical,
            preserve_case=p.preserve_case,
            s=s,
        )
        return sketch_ops.tree_merge(
            torch.cat([state[0][None], sh]),
            torch.cat([state[1][None], sc]),
            s=s,
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- public API ----------------------------------------------------------

    def empty_state(self):
        return sketch_ops.empty_state(self.params.sketch_size, self.device)

    def fold_chunk(self, state, chunk: bytes):
        """Fold one raw chunk (any length >= k) into the sketch state."""
        if len(chunk) > self.chunk_len:
            return self.fold_stream(
                state,
                chunk_stream([chunk], self.params.kmer_size, self.chunk_len),
            )
        row = np.frombuffer(chunk, dtype=np.uint8)[None]
        return self._fold_rows(state, self._upload(row))

    def fold_stream(self, state, chunks, batch_rows: int = 8):
        """Fold an iterator of (chunk_bytes, used_len) with row batching.

        Chunks are stacked ``batch_rows`` at a time.  A batch is padded
        with 0x00 only to its longest chunk (0x00 is never in an
        alphabet, so padded windows are masked out) and never with empty
        rows: eager PyTorch compiles nothing per shape, so the fixed
        ``[batch_rows, chunk_len]`` shape of ``mash_tpu`` buys nothing.
        """
        rows = []

        def flush(state):
            width = max(len(r) for r in rows)
            arr = np.zeros((len(rows), width), dtype=np.uint8)
            for i, r in enumerate(rows):
                arr[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
            with stage("engine:fold_batch"):
                return self._fold_rows(state, self._upload(arr))

        for chunk, used in chunks:
            rows.append(chunk[:used])
            if len(rows) == batch_rows:
                state = flush(state)
                rows = []
        if rows:
            state = flush(state)
        return state

    def fold_batches(self, state, batches, packed: bool = False):
        """Fold ready ``[batch_rows, W]`` host batches.

        The fast-ingest counterpart of :meth:`fold_stream`: batches come
        pre-packed from :class:`mash_tpu_torch.io.ingest.IngestPipeline`
        (2-bit codes + validity mask when ``packed``) and are unpacked on
        the device.  The pipeline pads a file's last batch with zero
        rows, which hold no valid window; they are cut before the upload,
        since eager PyTorch gains nothing from the fixed batch shape.
        """
        for arr in batches:
            rows = arr.shape[0]
            while rows > 1 and not arr[rows - 1].any():
                rows -= 1
            with stage("engine:fold_batch"):
                dev = self._upload(arr[:rows])
                if packed:
                    dev = unpack_chunks(dev, self.chunk_len)
                state = self._fold_rows(state, dev)
        return state

    def sketch_seqs(self, seqs: Iterable[bytes]):
        """Sketch a stream of sequences into one bottom-s state."""
        state = self.empty_state()
        return self.fold_stream(
            state,
            chunk_stream(seqs, self.params.kmer_size, self.chunk_len),
        )

    def state_to_ref(
        self,
        state,
        name: str = "",
        comment: str = "",
        length: int = 0,
    ) -> SketchRef:
        """Read a device state back into a host SketchRef."""
        h = state[0].cpu().numpy().view(np.uint64)
        c = state[1].cpu().numpy()
        n = int((c > 0).sum())
        return SketchRef(
            name=name,
            comment=comment,
            length=length,
            hashes=h[:n].copy(),
            counts=c[:n].astype(np.uint32),
            counts_sorted=True,
        )

    def estimate_set_size(self, state) -> float:
        return sketch_ops.estimate_set_size(state, self.params.use64)

    def estimate_multiplicity(self, state) -> float:
        return sketch_ops.estimate_multiplicity(state)


# ---------------------------------------------------------------------------
# Record-level sketching with the reference's naming rules.
# ---------------------------------------------------------------------------

def sketch_records_concat(
    engine: SketchEngine,
    records,
    file_name: str,
    is_stdin: bool = False,
):
    """Sketch a whole file/stream of records into one SketchRef.

    Replicates ``sketchFile`` (``src/mash/Sketch.cpp:1147-1336``): records
    shorter than k are skipped; name is the file name (or the first record
    name for stdin); the comment is the first record's header, wrapped with
    "[N seqs] ... [...]" when several records contribute.
    """
    p = engine.params
    k = p.kmer_size
    state = engine.empty_state()
    count = 0
    total_len = 0
    name = "" if is_stdin else file_name
    comment = ""
    skipped = False

    def gen():
        nonlocal count, total_len, name, comment, skipped
        for rec in records:
            if len(rec.seq) < k:
                skipped = True
                continue
            if count == 0:
                if is_stdin:
                    name = rec.name
                    comment = rec.comment or ""
                else:
                    comment = rec.name + " " + (rec.comment or "")
            count += 1
            if not p.reads:
                total_len += len(rec.seq)
            yield rec.seq

    state = engine.fold_stream(
        state, chunk_stream(gen(), k, engine.chunk_len)
    )

    if p.reads:
        if p.genome_size != 0:
            total_len = p.genome_size
        else:
            total_len = int(engine.estimate_set_size(state))

    if count > 1:
        comment = "[%d seqs] %s [...]" % (count, comment)

    ref = engine.state_to_ref(state, name, comment, total_len)
    return ref, state, count, skipped
