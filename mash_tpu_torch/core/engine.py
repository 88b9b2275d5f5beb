"""Host-side orchestration: stream sequence bytes through device kernels.

The counterpart of ``mash_tpu.core.engine``.  Sequences are concatenated
with 0x00 separators, cut into overlapping chunks, hashed and
bottom-s-reduced on the device (``ops.sketch_kernel``), and folded into
a running sketch state with the associative merge.  The state stays on
the device until the caller reads it back.  The route is the same code
on every device: on a CPU tensor each kernel's plain twin runs in its
place, deferred certificate included.

Nothing on the streaming paths waits for the card, as in ``mash_tpu``:
batches are uploaded through pinned memory (``utils.transfer.Uploader``),
and the sketch kernel's certificate is settled one batch behind
(``ops.sketch_ops.fold_batch``): a fold returns a
``sketch_ops.PendingState`` when its last batch had rows without the
certificate, and reading the state settles it.  The exact route keeps
one chunk's hashing in flight while the host inserts the previous one.

Two record-level modes keep ``mash_tpu``'s semantics: the exact stream
(``sketch_records_exact``: hashes on the device, bottom-s selection
through the native ``ExactHeap`` in record order, for ``-m``, ``-b``,
``-c`` and ``-M``) and per-record batches (``sketch_records_individual``,
``-i``).  Windowed mode (``-W``, ``find``) hashes each record's raw
forward strand on the device and picks its minmers with the native sweep
(``SketchEngine.windowed_positions``).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.core.sketch import SketchRef
from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.ops.kmers import hash_chunk, hash_kw, unpack_chunks
from mash_tpu_torch.ops.sketch_kernel import (
    sketch_chunks_deferred,
    sketch_chunks_fused,
)
from mash_tpu_torch.parallel.mesh import (
    local_mesh,
    sharded_sketch_chunks_deferred,
)
from mash_tpu_torch.utils import resolve_device, stage
from mash_tpu_torch.utils.transfer import Readback, Uploader, to_host

DEFAULT_CHUNK = 1 << 20
# Per-record rows are padded to one of these lengths (``mash_tpu``'s
# buckets), so the sketch kernel sees one shape per bucket.
_BUCKETS = (1 << 12, 1 << 14, 1 << 16, 1 << 18, DEFAULT_CHUNK)


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
    """Sketching pipeline for one parameter set.

    ``device`` defaults to ``cuda`` (or ``$MASH_TPU_TORCH_DEVICE``); the
    CPU runs only when asked for.  ``cuda`` without an index spans every
    visible GPU (``parallel.mesh.local_mesh``).
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
        self.devices = local_mesh(self.device)
        self._hash_kw = hash_kw(params)
        self._uploader = Uploader(self.device)

    def _fold_rows(self, state, chunks: torch.Tensor, chunk_len=None):
        """Fold a ``[B, L]`` uint8 device batch into ``state`` without
        reading the device (``sketch_ops.fold_batch``).

        With ``chunk_len`` the rows are packed ingest rows (see
        ``ops.kmers.unpack_chunks``).  When the engine spans several
        devices and ``B`` divides by their count, the rows are sharded
        over them (``parallel.mesh.sharded_sketch_chunks_deferred``); the
        fold is associative, so this is exact.
        """
        s = self.params.sketch_size
        if len(self.devices) > 1 and chunks.shape[0] % len(self.devices) == 0:
            (mh, mc), pending = sharded_sketch_chunks_deferred(
                self.devices, self.params, chunks, s, chunk_len=chunk_len)
            return sketch_ops.fold_batch(state, mh[None], mc[None], pending,
                                         s=s)
        if chunk_len is not None:
            chunks = unpack_chunks(chunks, chunk_len)
        sh, sc, pending = sketch_chunks_deferred(chunks, **self._hash_kw,
                                                 s=s)
        return sketch_ops.fold_batch(state, sh, sc, [pending], s=s)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the engine's device, through pinned memory: the
        host does not wait for the card (``utils.transfer.Uploader``)."""
        return self._uploader.upload(arr)

    def _bucket(self, n: int) -> int:
        for b in _BUCKETS:
            if n <= b:
                return b
        return ((n + self.chunk_len - 1) // self.chunk_len) * self.chunk_len

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
        """Fold ready ``[rows, W]`` host batches, each uploaded as given.

        The fast-ingest counterpart of :meth:`fold_stream`: batches come
        pre-packed from :class:`mash_tpu_torch.io.ingest.IngestPipeline`
        (2-bit codes + validity mask when ``packed``) and are unpacked on
        the device.  The pipeline ships a file's last batch as its filled
        rows only, so nothing here looks for padding.  A caller that
        still pads with zero rows gets the same state, since a zero row
        holds no valid window, packed or raw; it only pays for uploading
        and folding them.  Each batch is dispatched as one upload and
        fold, so the host parses while the card works; nothing waits for
        the card but the previous batch's certificate mask, until the
        caller reads the state.  The ``engine:fold_batch`` stage times the
        dispatch, the ``engine:fold_batches`` stage the whole call.
        """
        with stage("engine:fold_batches"):
            for arr in batches:
                with stage("engine:fold_batch"):
                    state = self._fold_rows(
                        state, self._upload(arr),
                        self.chunk_len if packed else None)
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
        """Read a device state back into a host SketchRef (settling a
        ``PendingState`` first)."""
        with stage("engine:state_to_ref"):
            h, c = state
            return _host_ref(to_host(h).numpy(), to_host(c).numpy(),
                             name, comment, length)

    def estimate_set_size(self, state) -> float:
        return sketch_ops.estimate_set_size(state, self.params.use64)

    def estimate_multiplicity(self, state) -> float:
        return sketch_ops.estimate_multiplicity(state)

    # -- exact streaming mode --------------------------------------------

    def hash_bytes(self, data: bytes):
        """Hash every window of one buffer on the device.

        Returns host ``(hashes, valid)`` for its ``len(data) - k + 1``
        windows: numpy uint64 (of the int64 bit patterns; for k <= 16 the
        low 32 bits, as ``hash_chunk`` gives them) and bool.  The
        synchronous wrapper of :meth:`hash_bytes_async`.
        """
        with stage("engine:hash_bytes"):
            _, _, rh, rv = self.hash_bytes_async(data)
            return rh.numpy().view(np.uint64), rv.numpy()

    def hash_bytes_async(self, data: bytes):
        """Dispatch the hashing of one buffer; returns device ``(h, v)``
        and their started :class:`~mash_tpu_torch.utils.transfer.Readback`
        s, so that a caller hashes chunk i+1 before it reads chunk i back
        (the exact route overlaps the card's hashing with the host's
        heap inserts this way).  The buffer is not padded to a bucket:
        eager PyTorch compiles nothing per shape.
        """
        row = self._upload(np.frombuffer(data, dtype=np.uint8))
        h, v = hash_chunk(row, **self._hash_kw)
        return h, v, Readback(h), Readback(v)

    # -- windowed (minmer) mode --------------------------------------------

    def windowed_positions(self, seq: bytes):
        """Minmer (positions, hashes) of one sequence: hashes on the
        device (:func:`windowed_hash`), the window sweep in the native
        runtime.

        A sequence longer than the chunk length is hashed in chunk-sized
        pieces with k-1 overlap: the hash at position i depends only on
        bytes [i, i+k), so the pieces' hashes concatenated are the whole
        sequence's, with device memory bounded by the chunk.
        """
        from mash_tpu_torch.native import minmer_positions

        p = self.params
        k = p.kmer_size
        n = len(seq) - k + 1
        if n < 1:
            raise ValueError("sequence of %d bytes is shorter than k=%d"
                             % (len(seq), k))

        def hash_piece(piece: bytes) -> np.ndarray:
            with stage("engine:windowed_hash"):
                row = torch.frombuffer(bytearray(piece), dtype=torch.uint8)
                h = windowed_hash(row.to(self.device), k, p.seed)
                return h.cpu().numpy().view(np.uint64)

        if len(seq) <= self.chunk_len:
            h = hash_piece(seq)
        else:
            step = self.chunk_len - (k - 1)
            h = np.concatenate([hash_piece(seq[o : o + self.chunk_len])
                                for o in range(0, n, step)])[:n]
        with stage("engine:minmers"):
            return minmer_positions(h, p.window_size, p.sketch_size)


def windowed_hash(seq: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """Forward-strand raw-byte hashes of every k-mer window of ``seq``
    (int64 bit patterns ``[..., L-k+1]``), for windowed mode.

    ``getMinHashPositions`` (``Sketch.cpp:585-895``) hashes every forward
    k-mer of the raw sequence: no uppercase pass, no canonicalization, no
    invalid-k-mer skip, and always the 64-bit hash (``find`` hardcodes
    ``use64``, ``CommandFind.cpp:286``), whatever ``params.use64`` says.
    """
    h, _ = hash_chunk(seq, alphabet=(), k=k, seed=seed, use64=True,
                      noncanonical=True, preserve_case=True)
    return h


def _host_ref(h: np.ndarray, c: np.ndarray, name: str, comment: str,
              length: int) -> SketchRef:
    """A SketchRef from one host state row (int64 hashes, counts)."""
    n = int((c > 0).sum())
    return SketchRef(
        name=name,
        comment=comment,
        length=length,
        hashes=h[:n].view(np.uint64).copy(),
        counts=c[:n].astype(np.uint32),
        counts_sorted=True,
    )


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


def sketch_records_exact(
    engine: SketchEngine,
    records,
    file_name: str,
    is_stdin: bool = False,
):
    """Exact-streaming variant of :func:`sketch_records_concat`.

    Hashing runs on the device over record-packed chunks (0x00 between
    records, no overlap), but bottom-s selection streams through the
    native ``ExactHeap`` in record order, reproducing the reference
    heap's order-dependent semantics: gated multiplicities, ``-m``
    min-copy pending, ``-b`` Bloom filtering, and per-record ``-c``
    target-coverage early stop (``Sketch.cpp:1256-1262``,
    ``MinHashHeap.cpp:68-146``).  One chunk is in flight, as in
    ``mash_tpu``: chunk i+1's hashing is dispatched before chunk i is
    read back and inserted, so the card hashes while the host inserts.
    When ``-c`` stops the stream while chunk i drains, chunk i+1 is
    dropped unread.  Without ``-c`` a chunk's valid hashes enter the heap
    in one call: the windows that span a separator are invalid, so they
    are the records' hashes in record order.
    """
    from mash_tpu_torch.native import ExactHeap

    p = engine.params
    k = p.kmer_size
    heap = ExactHeap(
        p.sketch_size,
        p.min_cov if p.reads else 1,
        p.memory_bound,
        p.use64,
    )
    per_record = p.reads and p.target_cov > 0
    count = 0
    total_len = 0
    name = "" if is_stdin else file_name
    comment = ""
    skipped = False
    stop = False

    buf = bytearray()
    bounds = []  # (window_start, window_count, is_record_start) in buf
    pending = None  # (hashes, valid readbacks, bounds): the chunk in flight

    def drain():
        """Read the chunk in flight back and stream its records into the
        heap."""
        nonlocal stop, count, pending
        if pending is None:
            return
        rh, rv, pbounds = pending
        pending = None
        h = rh.numpy().view(np.uint64)
        v = rv.numpy()
        if per_record:
            for start, nwin, is_start in pbounds:
                if is_start:
                    # -c early stop is checked at record granularity, as
                    # in the reference's per-read loop (Sketch.cpp:1258-62)
                    if count > 0 and heap.multiplicity() >= p.target_cov:
                        stop = True
                        break
                    count += 1
                vv = v[start : start + nwin]
                heap.insert(h[start : start + nwin][vv])
        else:
            count += sum(1 for b in pbounds if b[2])
            heap.insert(h[v])

    def flush():
        """Dispatch ``buf``'s hashing, then drain the previous chunk
        while the card works."""
        nonlocal pending
        with stage("engine:hash_bytes"):
            _, _, rh, rv = engine.hash_bytes_async(bytes(buf))
        nxt = (rh, rv, list(bounds))
        buf.clear()
        bounds.clear()
        drain()
        pending = nxt

    for rec in records:
        if len(rec.seq) < k:
            skipped = True
            continue
        if count == 0 and pending is None and not bounds:
            if is_stdin:
                name = rec.name
                comment = rec.comment or ""
            else:
                comment = rec.name + " " + (rec.comment or "")
        if not p.reads:
            total_len += len(rec.seq)
        # records longer than the chunk split into chunk-sized pieces
        # with k-1 overlap: window order and count are preserved (the
        # overlap re-covers the boundary windows exactly once)
        seq = rec.seq
        if len(seq) <= engine.chunk_len:
            pieces = [seq]
        else:
            step = engine.chunk_len - (k - 1)
            pieces = [
                seq[o : o + engine.chunk_len]
                for o in range(0, len(seq) - k + 1, step)
            ]
        for pi, piece in enumerate(pieces):
            if buf and len(buf) + len(piece) + 1 > engine.chunk_len:
                flush()
                if stop:
                    break
            if buf:
                buf.append(0)
            start = len(buf)
            buf += piece
            bounds.append((start, len(piece) - k + 1, pi == 0))
        if stop:
            break
    if not stop:
        if buf:
            flush()
        drain()

    if p.reads:
        if p.genome_size != 0:
            total_len = p.genome_size
        else:
            total_len = int(heap.set_size())

    if count > 1:
        comment = "[%d seqs] %s [...]" % (count, comment)

    hashes, counts = heap.extract()
    ref = SketchRef(
        name=name,
        comment=comment,
        length=total_len,
        hashes=hashes,
        counts=counts,
        counts_sorted=True,
    )
    return ref, heap, count, skipped


def sketch_records_individual(
    engine: SketchEngine,
    records,
    rows: int = 16,
    wave_bytes: int = 64 << 20,
    stats: dict | None = None,
):
    """Yield one SketchRef per record (len >= k), batched on the device.

    The reference's individual mode sketches each sequence on its own
    (``sketchFileBySequence``, ``Sketch.cpp:354``); here records of the
    same pad bucket are stacked ``rows`` to a launch, each padded with
    0x00 to the bucket and the group with empty rows, so the sketch
    kernel sees one ``[rows, bucket]`` shape per bucket.  Records are
    buffered in waves of at most ``wave_bytes`` so output order is input
    order with bounded memory; records longer than the engine's chunk
    length take the chunked :meth:`SketchEngine.sketch_seqs`.  A record
    shorter than k is skipped and noted as ``stats["skipped"]``.
    """
    kw = dict(engine._hash_kw, s=engine.params.sketch_size)

    def flush(wave):
        results = {}
        by_bucket = {}
        for i, rec in wave:
            if len(rec.seq) > engine.chunk_len:
                results[i] = engine.state_to_ref(
                    engine.sketch_seqs([rec.seq]), rec.name,
                    rec.comment or "", len(rec.seq))
            else:
                b = engine._bucket(len(rec.seq))
                by_bucket.setdefault(b, []).append((i, rec))
        for b, items in by_bucket.items():
            for g0 in range(0, len(items), rows):
                grp = items[g0 : g0 + rows]
                arr = np.zeros((rows, b), dtype=np.uint8)
                for r, (_i, rec) in enumerate(grp):
                    arr[r, : len(rec.seq)] = np.frombuffer(
                        rec.seq, dtype=np.uint8)
                with stage("engine:indiv_batch"):
                    sh, sc = sketch_chunks_fused(engine._upload(arr), **kw)
                    sh = sh.cpu().numpy()
                    sc = sc.cpu().numpy()
                for r, (i, rec) in enumerate(grp):
                    results[i] = _host_ref(sh[r], sc[r], rec.name,
                                           rec.comment or "", len(rec.seq))
        for i in sorted(results):
            yield results[i]

    wave = []
    wave_sz = 0
    idx = 0
    for rec in records:
        if len(rec.seq) < engine.params.kmer_size:
            # report skips so the caller can tell "all records too
            # short" from "no records at all" (concat path parity)
            if stats is not None:
                stats["skipped"] = True
            continue
        wave.append((idx, rec))
        wave_sz += len(rec.seq)
        idx += 1
        if wave_sz >= wave_bytes:
            yield from flush(wave)
            wave = []
            wave_sz = 0
    yield from flush(wave)
