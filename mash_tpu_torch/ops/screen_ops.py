"""Streaming containment (``mash screen``): DB table, counting, tallies.

The counterpart of ``mash_tpu.ops.screen_ops``.  The reference builds a
hash->refs table plus an atomic hash->count map and streams every k-mer of
the mixture through them (``src/mash/CommandScreen.cpp:93-116, 484-599``).
Here the DB becomes one sorted distinct hash array (+ CSR segments to
reference indices, built on the host); each streamed batch of chunks is
hashed on the device (plain torch ``ops.kmers.hash_chunk``), its hashes
are queued in a :class:`ScreenCounter`, and every flush sorts the queue
once and counts it against the DB with the ``screen_count`` kernel.  The
same hashes feed the bottom-s fold behind the mixture's cardinality
estimate.  Counts are total occurrences, as in the reference.

``mash_tpu`` picks one of three per-chunk counting tiers by DB size, and
its windowed Pallas kernel above 2^18 hashes, because random access is
slow on a TPU.  On the GPU every DB size takes the one kernel, so counts
saturate at 2^31-1 on every DB size, where ``mash_tpu``'s small-DB tiers
keep the reference's uint32 wrap at 2^32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mash_tpu_torch.convert import counts_to_numpy
from mash_tpu_torch.ops import screen_kernel, sketch_ops
from mash_tpu_torch.ops.kmers import alphabet_bytes, complement_lut_az, hash_chunk
from mash_tpu_torch.ops.sketch_ops import EMPTY, SIGN, biased
from mash_tpu_torch.utils import resolve_device, stage

INT32_MAX = 2**31 - 1
_KEY_EMPTY = EMPTY ^ SIGN  # biased(EMPTY): the largest int64


def build_db_table(hash_lists: List[np.ndarray]):
    """Sorted distinct DB hashes + CSR (hash -> reference indices).

    Equivalent of the reference's ``hashTable``/``hashCounts`` build
    (``CommandScreen.cpp:99-114``), as arrays:

    Returns (db_hashes[H], seg_starts[H+1], ref_ids[sum(sizes)]).
    """
    if not hash_lists:
        return (
            np.empty(0, np.uint64),
            np.zeros(1, np.int64),
            np.empty(0, np.int32),
        )
    all_h = np.concatenate([np.asarray(h, np.uint64) for h in hash_lists])
    ids = np.concatenate(
        [
            np.full(len(h), i, dtype=np.int32)
            for i, h in enumerate(hash_lists)
        ]
    )
    order = np.argsort(all_h, kind="stable")
    sh = all_h[order]
    sids = ids[order]
    uniq, starts = np.unique(sh, return_index=True)
    seg_starts = np.concatenate([starts, [len(sh)]]).astype(np.int64)
    return uniq, seg_starts, sids


def _accum(counts: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """Accumulate non-negative occurrence counts into int32 ``counts``.

    The sum SATURATES at INT32_MAX instead of wrapping negative, as
    ``mash_tpu``'s signed (big-DB) accumulators do: the finalize cast to
    uint32 would turn a wrapped negative into garbage.  The reference's
    uint32 atomics wrap at 2^32 (``CommandScreen.h:106``); saturating at
    2^31-1 is the strictly-less-wrong behavior.
    """
    return (counts.long() + add.long()).clamp(max=INT32_MAX).int()


def count_db_occurrences(h, v, db_hashes, counts):
    """Add each DB hash's occurrence count in (h, v) to ``counts``.

    Args:
      h: int64 hash bit patterns of one chunk; v: its bool validity mask.
      db_hashes: int64 ``[Hn]`` distinct hashes, ascending in unsigned
        order.
      counts: int32 ``[>= Hn]``; only ``counts[:Hn]`` is updated
        (``mash_tpu`` keeps a trailing drop slot), through :func:`_accum`.

    One exact version (the chunk sorted once, then ``screen_count``)
    stands in for ``mash_tpu``'s three TPU tiers; a DB hash equal to the
    EMPTY masking value counts only its valid occurrences.  Returns new
    counts.
    """
    Hn = db_hashes.shape[0]
    if Hn == 0:
        return counts
    h = h.reshape(-1)
    v = v.reshape(-1)
    keys = torch.where(v, biased(h), torch.full_like(h, _KEY_EMPTY))
    out = counts.clone()
    screen_kernel.screen_count(biased(torch.sort(keys).values), db_hashes,
                               out[:Hn])
    if int(db_hashes[-1]) == EMPTY:
        out[Hn - 1] = _accum(out[Hn - 1], (v & (h == EMPTY)).sum())
    return out


# Flush sizing (queued hashes; see ScreenCounter).
FLUSH_MIN = 1 << 22
FLUSH_MAX = 1 << 27


def flush_size(H: int, device) -> int:
    """Queued hashes that trigger a flush of a :class:`ScreenCounter`.

    A flush of n hashes costs one sort of n int64 keys and one
    ``screen_count`` pass that reads the sorted batch (8n bytes), the DB
    (8H) and its counts (4H read, 4H written).  The DB's share is the
    per-flush term that does not shrink with n, so n >= 4H keeps it at
    most half of the batch's bytes.  FLUSH_MIN keeps small DBs from
    flushing every chunk.  The sort holds about five int64 copies of the
    queue at once (queue, keys, sorted values, int64 indices, scratch:
    40 bytes a hash), so n is capped at the device's free bytes / 64
    (5/8 of them for the copies) and at FLUSH_MAX (2^27 hashes, 1 GiB of
    keys).
    """
    cap = FLUSH_MAX
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        cap = min(cap, max(FLUSH_MIN, free // 64))
    return int(min(cap, max(FLUSH_MIN, 4 * H)))


class ScreenCounter:
    """Batched DB-hash occurrence counting on one device.

    The counterpart of ``mash_tpu``'s ``BigDBCounter``: the hashes of each
    chunk are queued (invalid lanes as EMPTY, which sorts last), and a
    flush sorts the queue once in unsigned order and adds its counts with
    ``screen_kernel.screen_count``.  Chunks may differ in length.  Counts
    are int32 on the device and saturate at 2^31-1.  A real DB hash equal
    to EMPTY would also match masked lanes; its valid occurrences are
    counted apart and written at :meth:`finalize`.

    Args:
      db: int64 ``[H]`` distinct hashes, ascending in unsigned order, on
        the device the counting runs on.
      flush_hashes: queued hashes that trigger a flush (default
        :func:`flush_size`).
    """

    def __init__(self, db: torch.Tensor, flush_hashes: int | None = None):
        self.db = db
        self.H = int(db.numel())
        self.counts = torch.zeros(self.H, dtype=torch.int32, device=db.device)
        self.flush_hashes = flush_hashes or flush_size(self.H, db.device)
        self.pending: List[torch.Tensor] = []
        self._pending_n = 0
        self._db_has_empty = self.H > 0 and int(db[-1]) == EMPTY
        self._sent_valid = torch.zeros((), dtype=torch.int64,
                                       device=db.device)

    def add(self, h: torch.Tensor, v: torch.Tensor) -> None:
        """Queue hashed chunks (``hash_chunk``'s ``(hashes, valid)``)."""
        if self.H == 0:
            return
        if self._db_has_empty:
            self._sent_valid += (v & (h == EMPTY)).sum()
        # queue biased keys: their signed order is the hashes' unsigned one
        keys = torch.where(v, biased(h), torch.full_like(h, _KEY_EMPTY))
        self.pending.append(keys.reshape(-1))
        self._pending_n += keys.numel()
        if self._pending_n >= self.flush_hashes:
            self.flush()

    def flush(self) -> None:
        if not self.pending:
            return
        with stage("screen:flush"):
            keys = (torch.cat(self.pending) if len(self.pending) > 1
                    else self.pending[0])
            self.pending = []
            self._pending_n = 0
            batch = biased(torch.sort(keys).values)
            del keys
            screen_kernel.screen_count(batch, self.db, self.counts)

    def finalize(self) -> np.ndarray:
        """Flush and return the counts as uint32 numpy ``[H]``."""
        self.flush()
        out = counts_to_numpy(self.counts)
        if self._db_has_empty:
            out[-1] = np.uint32(min(int(self._sent_valid), INT32_MAX))
        return out


def make_screen_fold(params, db_hashes: np.ndarray, s: int, device=None):
    """Screen fold on one device: hash, count, and cardinality state.

    The counterpart of ``mash_tpu``'s ``make_screen_fold_bigdb``.  Returns
    ``(fold, fold_rows, counts0, finalize)``: ``fold(counts, state,
    chunk[L])`` and ``fold_rows(counts, state, rows[B, L])`` hash uint8
    chunks on the device, queue their hashes in a :class:`ScreenCounter`
    and fold them into the bottom-s ``state``, returning ``(counts,
    state)``; ``counts`` is a placeholder threaded through for the same
    contract, and ``finalize(counts)`` returns the DB counts as uint32
    numpy ``[H]``.
    """
    dev = resolve_device(device)
    db = np.ascontiguousarray(db_hashes, dtype=np.uint64).view(np.int64)
    counter = ScreenCounter(torch.from_numpy(db).to(dev))
    alpha = alphabet_bytes(params.alphabet)

    def fold_rows(counts, state, rows):
        with stage("screen:fold_batch"):
            h, v = hash_chunk(
                rows,
                alphabet=alpha,
                k=params.kmer_size,
                seed=params.seed,
                use64=params.use64,
                noncanonical=params.noncanonical,
                preserve_case=params.preserve_case,
            )
            sh, sc = sketch_ops.sketch_chunk_batch(h, v, s=s,
                                                   use64=params.use64)
            state = sketch_ops.tree_merge(
                torch.cat([state[0][None], sh]),
                torch.cat([state[1][None], sc]),
                s=s,
            )
            counter.add(h, v)
        return counts, state

    def fold(counts, state, chunk):
        return fold_rows(counts, state, chunk[None])

    counts0 = torch.zeros(0, dtype=torch.int32, device=dev)

    def finalize(_counts):
        return counter.finalize()

    return fold, fold_rows, counts0, finalize


def tally_shared(
    counts: np.ndarray,
    seg_starts: np.ndarray,
    ref_ids: np.ndarray,
    n_refs: int,
    min_cov: int = 1,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Per-reference shared-hash counts and depth lists.

    Vectorized version of the tally loop (``CommandScreen.cpp:338-355``):
    for every DB hash with count >= min_cov, each reference containing it
    gains one shared hash and records the hash's depth.
    """
    hit = counts >= min_cov
    # expand hash-level hit/count to CSR entries
    seg_len = np.diff(seg_starts)
    entry_hit = np.repeat(hit, seg_len)
    entry_count = np.repeat(counts, seg_len)
    sel = entry_hit
    refs_hit = ref_ids[sel]
    depths_flat = entry_count[sel]
    shared = np.bincount(refs_hit, minlength=n_refs).astype(np.int64)
    depths: List[np.ndarray] = [
        np.empty(0, dtype=np.int64) for _ in range(n_refs)
    ]
    if len(refs_hit):
        order = np.argsort(refs_hit, kind="stable")
        refs_sorted = refs_hit[order]
        depths_sorted = depths_flat[order]
        starts = np.searchsorted(refs_sorted, np.arange(n_refs + 1))
        for r in range(n_refs):
            depths[r] = depths_sorted[starts[r] : starts[r + 1]]
    return shared, depths


def winner_takes_all(
    counts: np.ndarray,
    seg_starts: np.ndarray,
    ref_ids: np.ndarray,
    scores: np.ndarray,
    lengths: np.ndarray,
    min_cov: int = 1,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Reassign each shared hash to its best-scoring reference.

    Replicates ``CommandScreen.cpp:357-407``: ties broken by larger
    reference length; the first CSR entry wins remaining ties, matching
    the reference's strict ``>`` comparisons over its (insertion-ordered)
    set iteration.  Note the reference iterates a ``robin_hood`` set whose
    order for equal (score, length) pairs is unspecified; such full ties
    are output-identical anyway because the winner's identity only matters
    when scores or lengths differ.
    """
    n_refs = len(scores)
    hit = counts >= min_cov
    seg_len = np.diff(seg_starts)
    entry_hit = np.repeat(hit, seg_len)
    entry_score = scores[ref_ids]
    entry_length = lengths[ref_ids]
    # rank = (score, length); select argmax per segment
    hash_idx = np.repeat(np.arange(len(counts)), seg_len)
    # order by (hash, score desc, length desc) then pick first per hash
    order = np.lexsort(
        (-entry_length, -entry_score, hash_idx)
    )
    oh = hash_idx[order]
    first = np.unique(oh, return_index=True)[1]
    win_entries = order[first]
    sel = entry_hit[win_entries]
    winners = ref_ids[win_entries][sel]
    win_counts = np.repeat(counts, seg_len)[win_entries][sel]
    shared = np.bincount(winners, minlength=n_refs).astype(np.int64)
    depths: List[np.ndarray] = [
        np.empty(0, dtype=np.int64) for _ in range(n_refs)
    ]
    if len(winners):
        order2 = np.argsort(winners, kind="stable")
        ws = winners[order2]
        ds = win_counts[order2]
        starts = np.searchsorted(ws, np.arange(n_refs + 1))
        for r in range(n_refs):
            depths[r] = ds[starts[r] : starts[r + 1]]
    return shared, depths


# ---------------------------------------------------------------------------
# 6-frame translation (protein-DB screens), host-side vectorized.
# ---------------------------------------------------------------------------


def _codon_lut() -> np.ndarray:
    """64-entry codon->amino-acid LUT (standard genetic code, matching the
    reference's ``aaFromCodon`` switch, ``CommandScreen.cpp:625-809``)."""
    aa = (
        "KNKNTTTTRSRSIIMI"  # A??
        "QHQHPPPPRRRRLLLL"  # C??
        "EDEDAAAAGGGGVVVV"  # G??
        "*Y*YSSSS*CWCLFLF"  # T??
    )
    return np.frombuffer(aa.encode(), dtype=np.uint8).copy()


_CODON_LUT = _codon_lut()

_BASE_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_CODE[_b] = _i


def translate_frames(chunk: np.ndarray) -> List[np.ndarray]:
    """All six translation frames of an uppercased uint8 chunk.

    Order matches the reference (``hashSequence``): frames 0,1,2 forward
    then 0,1,2 of the reverse complement of the whole chunk.  Invalid
    codons (containing non-ACGT bytes, including separators) become ``*``.
    """
    rev = complement_lut_az()[chunk[::-1]]
    out = []
    for src in (chunk, rev):
        codes = _BASE_CODE[src]
        for frame in range(3):
            n = (len(src) - frame) // 3
            if n <= 0:
                out.append(np.empty(0, dtype=np.uint8))
                continue
            c0 = codes[frame : frame + 3 * n : 3]
            c1 = codes[frame + 1 : frame + 1 + 3 * n : 3]
            c2 = codes[frame + 2 : frame + 2 + 3 * n : 3]
            valid = (c0 >= 0) & (c1 >= 0) & (c2 >= 0)
            idx = (
                c0.astype(np.int32) * 16
                + c1.astype(np.int32) * 4
                + c2.astype(np.int32)
            )
            aa = np.where(valid, _CODON_LUT[np.clip(idx, 0, 63)], ord("*"))
            out.append(aa.astype(np.uint8))
    return out
