"""Streaming containment (``mash screen``): DB table, counting, tallies.

The counterpart of ``mash_tpu.ops.screen_ops``.  The reference builds a
hash->refs table plus an atomic hash->count map and streams every k-mer of
the mixture through them (``src/mash/CommandScreen.cpp:93-116, 484-599``).
Here the DB becomes one sorted distinct hash array (+ CSR segments to
reference indices, built on the host) and, on the device, an
open-addressing table of it (``screen_kernel.build_table``); each streamed
batch of chunks is hashed on the device (``ops.kmers.hash_chunk``), and
:class:`ScreenCounter` hands its hashes, in the order the hashing wrote
them, to the ``screen_count`` kernel, which adds every hit to an int64
total per DB hash.  The bottom-s fold behind the mixture's cardinality
estimate takes the batch's bytes through the sketch kernel and its
candidate fold (``sketch_kernel.sketch_chunks_deferred``), as the sketch
engine does, on every device.  :func:`fold_screen_rows` is the one fold
of a screen batch, for ``make_screen_fold`` and the mesh's
``sharded_screen_counts`` alike.  Counts are total occurrences, as in
the reference.

``mash_tpu`` picks its counting tier by DB size, and its counts overflow
as that tier does: on one TPU a DB of more than ``BIG_DB_MIN`` hashes goes
to the int32 big-DB counter, whose counts saturate at 2^31-1, and every
smaller DB keeps uint32 counts that wrap at 2^32, as the reference's
atomics do (``CommandScreen.h:106``); on a mesh the big-DB tier takes a DB
of more than ``BIG_DB_MIN`` hashes a device (``H // n_dev``).  The exact
totals here get the same rule at the end (:func:`counts_from_totals`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mash_tpu_torch.ops import screen_kernel, sketch_kernel, sketch_ops
from mash_tpu_torch.ops.kmers import complement_lut_az, hash_kw
from mash_tpu_torch.ops.sketch_ops import EMPTY
from mash_tpu_torch.utils import resolve_device, stage

INT32_MAX = 2**31 - 1
# mash_tpu.ops.screen_ops.BIG_DB_MIN: above this many DB hashes one TPU
# counts with the int32 big-DB tier (make_screen_fold_auto), at or below
# it with uint32 counts.
BIG_DB_MIN = 1 << 18


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


def counts_from_totals(totals: torch.Tensor, big_db: bool) -> np.ndarray:
    """Exact int64 occurrence totals -> ``mash_tpu``'s uint32 counts.

    ``big_db`` (more than ``BIG_DB_MIN`` DB hashes a device): min(total,
    2^31-1), what ``mash_tpu``'s big-DB counter holds after adding every
    batch with its saturating ``_accum`` (the adds are non-negative and
    saturation is sticky).  Otherwise total mod 2^32, what its uint32
    counts hold.
    """
    if big_db:
        c = totals.clamp(max=INT32_MAX)
    else:  # the low 32 bits, as the int32 of the same bit pattern
        c = totals & 0xFFFFFFFF
        c = torch.where(c > INT32_MAX, c - 2**32, c)
    return c.int().cpu().numpy().view(np.uint32)


def count_db_occurrences(h, v, db_hashes, totals):
    """Add each DB hash's occurrence count in (h, v) to ``totals``.

    Args:
      h: int64 hash bit patterns of one chunk; v: its bool validity mask.
      db_hashes: int64 ``[Hn]`` distinct hashes, ascending in unsigned
        order.
      totals: int64 ``[>= Hn]``; only ``totals[:Hn]`` is updated
        (``mash_tpu`` keeps a trailing drop slot).

    One exact version (a :class:`ScreenCounter` seeded with the totals)
    stands in for ``mash_tpu``'s three per-chunk TPU tiers; a DB hash
    equal to the EMPTY masking value counts only its valid occurrences.
    Returns new totals; :func:`counts_from_totals` gives the counts.
    """
    Hn = db_hashes.shape[0]
    if Hn == 0:
        return totals
    counter = ScreenCounter(db_hashes, totals[:Hn])
    counter.add(h.reshape(-1), v.reshape(-1))
    return torch.cat([counter.totals, totals[Hn:]])


class ScreenCounter:
    """DB-hash occurrence counting on one device.

    The counterpart of ``mash_tpu``'s ``BigDBCounter`` and of its per-chunk
    tiers: the DB's table is built once, and each batch of hashes is
    counted as it comes, unsorted, by ``screen_kernel.screen_count`` into
    exact int64 totals.  Chunks may differ in length.  A real DB hash
    equal to EMPTY is not in the table; its valid occurrences are added to
    its total here.

    Args:
      db: int64 ``[H]`` distinct hashes, ascending in unsigned order, on
        the device the counting runs on.
      totals: int64 ``[H]`` totals to start from (default zeros).
    """

    def __init__(self, db: torch.Tensor, totals: torch.Tensor | None = None):
        self.H = int(db.numel())
        self.table = screen_kernel.build_table(db)
        self.totals = (torch.zeros(self.H, dtype=torch.int64, device=db.device)
                       if totals is None
                       else totals.to(db.device, torch.int64, copy=True))
        self._db_has_empty = self.H > 0 and int(db[-1]) == EMPTY

    def add(self, h: torch.Tensor, v: torch.Tensor) -> None:
        """Count hashed chunks (``hash_chunk``'s ``(hashes, valid)``)."""
        if self.H == 0:
            return
        h, v = h.contiguous(), v.contiguous()
        if self._db_has_empty:
            self.totals[-1] += (v & (h == EMPTY)).sum()
        screen_kernel.screen_count(h, v, self.table, self.totals)

    def finalize(self) -> np.ndarray:
        """The counts as uint32 numpy ``[H]``, by ``mash_tpu``'s overflow
        rule for this DB size (:func:`counts_from_totals`)."""
        return counts_from_totals(self.totals, self.H > BIG_DB_MIN)


def fold_screen_rows(counter, state, rows: torch.Tensor, kw: dict, *,
                     s: int):
    """The screen-batch fold: count a ``[B, L]`` uint8 batch's DB hashes
    and fold its bytes into the cardinality ``state``.

    ``counter`` (a ``parallel.mesh.ShardedScreenCounter``) counts the
    rows on each of its devices.  The rows' bytes are folded once, on its
    first device, by ``sketch_kernel.sketch_chunks_deferred`` (K1 and
    K6's candidate fold on the card, their plain versions on the CPU),
    and merged into ``state`` by ``sketch_ops.fold_batch``, which settles
    the certificate one batch behind, so the result may be a
    ``sketch_ops.PendingState``.  ``kw`` is ``ops.kmers.hash_kw``'s.
    Nothing reads the device.
    """
    with stage("screen:fold_batch"):
        counter.add_rows(rows, kw)
        rows = rows.to(counter.devices[0], non_blocking=True)
        sh, sc, pending = sketch_kernel.sketch_chunks_deferred(rows, **kw,
                                                               s=s)
        return sketch_ops.fold_batch(state, sh, sc, [pending], s=s)


def make_screen_fold(params, db_hashes: np.ndarray, s: int, device=None):
    """Screen fold: hash, count, and cardinality state.

    The counterpart of ``mash_tpu``'s ``make_screen_fold_auto``.  Returns
    ``(fold, fold_rows, counts0, finalize)``: ``fold(counts, state,
    chunk[L])`` and ``fold_rows(counts, state, rows[B, L])`` fold uint8
    chunks by :func:`fold_screen_rows`, returning ``(counts, state)``;
    ``counts`` is a placeholder threaded through for the same contract,
    and ``finalize(counts)`` returns the DB counts as uint32 numpy
    ``[H]``.  The DB is range-sharded over the devices ``device`` spans
    (``parallel.mesh.local_mesh``), one :class:`ScreenCounter` a device
    (``parallel.mesh.ShardedScreenCounter``): one device holds the
    whole DB.  Nothing reads the device before ``finalize``; ``state``
    may be a ``sketch_ops.PendingState``, which settles when it is read.
    """
    from mash_tpu_torch.parallel.mesh import ShardedScreenCounter, local_mesh

    dev = resolve_device(device)
    counter = ShardedScreenCounter(local_mesh(dev), db_hashes)
    kw = hash_kw(params)

    def fold_rows(counts, state, rows):
        return counts, fold_screen_rows(counter, state, rows, kw, s=s)

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
