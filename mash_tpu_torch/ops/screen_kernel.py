"""Screen counting kernels: a hash table of the DB, probed by every hash.

The counterpart of ``mash_tpu.ops.pallas_screen``.  ``csrc/screen_count.cu``
holds two kernels.  :func:`build_table` puts the distinct DB hashes into an
open-addressing table once per DB (:class:`DBTable`: keys, DB indices and
one-byte fingerprints), and :func:`screen_count` adds, for every valid hash
of a batch in any order, one to the int64 total of the DB hash it equals.
So the TPU kernel's sorted batches, windows, coverage certificate and exact
fallback tier are gone; the count-overflow rule of ``mash_tpu`` is applied
to the totals by the caller (``ops.screen_ops.counts_from_totals``).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors.  The plain count (:func:`screen_count_plain`)
searches the sorted DB and reads no table, so on the CPU
:func:`build_table` leaves the table empty; :func:`build_table_plain` lays
it out for a caller that compares tables.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mash_tpu_torch.ops import cuda_build
from mash_tpu_torch.ops.kmers import i64
from mash_tpu_torch.ops.sketch_ops import EMPTY, biased

# Kernel launches in this process (read and reset by chip_smoke.py).
LAUNCHES = {"screen_table": 0, "screen_count": 0}

# the kernels' multipliers: home slots and fingerprints
MIX = 0x9E3779B97F4A7C15
FP_MIX = 0xC2B2AE3D27D4EB4F


class DBTable(NamedTuple):
    """A DB and its open-addressing table of ``2^bits`` slots.

    ``db``: int64 ``[H]`` distinct hashes, ascending in unsigned order;
    ``keys``: int64 ``[2^bits]``, EMPTY where a slot is vacant;
    ``index``: int32 ``[2^bits]``, the DB index of each slot's key (-1 where
    vacant); ``fp``: uint8 ``[2^bits]``, each slot's key's
    :func:`fingerprints` (0 where vacant).  A DB hash equal to EMPTY is not
    in the table.  :func:`build_table` leaves the three of no slots on the
    CPU.
    """

    db: torch.Tensor
    keys: torch.Tensor
    index: torch.Tensor
    fp: torch.Tensor
    bits: int


def table_bits(H: int) -> int:
    """log2 of the table's slots: the least power of two >= 2H (>= 2)."""
    return max(1, (2 * H - 1).bit_length())


def home_slots(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Each key's home slot: the top ``bits`` bits of ``key * MIX``."""
    r = 64 - bits
    return ((keys * i64(MIX)) >> r) & ((1 << bits) - 1)


def fingerprints(keys: torch.Tensor) -> torch.Tensor:
    """Each key's one-byte fingerprint: the top byte of ``key * FP_MIX``,
    1 where that is 0 (0 marks a vacant slot)."""
    f = ((keys * i64(FP_MIX)) >> 56) & 0xFF
    return torch.where(f == 0, torch.ones_like(f), f).to(torch.uint8)


def _empty_table(S: int, dev):
    return (torch.full((S,), EMPTY, dtype=torch.int64, device=dev),
            torch.full((S,), -1, dtype=torch.int32, device=dev),
            torch.zeros((S,), dtype=torch.uint8, device=dev))


def _check_db(db):
    if db.dtype != torch.int64 or db.dim() != 1 or not db.is_contiguous():
        raise ValueError("db must be a contiguous int64 [H] tensor")
    if db.numel() > 2**31 - 1:
        raise ValueError("a DB of more than 2^31 - 1 hashes")
    if db.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % db.device)
    return db.device


def build_table_plain(db: torch.Tensor) -> DBTable:
    """Plain PyTorch version of :func:`build_table`.

    Lays the keys out as linear probing does when it inserts them in the
    order of their home slots: sorted by home, key ``j`` lands at
    ``p_j = max(home_j, p_{j-1} + 1)``, a running maximum.  The keys are
    laid out twice along a line of ``2S`` slots, the second copy at homes
    ``+S``, so that the first copy's run past slot S reaches the second
    copy's start as the wrap-around does; with fewer keys than slots the
    second copy, taken mod S, is the table.  Which slots are occupied does
    not depend on the order of the inserts; which key holds which slot of a
    run does (:func:`table_contents` compares tables).
    """
    H = db.numel()
    bits = table_bits(H)
    S = 1 << bits
    keys, index, fp = _empty_table(S, db.device)
    ids = (db != EMPTY).nonzero().squeeze(1)
    n = ids.numel()
    if n:
        k = db[ids]
        home, order = torch.sort(home_slots(k, bits), stable=True)
        j = torch.arange(2 * n, device=db.device)
        line = torch.cat([home, home + S]) - j
        pos = (torch.cummax(line, 0).values + j)[n:] % S
        keys[pos] = k[order]
        index[pos] = ids[order].int()
        fp[pos] = fingerprints(k[order])
    return DBTable(db, keys, index, fp, bits)


def build_table(db: torch.Tensor) -> DBTable:
    """The open-addressing table of ``db`` (int64 ``[H]`` distinct hashes,
    ascending in unsigned order) on its device; on the CPU a table of no
    slots, which :func:`screen_count_plain` does not read."""
    dev = _check_db(db)
    H = db.numel()
    bits = table_bits(H)
    if dev.type == "cpu":
        return DBTable(db, *_empty_table(0, dev), bits)
    keys, index, fp = _empty_table(1 << bits, dev)
    if H:
        fn = cuda_build.load("screen_count").screen_table_build_launch
        if fn.argtypes is None:
            p = ctypes.c_void_p
            fn.argtypes = [p, ctypes.c_int64, ctypes.c_int, p, p, p, p]
            fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(_ptr(db), H, bits, _ptr(keys), _ptr(index), _ptr(fp),
                        ctypes.c_void_p(stream))
        cuda_build.check(status, "screen_table")
        LAUNCHES["screen_table"] += 1
    return DBTable(db, keys, index, fp, bits)


def table_contents(table: DBTable):
    """What a table holds, whatever the order of its inserts: the mask of
    its occupied slots (by key or fingerprint), and for each DB index the
    key stored under it with its own fingerprint (EMPTY if none).  For a
    right table the second equals ``table.db``."""
    has_key = table.keys != EMPTY
    occ = has_key | (table.fp != 0)
    good = has_key & (table.fp == fingerprints(table.keys))
    by_index = torch.full_like(table.db, EMPTY)
    by_index[table.index[good].long()] = table.keys[good]
    return occ, by_index


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_count(h, v, table, totals):
    if h.dtype != torch.int64 or v.dtype != torch.bool or h.shape != v.shape:
        raise ValueError("h and v must be int64 and bool tensors of one shape")
    if totals.dtype != torch.int64 or totals.shape != table.db.shape:
        raise ValueError("totals must be int64 [H]")
    ts = (h, v, table.keys, table.index, table.fp, totals)
    if len({t.device for t in ts}) != 1:
        raise ValueError("inputs lie on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")
    return h.device


def screen_count_plain(h, v, table: DBTable, totals):
    """Plain PyTorch version of :func:`screen_count` (same update): a
    search of the sorted ``table.db`` for every valid hash, then
    ``index_add_``.  It reads no slot of the table."""
    x = h.reshape(-1)[v.reshape(-1)]
    x = biased(x[x != EMPTY])
    db = biased(table.db)
    if x.numel() == 0 or db.numel() == 0:
        return totals
    pos = torch.searchsorted(db, x).clamp_(max=db.numel() - 1)
    pos = pos[db[pos] == x]
    totals.index_add_(0, pos, torch.ones_like(pos))
    return totals


def screen_count(h: torch.Tensor, v: torch.Tensor, table: DBTable,
                 totals: torch.Tensor) -> torch.Tensor:
    """Add each DB hash's occurrence count in a batch to its total.

    Args:
      h: int64 hash bit patterns, any shape, in any order.
      v: bool validity of each hash, the shape of ``h``.
      table: the DB's :class:`DBTable` (:func:`build_table`).
      totals: int64 ``[H]``, updated in place.  A DB hash equal to EMPTY
        is not counted; the caller counts it.

    Returns ``totals``.
    """
    if _check_count(h, v, table, totals).type == "cpu":
        return screen_count_plain(h, v, table, totals)
    n = h.numel()
    if n == 0 or table.db.numel() == 0:
        return totals  # nothing to count: no launch
    fn = cuda_build.load("screen_count").screen_count_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int64, p, p, p, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    dev = h.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(_ptr(h), _ptr(v), n, _ptr(table.keys), _ptr(table.index),
                    _ptr(table.fp), table.bits, _ptr(totals),
                    ctypes.c_void_p(stream))
    cuda_build.check(status, "screen_count")
    LAUNCHES["screen_count"] += 1
    return totals
