"""Sharding of the three core workloads over one process's devices.

The counterpart of ``mash_tpu.parallel.mesh``.  A "mesh" here is a list
of ``torch.device``s; each device runs the single-device kernels on its
share, the host launches them in turn (CUDA launches return at once, so
the devices overlap), and the small results meet on ``devices[0]``:

- **Sketching** (data parallel over chunk rows): every device hashes and
  bottom-s-reduces its rows (K1 and the certificate-checked fold, its
  mask read only after every device has its work); the per-device states
  (s * 16 bytes) are merged with the associative fold.
- **Pairwise distance** (over query rows): the references are copied to
  every device, each device computes its row block
  (``pairwise_common_denom_auto``: K2, or rank keys and K3), and the row
  blocks are concatenated.
- **Screen** (over DB hash ranges): the sorted DB is cut into contiguous
  ranges, one K4 table per device; every chunk goes to every device, and
  each counts the hits in its own range (a hash falls in exactly one
  range, so the per-range counts concatenate exactly).  The batch's
  cardinality state is folded once, on ``devices[0]``, by the screen
  fold's own ``ops.screen_ops.fold_screen_rows``.

The device list is an explicit argument wherever ``mash_tpu`` takes a
``Mesh``, so the same device may appear more than once.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.ops.kmers import hash_kw
from mash_tpu_torch.utils.transfer import to_host


def default_mesh(n_devices: Optional[int] = None,
                 device=None) -> List[torch.device]:
    """The process's local devices: every visible GPU when it runs on
    CUDA (``CUDA_VISIBLE_DEVICES`` narrows them, one rank a GPU), else
    ``[cpu]``."""
    from mash_tpu_torch.parallel.multihost import local_device_count
    from mash_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    n = local_device_count(dev)
    devices = ([torch.device("cuda", i) for i in range(n)]
               if dev.type == "cuda" else [dev])
    return devices[:n_devices] if n_devices is not None else devices


def local_mesh(device: torch.device) -> List[torch.device]:
    """The devices a command on ``device`` shards over: every visible GPU
    for ``cuda`` without an index, else ``device`` alone (an index pins
    one card)."""
    if device.type == "cuda" and device.index is None:
        return default_mesh(device=device)
    return [device]


def _row_shards(n_rows: int, devices) -> int:
    n = len(devices)
    if n_rows % n:
        raise ValueError("%d rows do not divide over %d devices"
                         % (n_rows, n))
    return n_rows // n


def sharded_sketch_chunks_deferred(devices, params, chunks: torch.Tensor,
                                   s: int, chunk_len: Optional[int] = None):
    """Sketch a ``[B, L]`` uint8 chunk batch across ``devices`` without
    reading any device.

    ``B`` must divide by the device count.  With ``chunk_len`` set, rows
    are packed 2-bit + mask ingest rows, reconstructed on each device.
    Each device runs the deferred certificate
    (``ops.sketch_kernel.sketch_chunks_deferred``), and the states move to
    ``devices[0]`` without waiting, so every device has its work queued
    before the host waits on any (as one SPMD program runs in
    ``mash_tpu``).  Returns ``((H [s], C [s]), pending)``: the merged
    state on ``devices[0]`` without the rows that lack the certificate,
    and their :class:`~mash_tpu_torch.ops.sketch_ops.Uncertified`, one a
    device that has any (``sketch_ops.merge_uncertified`` settles them).
    """
    from mash_tpu_torch.ops.kmers import unpack_chunks
    from mash_tpu_torch.ops.sketch_kernel import sketch_chunks_deferred

    per = _row_shards(chunks.shape[0], devices)
    kw = hash_kw(params)
    states, pending = [], []
    for i, dev in enumerate(devices):
        rows = chunks[i * per : (i + 1) * per].to(dev, non_blocking=True)
        if chunk_len is not None:
            rows = unpack_chunks(rows, chunk_len)
        sh, sc, p = sketch_chunks_deferred(rows, **kw, s=s)
        states.append(sketch_ops.tree_merge(sh, sc, s=s))
        if p is not None:
            pending.append(p)
    d0 = devices[0]
    merged = sketch_ops.tree_merge(
        torch.stack([h.to(d0, non_blocking=True) for h, _ in states]),
        torch.stack([c.to(d0, non_blocking=True) for _, c in states]),
        s=s,
    )
    return merged, pending


def sharded_sketch_chunks(devices, params, chunks: torch.Tensor, s: int,
                          chunk_len: Optional[int] = None):
    """:func:`sharded_sketch_chunks_deferred`, settled: the exact merged
    ``(H [s], C [s])`` state on ``devices[0]``."""
    state, pending = sharded_sketch_chunks_deferred(
        devices, params, chunks, s, chunk_len=chunk_len)
    return sketch_ops.merge_uncertified(state, pending)


def sharded_pairwise(devices, qry_h, qry_n, ref_h, ref_n, cap: int,
                     use64: bool = True):
    """All-pairs ``(common, denom)``; query rows split over ``devices``,
    references copied to each.

    Query rows must be padded to a multiple of the device count (pad
    with empty sketches: size 0).  Returns int32 ``[NQ, NR]`` tensors on
    ``devices[0]``.
    """
    from mash_tpu_torch.ops.distance import pairwise_common_denom_auto

    per = _row_shards(qry_h.shape[0], devices)
    blocks = []
    for i, dev in enumerate(devices):
        rows = slice(i * per, (i + 1) * per)
        blocks.append(pairwise_common_denom_auto(
            qry_h[rows].to(dev), qry_n[rows].to(dev), ref_h.to(dev),
            ref_n.to(dev), cap=cap, use64=use64))
    d0 = devices[0]
    return (torch.cat([c.to(d0) for c, _ in blocks]),
            torch.cat([d.to(d0) for _, d in blocks]))


class ShardedScreenCounter:
    """DB-hash occurrence counting over contiguous DB ranges, one
    :class:`~mash_tpu_torch.ops.screen_ops.ScreenCounter` (K4 table) a
    device.

    ``mash_tpu`` counts a range-sharded DB with its big-DB tier, whose
    counts saturate at 2^31-1, only when each device's range holds more
    than ``BIG_DB_MIN`` hashes (``H // n_dev``); otherwise its uint32
    counts wrap at 2^32.  :meth:`finalize` follows the same rule.

    Args:
      devices: the devices, one range each (the last range may be
        shorter, and empty when there are more devices than hashes).
      db: uint64 ``[H]`` distinct hashes, ascending.
    """

    def __init__(self, devices, db: np.ndarray):
        from mash_tpu_torch.ops.screen_ops import BIG_DB_MIN, ScreenCounter

        db = np.ascontiguousarray(db, dtype=np.uint64).view(np.int64)
        self.devices = list(devices)
        self.H = len(db)
        n = len(self.devices)
        self.big_db = self.H // n > BIG_DB_MIN
        per = -(-self.H // n)
        self.counters = [
            ScreenCounter(torch.from_numpy(db[i * per : (i + 1) * per])
                          .to(dev))
            for i, dev in enumerate(self.devices)
        ]

    def add_rows(self, rows: torch.Tensor, kw: dict) -> None:
        """Count the hashes of ``[B, L]`` uint8 chunk rows on every
        device; ``kw`` is ``ops.kmers.hash_kw``'s."""
        from mash_tpu_torch.ops.kmers import hash_chunk

        for dev, counter in zip(self.devices, self.counters):
            counter.add(*hash_chunk(rows.to(dev), **kw))

    def finalize(self) -> np.ndarray:
        """The counts as uint32 numpy ``[H]``."""
        from mash_tpu_torch.ops.screen_ops import counts_from_totals

        totals = torch.cat([to_host(c.totals) for c in self.counters])
        return counts_from_totals(totals, self.big_db)


def sharded_screen_counts(devices, params, db_hashes, chunks, s: int):
    """Count DB-hash occurrences over streamed chunks across ``devices``.

    ``db_hashes``: uint64 ``[H]`` distinct hashes, ascending; ``chunks``:
    uint8 ``[L]`` chunks or ``[B, L]`` batches of rows.  Each batch goes
    through the screen fold's ``ops.screen_ops.fold_screen_rows``: counted
    on every device, and the cardinality state folded once, on
    ``devices[0]`` (every device holds the same chunk, so folding each
    device's copy would count every hash ``n_dev`` times).  Returns
    ``(counts [H] uint32 numpy, (H [s], C [s]))``.
    """
    from mash_tpu_torch.ops.screen_ops import fold_screen_rows

    counter = ShardedScreenCounter(devices, db_hashes)
    kw = hash_kw(params)
    state = sketch_ops.empty_state(s, devices[0])
    for chunk in chunks:
        rows = chunk if chunk.dim() == 2 else chunk[None]
        state = fold_screen_rows(counter, state, rows, kw, s=s)
    return counter.finalize(), tuple(state)
