"""Screen counting kernel: DB-hash occurrence counts over a sorted batch.

The counterpart of ``mash_tpu.ops.pallas_screen``.  ``csrc/screen_count.cu``
adds, for every DB hash, its number of occurrences in a batch of streamed
hashes to an int32 count, saturating at 2^31-1.  The batch is sorted once
per flush by the caller (``ops.screen_ops.ScreenCounter``); the kernel
finds each DB tile's span of it exactly, so the TPU kernel's windows,
coverage certificate and exact fallback tier are gone.

:func:`screen_count` launches the kernel for CUDA tensors and runs its
plain version, :func:`screen_count_plain`, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from mash_tpu_torch.ops import cuda_build
from mash_tpu_torch.ops.sketch_ops import EMPTY, biased

# Kernel launches in this process (read and reset by chip_smoke.py).
LAUNCHES = {"screen_count": 0}


def _check(batch, db, counts):
    if batch.dtype != torch.int64 or db.dtype != torch.int64:
        raise ValueError("batch and db must be int64 hash bit patterns")
    if counts.dtype != torch.int32:
        raise ValueError("counts must be int32")
    if batch.dim() != 1 or db.dim() != 1 or counts.shape != db.shape:
        raise ValueError("batch [n], db [H] and counts [H] must be 1-D")
    if len({t.device for t in (batch, db, counts)}) != 1:
        raise ValueError("inputs lie on different devices")
    if not all(t.is_contiguous() for t in (batch, db, counts)):
        raise ValueError("inputs must be contiguous")
    dev = batch.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    return dev


def screen_count_plain(batch, db, counts):
    """Plain PyTorch version of :func:`screen_count` (same update)."""
    from mash_tpu_torch.ops.screen_ops import _accum

    sb = biased(batch)
    sd = biased(db)
    add = (torch.searchsorted(sb, sd, side="right")
           - torch.searchsorted(sb, sd, side="left"))
    add = torch.where(db == EMPTY, torch.zeros_like(add), add)
    counts.copy_(_accum(counts, add))
    return counts


def screen_count(batch: torch.Tensor, db: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """Add each DB hash's occurrence count in ``batch`` to ``counts``.

    Args:
      batch: int64 ``[n]`` hash bit patterns sorted ascending in unsigned
        order; masked lanes are EMPTY and so sort last.
      db: int64 ``[H]`` distinct hashes sorted ascending in unsigned order.
      counts: int32 ``[H]``, updated in place with saturation at 2^31-1.
        A DB hash equal to EMPTY is not counted (masked lanes share its
        value); the caller counts it.

    Returns ``counts``.
    """
    if _check(batch, db, counts).type == "cpu":
        return screen_count_plain(batch, db, counts)
    if batch.numel() == 0 or db.numel() == 0:
        return counts  # nothing to count: no launch
    lib = cuda_build.load("screen_count")
    fn = lib.screen_count_launch
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, p, i64, p, p]
        fn.restype = ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    dev = batch.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(ptr(batch), batch.numel(), ptr(db), db.numel(),
                    ptr(counts), ctypes.c_void_p(stream))
    cuda_build.check(status, "screen_count")
    LAUNCHES["screen_count"] += 1
    return counts
