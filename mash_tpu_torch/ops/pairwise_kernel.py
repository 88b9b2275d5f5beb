"""All-pairs sorted-sketch intersection kernels on the GPU.

The counterpart of ``mash_tpu.ops.pallas_pairwise``.  ``csrc/pairwise.cu``
holds two instantiations of one kernel:

- :func:`pairwise64` over 64-bit hashes (int64 bit patterns, EMPTY
  padded), the counterpart of ``_kernel_body``;
- :func:`pairwise32` over 32-bit keys (int32 bit patterns, 0xFFFFFFFF
  padded): ``distance.rank_compress`` keys of 64-bit hashes or of the
  32-bit hashes of k <= 16 sketches, the counterpart of
  ``_kernel_body32``.

Both return int32 ``(common, denom)`` of shape ``[NQ, NR]``.  The row
contract, which every caller meets (``distance.pad_sketches``,
``distance._pad_rows_np``, ``distance.rank_compress``): the first ``n``
entries of a row (``n`` from the sizes, at most the width) are its real
values, sorted in unsigned order and distinct, and the rest are pads.
The kernels read only the first ``n`` entries, so a pad row (``n = 0``)
costs nothing; the plain version tells pads by their value instead.
For a CPU tensor each wrapper runs the plain version,
``distance.pairwise_common_denom``; for a CUDA tensor it launches its
kernel, and raises if the launch fails.

The kernel walks each pair in one of two parallel shapes (``route``):
``"thread"``, a thread a pair, for many pairs (its tile of 48 rows of
W + 1 values must fit in 225 KiB of shared memory: W <= 1199 keys or
599 hashes), or ``"warp"``, a warp a pair, for few pairs or wider rows.
``"auto"``, what the port uses, takes the thread route from 65 536 pairs
where it fits; the tests and ``chip_smoke.py`` name a route to hold and
time both.  A route that does not fit raises.
"""

from __future__ import annotations

import ctypes

import torch

from mash_tpu_torch.ops import cuda_build
from mash_tpu_torch.ops.distance import pairwise_common_denom
from mash_tpu_torch.ops.sketch_ops import EMPTY

# Kernel launches in this process (read and reset by chip_smoke.py).
LAUNCHES = {"pairwise64": 0, "pairwise32": 0}
ROUTES = {"auto": 0, "warp": 1, "thread": 2}


def keys32_to_64(keys: torch.Tensor) -> torch.Tensor:
    """int32 key bit patterns -> int64 hashes with the same unsigned
    order; the 0xFFFFFFFF sentinel becomes EMPTY."""
    wide = keys.long() & 0xFFFFFFFF
    return torch.where(keys == -1, torch.full_like(wide, EMPTY), wide)


def _check(qry, nqry, ref, nref, dtype):
    if qry.dtype != dtype or ref.dtype != dtype:
        raise ValueError("sketch rows must be %s" % dtype)
    if qry.dim() != 2 or ref.dim() != 2 or qry.shape[1] != ref.shape[1]:
        raise ValueError("sketch rows must be [N, width] of one width")
    if nqry.shape != (qry.shape[0],) or nref.shape != (ref.shape[0],):
        raise ValueError("sizes must be [NQ] and [NR]")
    if nqry.dtype != torch.int32 or nref.dtype != torch.int32:
        raise ValueError("sizes must be int32")
    devs = {t.device for t in (qry, nqry, ref, nref)}
    if len(devs) != 1:
        raise ValueError("inputs lie on different devices")
    if not all(t.is_contiguous() for t in (qry, nqry, ref, nref)):
        raise ValueError("inputs must be contiguous")
    dev = qry.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    return dev


def _launch(name, qry, nqry, ref, nref, cap, route):
    if route not in ROUTES:
        raise ValueError("route must be one of %s" % sorted(ROUTES))
    lib = cuda_build.load("pairwise")
    fn = getattr(lib, name + "_launch")
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, p, i64, p, p, i64, i64, i32, i32, p, p, p]
        fn.restype = ctypes.c_int
    NQ, W = qry.shape
    NR = ref.shape[0]
    dev = qry.device
    common = torch.empty((NQ, NR), dtype=torch.int32, device=dev)
    denom = torch.empty((NQ, NR), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(ptr(qry), ptr(nqry), NQ, ptr(ref), ptr(nref), NR, W,
                    int(cap), ROUTES[route], ptr(common), ptr(denom),
                    ctypes.c_void_p(stream))
    cuda_build.check(status, name)
    LAUNCHES[name] += 1
    return common, denom


def pairwise64(qry, nqry, ref, nref, *, cap: int, route: str = "auto"):
    """(common, denom) over int64 ``[NQ, W]`` / ``[NR, W]`` hash rows."""
    if _check(qry, nqry, ref, nref, torch.int64).type == "cpu":
        return pairwise_common_denom(qry, nqry, ref, nref, cap=cap)
    return _launch("pairwise64", qry, nqry, ref, nref, cap, route)


def pairwise32(qkeys, nqry, rkeys, nref, *, cap: int, route: str = "auto"):
    """(common, denom) over int32 ``[NQ, W]`` / ``[NR, W]`` key rows."""
    if _check(qkeys, nqry, rkeys, nref, torch.int32).type == "cpu":
        return pairwise_common_denom(
            keys32_to_64(qkeys), nqry, keys32_to_64(rkeys), nref, cap=cap
        )
    return _launch("pairwise32", qkeys, nqry, rkeys, nref, cap, route)
