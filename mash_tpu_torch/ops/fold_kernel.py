"""Bottom-s fold kernel: rows of sorted segments -> bottom-s states.

The counterpart of ``mash_tpu.ops.sketch_ops._fold_sorted``,
``merge_states`` and ``tree_merge``, and of the fold tail of
``mash_tpu.ops.pallas_sketch.sketch_chunks_pallas`` (K1's candidates and
their exactness certificate): ``jax.jit`` functions that XLA fuses into a
few device loops.  The kernel ``csrc/fold_sorted.cu`` (K6) computes in one
launch what the plain versions here compute in some twenty to fifty eager
ones: the bottom s distinct hashes of each row, with summed counts, where
a row is ``G`` segments each sorted ascending in unsigned order.

:func:`fold_sorted` and :func:`fold_candidates` launch the kernel for a
CUDA tensor and run their plain versions, :func:`fold_sorted_plain` and
:func:`fold_candidates_plain`, for a CPU tensor.  The plain versions are
the fold as ``ops.sketch_ops`` had it: sort, run detection, scatter of
the runs' counts.

State representation: ``(hashes[s], counts[s])``, both int64.  Hashes are
uint64 bit patterns sorted in *unsigned* order; empty slots have
``counts == 0`` and hash ``EMPTY`` (2^64-1, i.e. int64 -1).  A real hash
equal to EMPTY is still tracked correctly because emptiness is defined by
``counts == 0``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mash_tpu_torch.ops import cuda_build

EMPTY = -1  # 2^64-1 as an int64 bit pattern
SIGN = -(2**63)  # XOR with this maps unsigned order onto signed order

# Kernel launches in this process (read and reset by chip_smoke.py).
LAUNCHES = {"fold_sorted": 0}


def biased(x: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns -> int64 whose signed order is unsigned order."""
    return x ^ SIGN


def sort_unsigned(h: torch.Tensor, c: torch.Tensor, dim: int = -1):
    """Sort ``(h, c)`` along ``dim`` by h in unsigned order."""
    _, order = torch.sort(biased(h), dim=dim)
    return h.gather(dim, order), c.gather(dim, order)


def _fold_sorted(hs: torch.Tensor, cs: torch.Tensor, s: int):
    """Bottom-s distinct (+summed counts) of unsigned-ascending rows.

    Args:
      hs: int64 ``[..., L]`` ascending in unsigned order; entries with
        ``cs == 0`` are ignored (they must have been mapped to ``EMPTY``
        so they sort last).
      cs: int64 ``[..., L]`` counts aligned with ``hs``.
      s: sketch size.

    Returns:
      ``(H[..., s], C[..., s])`` states.
    """
    L = hs.shape[-1]
    is_new = torch.ones_like(hs, dtype=torch.bool)
    is_new[..., 1:] = hs[..., 1:] != hs[..., :-1]
    run = torch.cumsum(is_new, dim=-1) - 1  # run index of each element
    width = max(L, s)
    shape = hs.shape[:-1] + (width,)
    C = torch.zeros(shape, dtype=torch.int64, device=hs.device)
    C.scatter_add_(-1, run, cs)
    H = torch.full(shape, EMPTY, dtype=torch.int64, device=hs.device)
    # every element of a run holds the same value: any writer wins
    H.scatter_(-1, run, hs)
    H = H[..., :s]
    C = C[..., :s]
    H = torch.where(C > 0, H, torch.full_like(H, EMPTY))
    return H, C.clamp(min=0)


def empty_rows(H: torch.Tensor, C: torch.Tensor, rows: torch.Tensor):
    """``[B, s]`` states with the rows of the bool mask ``rows`` emptied
    (EMPTY / 0), on the device: they then add nothing to a merge."""
    keep = ~rows[:, None]
    return (torch.where(keep, H, torch.full_like(H, EMPTY)),
            torch.where(keep, C, torch.zeros_like(C)))


def fold_sorted_plain(h: torch.Tensor, c: torch.Tensor, s: int,
                      segments: int = 1):
    """Plain PyTorch version of :func:`fold_sorted`: the segments' entries
    sorted together (one segment is sorted already), then folded."""
    if segments > 1:
        h, c = sort_unsigned(h, c)
    return _fold_sorted(h, c, s)


def fold_candidates_plain(cand: torch.Tensor, boundary: torch.Tensor,
                          vcount: torch.Tensor, rows: int, s: int):
    """Plain PyTorch version of :func:`fold_candidates`."""
    R = cand.shape[0] // rows
    ch = cand.view(rows, R * cand.shape[1])
    cand_v = ch != EMPTY
    ch, cc = sort_unsigned(ch, cand_v.long())
    Hf, Cf = _fold_sorted(ch, cc, s)

    # Certificate: a hash not extracted from its subrow is >= that
    # subrow's boundary, so X (the s-th kept value) strictly below every
    # boundary proves every occurrence <= X was captured; equal valid
    # counts prove the all-captured case.  A file's short tail row (fewer
    # valid windows than s, more than m in a subrow) is the usual row
    # without it; the rest of its batch stays exact.
    ndist = (Cf > 0).sum(dim=1)
    minb = biased(boundary.view(rows, R)).min(dim=1).values
    covered = (ndist >= s) & (biased(Hf[:, s - 1]) < minb)
    all_in = vcount.view(rows, R).sum(dim=1) == cand_v.sum(dim=1)
    bad = ~(covered | all_in)
    Hf, Cf = empty_rows(Hf, Cf, bad)
    return Hf, Cf, bad


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entries ``(launch, scratch_bytes)``, built and bound
    once a process."""
    lib = cuda_build.load("fold_sorted")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    launch = lib.fold_sorted_launch
    launch.argtypes = [p, p, i64, i64, i64, ctypes.c_int, p, p, p, p, p, p,
                       p]
    launch.restype = ctypes.c_int
    scratch = lib.fold_sorted_scratch_bytes
    scratch.argtypes = [i64, i64, ctypes.c_int]
    scratch.restype = i64
    return launch, scratch


def _check_rows(h: torch.Tensor, c, s: int, segments: int) -> None:
    if h.dtype != torch.int64 or (c is not None and c.dtype != torch.int64):
        raise ValueError("hashes and counts must be int64")
    if h.dim() < 1 or (c is not None and c.shape != h.shape):
        raise ValueError("hashes and counts must be [..., L] of one shape")
    if not h.is_contiguous() or (c is not None and not c.is_contiguous()):
        raise ValueError("hashes and counts must be contiguous")
    if s < 1 or segments < 1 or h.shape[-1] % segments:
        raise ValueError("need s >= 1 and L = segments * W, got s=%d, L=%d, "
                         "segments=%d" % (s, h.shape[-1], segments))


def _launch(h, c, s, G, boundary=None, vcount=None):
    """K6 on ``[..., G * W]`` CUDA rows -> ``(H, C [..., s], bad [B] or
    None)``; on ``h``'s device and its current stream."""
    lead = tuple(h.shape[:-1])
    B, dev = math.prod(lead), h.device
    H = torch.empty((*lead, s), dtype=torch.int64, device=dev)
    C = torch.empty_like(H)
    bad = (None if boundary is None
           else torch.empty((B,), dtype=torch.bool, device=dev))
    if B == 0:
        return H, C, bad
    launch, scratch_bytes = _launcher()
    W = h.shape[-1] // G
    scratch = torch.empty((B * scratch_bytes(G, W, s),), dtype=torch.uint8,
                          device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        status = launch(
            h.data_ptr(), ptr(c), B, G, W, s, ptr(boundary), ptr(vcount),
            H.data_ptr(), C.data_ptr(), ptr(bad), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(status, "fold_sorted")
    LAUNCHES["fold_sorted"] += 1
    return H, C, bad


def fold_sorted(h: torch.Tensor, c: torch.Tensor, s: int, segments: int = 1):
    """Bottom-s states of rows of sorted segments.

    Args:
      h: int64 ``[..., L]`` hash bit patterns, each row ``segments``
        segments of ``L / segments`` entries, each segment ascending in
        unsigned order with its entries of count 0 ``EMPTY`` (last).
      c: int64 ``[..., L]`` counts aligned with ``h``.
      s: sketch size.
      segments: segments a row.

    Returns ``(H [..., s], C [..., s])``: each row's s smallest distinct
    hashes with their summed counts, ``EMPTY`` / 0 past them and where a
    sum is 0; equal to :func:`fold_sorted_plain`.  A CUDA tensor launches
    K6, a CPU tensor runs :func:`fold_sorted_plain`.
    """
    _check_rows(h, c, s, segments)
    if h.device.type == "cpu":
        return fold_sorted_plain(h, c, s, segments)
    if h.device.type != "cuda" or c.device != h.device:
        raise ValueError("fold_sorted runs on cuda or cpu tensors of one "
                         "device")
    return _launch(h, c, s, segments)[:2]


def fold_candidates(cand: torch.Tensor, boundary: torch.Tensor,
                    vcount: torch.Tensor, rows: int, s: int):
    """K1's candidates -> ``(H [rows, s], C [rows, s], bad [rows])``.

    ``cand`` int64 ``[rows * R, m]`` holds each subrow's m smallest window
    hashes in unsigned order (``EMPTY`` for none), ``boundary`` int64
    ``[rows * R]`` its (m+1)-th, ``vcount`` int32 ``[rows * R]`` its
    valid windows (``sketch_kernel.sketch_select``).  Each row's states
    fold its R subrows' candidates (a count of 1 each); ``bad`` marks the
    rows without the exactness certificate, which come out EMPTY / 0.  A
    CUDA tensor launches K6 with the certificate, a CPU tensor runs
    :func:`fold_candidates_plain`.
    """
    if cand.dtype != torch.int64 or cand.dim() != 2:
        raise ValueError("cand must be an int64 [rows * R, m] tensor")
    if rows < 1 or s < 1 or cand.shape[0] % rows or not cand.shape[0]:
        raise ValueError("cand has %d subrows, not a multiple of %d rows"
                         % (cand.shape[0], rows))
    if (boundary.dtype != torch.int64 or vcount.dtype != torch.int32
            or boundary.shape != (cand.shape[0],)
            or vcount.shape != (cand.shape[0],)):
        raise ValueError("boundary (int64) and vcount (int32) must be "
                         "[rows * R]")
    if not (cand.is_contiguous() and boundary.is_contiguous()
            and vcount.is_contiguous()):
        raise ValueError("cand, boundary and vcount must be contiguous")
    if cand.device.type == "cpu":
        return fold_candidates_plain(cand, boundary, vcount, rows, s)
    if (cand.device.type != "cuda" or boundary.device != cand.device
            or vcount.device != cand.device):
        raise ValueError("fold_candidates runs on cuda or cpu tensors of "
                         "one device")
    R = cand.shape[0] // rows
    return _launch(cand.view(rows, R * cand.shape[1]), None, s, R,
                   boundary, vcount)
