"""Batched sorted-sketch intersection.

The counterpart of ``mash_tpu.ops.distance``.  The reference compares
two sketches with a sequential merge walk capped at ``sketchSize`` union
elements (``src/mash/CommandDistance.cpp:336-425``).  The equivalent
order-free formulation used here: with A, B the two sorted distinct hash
lists and U their sorted union,

  denom  = min(sketchSize, |U|)
  common = |{x in A ∩ B : rank_U(x) <= denom}|

because the walk consumes exactly one union element per step, counts a
match only when both cursors advance, and stops after ``sketchSize``
steps or when either list is exhausted.

Sketch rows are int64 bit patterns padded to a common width with the
EMPTY sentinel (2^64-1).  :func:`pairwise_common_denom` is the plain
version (a sort of each pair's concatenated rows, as in ``mash_tpu``);
on CUDA tensors :func:`pairwise_common_denom_auto` runs the hand-written
kernels of ``ops.pairwise_kernel``.  Containment (``within``) uses the
asymmetric walk of ``src/mash/CommandContain.cpp:231-263``
(:func:`pairwise_containment`, plain torch on either device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mash_tpu_torch.ops.sketch_ops import EMPTY, biased
from mash_tpu_torch.utils import stage

_EMPTY_B = 2**63 - 1  # biased(EMPTY)
_EMPTY_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def pad_sketches(hash_lists, width: int) -> tuple:
    """Stack variable-length sorted hash arrays into [N, width] + sizes."""
    n = len(hash_lists)
    out = np.full((n, width), _EMPTY_U64, dtype=np.uint64)
    sizes = np.zeros((n,), dtype=np.int32)
    for i, h in enumerate(hash_lists):
        m = min(len(h), width)
        out[i, :m] = h[:m]
        sizes[i] = m
    return out, sizes


def pairwise_common_denom(qry, nqry, ref, nref, *, cap: int,
                          max_elems: int = 1 << 24):
    """All-pairs (common, denom) between two sketch matrices.

    Every pair's two sorted rows are concatenated and sorted; matches are
    equal neighbours (EMPTY excluded) and the union-size cap is applied
    through each match's union rank (``rank = position + 1 -
    matches_before``), as in ``mash_tpu.ops.distance``.  Pairs are taken
    in chunks of at most ``max_elems`` merged elements to bound memory.

    Args:
      qry: int64 ``[NQ, s]`` sorted ascending (unsigned), EMPTY-padded.
      nqry: int ``[NQ]`` real sizes.
      ref: int64 ``[NR, s]``.
      nref: int ``[NR]``.
      cap: the reference's ``sketchSize`` denominator cap
        (min of the two sketch targets, ``CommandDistance.cpp:313-315``).

    Returns:
      (common, denom) int32 tensors of shape ``[NQ, NR]``.
    """
    nq, s = qry.shape
    nr = ref.shape[0]
    dev = qry.device
    common = torch.zeros((nq, nr), dtype=torch.int32, device=dev)
    denom = torch.zeros((nq, nr), dtype=torch.int32, device=dev)
    if nq == 0 or nr == 0:
        return common, denom
    qb = biased(qry)
    rb = biased(ref)
    na = nqry.long()
    nb = nref.long()
    t = torch.arange(1, 2 * s, device=dev)  # position + 1 of x[:, :-1]
    chunk = max(1, max_elems // (2 * s))
    for p0 in range(0, nq * nr, chunk):
        p = torch.arange(p0, min(nq * nr, p0 + chunk), device=dev)
        qi = p // nr
        ri = p % nr
        x = torch.sort(torch.cat([qb[qi], rb[ri]], dim=1), dim=1).values
        eq = (x[:, 1:] == x[:, :-1]) & (x[:, 1:] != _EMPTY_B)
        e = eq.long()
        total = e.sum(dim=1)
        d = torch.clamp(na[qi] + nb[ri] - total, max=cap)
        rank = t - (torch.cumsum(e, dim=1) - e)
        c = (eq & (rank <= d[:, None])).sum(dim=1)
        common.view(-1)[p] = c.int()
        denom.view(-1)[p] = d.int()
    return common, denom


def pairwise_containment(ref, nref, qry, nqry, *, max_elems: int = 1 << 24):
    """Asymmetric containment walk (``containSketches``,
    ``src/mash/CommandContain.cpp:231-263``), as in ``mash_tpu``.

    Query element ``q`` at position ``pos`` of its row is *consumed* when
    it is real, ``pos < min(nq, nr)`` (the walk's budget of query steps)
    and its left insertion index in the reference row is below ``nr``
    (the reference cursor has not run out); it is *common* when it is
    consumed and present in the reference row.  Both rows are searched in
    unsigned order through their biased bit patterns, so a 32-bit hash
    0xFFFFFFFF is a value like any other and only the EMPTY pad sorts
    last.  Queries are taken in chunks: each searches every reference row
    at once (``torch.searchsorted`` with the reference rows as a batched
    sorted sequence), at most ``max_elems`` query elements a chunk.  Plain
    torch on either device.

    Args:
      ref: int64 ``[NR, s]`` sorted ascending (unsigned), EMPTY-padded.
      nref: int ``[NR]`` real sizes.
      qry: int64 ``[NQ, s]``.
      nqry: int ``[NQ]``.

    Returns:
      (common, consumed) int32 tensors of shape ``[NQ, NR]``: score =
      common / consumed, error bound = 1 / sqrt(consumed).
    """
    nq, s = qry.shape
    nr = ref.shape[0]
    dev = qry.device
    common = torch.zeros((nq, nr), dtype=torch.int32, device=dev)
    consumed = torch.zeros((nq, nr), dtype=torch.int32, device=dev)
    if nq == 0 or nr == 0 or s == 0:
        return common, consumed
    rb = biased(ref).contiguous()
    qb = biased(qry)
    n_r = nref.long().to(dev)
    n_q = nqry.long().to(dev)
    pos = torch.arange(s, device=dev)
    chunk = max(1, max_elems // (nr * s))
    for q0 in range(0, nq, chunk):
        q1 = min(nq, q0 + chunk)
        vals = qb[q0:q1].reshape(1, -1).expand(nr, -1).contiguous()
        left = torch.searchsorted(rb, vals, side="left").view(nr, q1 - q0, s)
        right = torch.searchsorted(rb, vals, side="right").view(
            nr, q1 - q0, s)
        # [nr, c, s]: the budget min(nq, nr) bounds pos < nq as well
        budget = torch.minimum(n_q[None, q0:q1], n_r[:, None])
        taken = (pos[None, None, :] < budget[:, :, None]) & (
            left < n_r[:, None, None])
        common[q0:q1] = (taken & (right > left)).sum(dim=2).T.int()
        consumed[q0:q1] = taken.sum(dim=2).T.int()
    return common, consumed


# Rank-compress 64-bit inputs above this many pairs (the reference's
# threshold, ``mash_tpu/ops/distance.py``): two sorts of (NQ+NR)*s
# elements buy the one-plane kernel for every pair.
RANK_COMPRESS_MIN_PAIRS = 65536


def pairwise_common_denom_auto(qry, nqry, ref, nref, *, cap: int,
                               use64: bool = True):
    """Device-dispatched all-pairs (common, denom).

    On CUDA: 64-bit hashes with fewer than ``RANK_COMPRESS_MIN_PAIRS``
    pairs take the 64-bit kernel; everything else is mapped to uint32
    rank keys (:func:`rank_compress`, exact by construction) for the
    32-bit kernel.  That includes 32-bit hashes (k <= 16), whose real
    value 0xFFFFFFFF would otherwise read as the 32-bit pad key.
    On the CPU: the plain :func:`pairwise_common_denom`.
    """
    if qry.device.type != "cuda":
        return pairwise_common_denom(qry, nqry, ref, nref, cap=cap)
    from mash_tpu_torch.ops.pairwise_kernel import pairwise32, pairwise64

    if use64 and qry.shape[0] * ref.shape[0] < RANK_COMPRESS_MIN_PAIRS:
        return pairwise64(qry, nqry, ref, nref, cap=cap)
    kq, kr = rank_compress(qry, ref)
    return pairwise32(kq, nqry, kr, nref, cap=cap)


def rank_compress(Hq: torch.Tensor, Hr: torch.Tensor):
    """Map two int64 sketch matrices to order/equality-preserving
    uint32 rank keys (as int32 bit patterns).

    Dense ranking in unsigned order — sort all values once, number the
    distinct values in order, scatter the ranks back — gives keys with
    identical comparison results, so every pair runs the 32-bit kernel.
    Only EMPTY maps to 0xFFFFFFFF (int32 -1), the pad key: the kernel
    reads a row's first ``n`` keys only, and on the CPU
    ``pairwise_kernel.keys32_to_64`` turns -1 back into EMPTY.  Any other
    value, 32-bit hashes' 0xFFFFFFFF included, gets a rank below 2^31.
    """
    flat = torch.cat([Hq.reshape(-1), Hr.reshape(-1)])
    if flat.numel() >= 2**31:
        raise ValueError("too many hashes to rank in 32 bits")
    sv, si = torch.sort(biased(flat))
    is_new = torch.ones_like(sv, dtype=torch.bool)
    is_new[1:] = sv[1:] != sv[:-1]
    ranks = torch.empty_like(flat)
    ranks[si] = torch.cumsum(is_new, dim=0) - 1
    keys = torch.where(flat == EMPTY, torch.full_like(ranks, -1), ranks)
    keys = keys.to(torch.int32)
    n = Hq.numel()
    return keys[:n].view(Hq.shape), keys[n:].view(Hr.shape)


def _pad_rows_np(arr, mult, fill):
    """Pad ``arr`` along axis 0 to a multiple of ``mult`` with ``fill``."""
    n = arr.shape[0]
    m = ((n + mult - 1) // mult) * mult
    if m == n:
        return arr
    pad = np.full((m - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _upload(hashes: np.ndarray, sizes: np.ndarray, device):
    """Host uint64 rows + sizes -> int64 / int32 tensors on ``device``."""
    h = torch.from_numpy(np.ascontiguousarray(hashes).view(np.int64))
    n = torch.from_numpy(np.ascontiguousarray(sizes, dtype=np.int32))
    return h.to(device), n.to(device)


def stream_pair_stripes(
    qry_h,
    qry_n,
    ref_h,
    ref_n,
    cap: int,
    device,
    row_block: int | None = None,
    tile_r: int | None = None,
    triangle: bool = False,
    stripe_filter=None,
    depth: int | None = None,
):
    """Yield ``(i0, stripe)`` row stripes of packed ``common | denom<<16``.

    ``stripe`` is uint32 ``[rows, cols]`` for query rows ``[i0,
    i0+rows)``, so the full ``[NQ, NR]`` matrices never exist on the host
    at once (the reference's streamed pair blocks,
    ``src/mash/CommandDistance.cpp:196-236``).  ``cols`` is ``NR``, or
    with ``triangle=True`` (the reference set is the query set) ``i0 +
    rows - 1``: the columns the lower triangle needs, whose last tile is
    cut short.  A triangle uploads one copy of the sketches, padded to
    the lcm of ``row_block`` and ``tile_r`` so it serves both sides.  On
    CUDA, the hashes of either width are rank-compressed once so every
    tile runs the 32-bit kernel; on the CPU every tile runs the plain
    :func:`pairwise_common_denom`, for either width.  When every query
    sketch is full (and, off the triangle, every reference sketch), every
    real cell's denominator is ``cap``, so only ``common`` leaves the
    device, as uint16.  Requires ``cap < 65536``.

    Up to ``depth`` stripes are in flight, as in ``mash_tpu``: a stripe's
    tiles are launched and their copies to pinned host memory started
    (``utils.transfer.Readback``) before the oldest stripe in flight is
    read, so the card computes later stripes while the host formats
    earlier ones.  ``depth`` defaults to 3 on CUDA and 1 (each stripe
    read before the next is launched) on the CPU.  The pinned memory in
    flight is ``depth x row_block x cols x 4`` bytes at most: 25 MiB at
    4096 sketches, 0.6 GiB at 10^5.

    With ``stripe_filter(i0, row_block)`` only the stripes it accepts are
    computed and yielded (``parallel.multihost.owns_stripe``: each process
    its own).  ``row_block`` is rounded up to a multiple of every
    process's device count, so that stripe boundaries agree in every
    process.
    """
    from collections import deque

    from mash_tpu_torch.parallel import multihost as mh
    from mash_tpu_torch.utils.transfer import Readback

    if cap >= 65536:
        raise ValueError("packed stripes need cap < 65536")
    device = torch.device(device)
    big = device.type == "cuda"
    depth = depth or (3 if big else 1)
    row_block = row_block or (512 if big else 32)
    dev_mult = math.lcm(*(int(c) for c in mh.local_device_counts(device)))
    row_block = dev_mult * -(-row_block // dev_mult)
    tile_r = tile_r or ((2048 if triangle else 4096) if big else 128)
    nq = qry_h.shape[0]
    nr = ref_h.shape[0]
    if triangle:
        mult = math.lcm(row_block, tile_r)
        Hq, Nq = _upload(_pad_rows_np(qry_h, mult, _EMPTY_U64),
                         _pad_rows_np(qry_n, mult, 0), device)
        if big:
            Hq, _ = rank_compress(Hq, Hq[:0])
        Hr, Nr = Hq, Nq
    else:
        Hq, Nq = _upload(_pad_rows_np(qry_h, row_block, _EMPTY_U64),
                         _pad_rows_np(qry_n, row_block, 0), device)
        Hr, Nr = _upload(_pad_rows_np(ref_h, tile_r, _EMPTY_U64),
                         _pad_rows_np(ref_n, tile_r, 0), device)
        if big:
            Hq, Hr = rank_compress(Hq, Hr)
    if big:
        from mash_tpu_torch.ops.pairwise_kernel import pairwise32 as pairs
    else:
        pairs = pairwise_common_denom
    common_only = bool(np.all(np.asarray(qry_n) >= cap)) and (
        triangle or bool(np.all(np.asarray(ref_n) >= cap))
    )

    def tile(i0, ri):
        c, d = pairs(Hq[i0 : i0 + row_block], Nq[i0 : i0 + row_block],
                     Hr[ri : ri + tile_r], Nr[ri : ri + tile_r], cap=cap)
        if common_only:
            return c.to(torch.int16)
        packed = c.long() | (d.long() << 16)
        return packed.to(torch.int32)

    def dispatch(i0):
        """Launch a stripe's tiles and start their copies to the host."""
        rows = min(row_block, nq - i0)
        cols = (i0 + rows - 1) if triangle else nr
        with stage("distance:stripe_dispatch"):
            tiles = [Readback(tile(i0, ri)) for ri in range(0, cols, tile_r)]
        return i0, rows, cols, tiles

    def materialize(item):
        """Wait for a stripe's copies and cut it to its real cells."""
        i0, rows, cols, tiles = item
        if cols <= 0:
            return i0, np.zeros((rows, 0), dtype=np.uint32)
        with stage("distance:stripe"):
            stripe = np.concatenate([t.numpy() for t in tiles], axis=1)
        if common_only:
            stripe = stripe[:rows, :cols].view(np.uint16).astype(np.uint32)
            return i0, stripe | (np.uint32(cap) << 16)
        return i0, stripe[:rows, :cols].view(np.uint32)

    in_flight: deque = deque()
    for i0 in range(0, nq, row_block):
        if stripe_filter is not None and not stripe_filter(i0, row_block):
            continue
        in_flight.append(dispatch(i0))
        if len(in_flight) >= depth:
            yield materialize(in_flight.popleft())
    while in_flight:
        yield materialize(in_flight.popleft())


def common_denom_tiled(
    qry_h,
    qry_n,
    ref_h,
    ref_n,
    cap: int,
    device,
    tile_q: int | None = None,
    tile_r: int | None = None,
    use64: bool = True,
):
    """Host-tiled all-pairs (common, denom) bounding device memory.

    Pads both sketch sets to tile multiples and loops over tiles; tile
    sizes default to 4096 on CUDA (the kernels grid over a whole tile)
    and 128 on the CPU.  When ``device`` spans several devices
    (``parallel.mesh.local_mesh``), ``tile_q`` is padded to a multiple of
    their count and each tile's query rows are split over them
    (``parallel.mesh.sharded_pairwise``).  Returns numpy int32 ``[NQ,
    NR]`` arrays.
    """
    from mash_tpu_torch.parallel.mesh import local_mesh, sharded_pairwise

    nq = qry_h.shape[0]
    nr = ref_h.shape[0]
    common = np.zeros((nq, nr), dtype=np.int32)
    denom = np.zeros((nq, nr), dtype=np.int32)
    if nq == 0 or nr == 0:
        return common, denom
    device = torch.device(device)
    big = device.type == "cuda"
    tile_q = tile_q or (4096 if big else 128)
    tile_r = tile_r or (4096 if big else 128)
    # never pad a small input all the way up to a huge tile
    tile_q = min(tile_q, 8 * ((nq + 7) // 8))
    tile_r = min(tile_r, 8 * ((nr + 7) // 8))
    devices = local_mesh(device)
    n_dev = len(devices)
    if n_dev > 1:
        tile_q = n_dev * -(-tile_q // n_dev)

    qh = _pad_rows_np(qry_h, tile_q, _EMPTY_U64)
    qn = _pad_rows_np(qry_n, tile_q, 0)
    rh = _pad_rows_np(ref_h, tile_r, _EMPTY_U64)
    rn = _pad_rows_np(ref_n, tile_r, 0)
    for qi in range(0, qh.shape[0], tile_q):
        q, n_q = _upload(qh[qi : qi + tile_q], qn[qi : qi + tile_q], device)
        for ri in range(0, rh.shape[0], tile_r):
            with stage("distance:pair_tile"):
                r, n_r = _upload(rh[ri : ri + tile_r],
                                 rn[ri : ri + tile_r], device)
                if n_dev > 1:
                    c, d = sharded_pairwise(devices, q, n_q, r, n_r, cap,
                                            use64=use64)
                else:
                    c, d = pairwise_common_denom_auto(
                        q, n_q, r, n_r, cap=cap, use64=use64
                    )
                cq = min(tile_q, nq - qi)
                cr = min(tile_r, nr - ri)
                if cq > 0 and cr > 0:
                    common[qi : qi + cq, ri : ri + cr] = (
                        c[:cq, :cr].cpu().numpy()
                    )
                    denom[qi : qi + cq, ri : ri + cr] = (
                        d[:cq, :cr].cpu().numpy()
                    )
    return common, denom
