"""Sketch kernel: sequence bytes -> bottom-s states, fused on the GPU.

The counterpart of ``mash_tpu.ops.pallas_sketch``.  The kernel
``csrc/sketch_select.cu`` hashes every window of a chunk batch and, for
each C-window subrow, returns its m smallest hashes, the (m+1)-th as a
boundary, and its valid-window count, so the full hash array never
reaches device memory.  :func:`sketch_chunks_deferred` folds those
candidates to bottom-s and checks an exactness certificate on the full
64-bit boundary for each row, on the device, in one launch of the fold
kernel (``ops.fold_kernel.fold_candidates``, K6); a row that fails it is
recomputed from all its window hashes (``ops.kmers.hash_chunk``: the
window hash kernel on the card) and a full sort, on the same device,
once its mask has reached the host (at once in
:func:`sketch_chunks_fused`, a batch later on the streaming paths).

This is the one route from bytes to states, on every device: only the
kernel wrappers (:func:`sketch_select`, ``fold_candidates``,
``hash_chunk``) look at the device, and on a CPU tensor each runs its
plain version (:func:`sketch_select_plain`, ...), so the CPU tests run
the card's control flow, deferred certificate and recompute included.
The plain versions hash with ``hash_chunk_plain`` on any device, so that
holding the kernel to them on the card does not lean on the window hash
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from mash_tpu_torch.ops import cuda_build
from mash_tpu_torch.ops.fold_kernel import fold_candidates
from mash_tpu_torch.ops.kmers import (
    alphabet_lut,
    complement_lut,
    hash_chunk,
    hash_chunk_plain,
)
from mash_tpu_torch.ops.sketch_ops import (
    EMPTY,
    Uncertified,
    biased,
    candidate_budget,
    sketch_chunk,
)

C = 2048  # windows per subrow: one CUDA block
_MAX_K = 32  # the kernel's KMAX (its shared-memory halo)

# Kernel launches in this process (read and reset by chip_smoke.py).
LAUNCHES = {"sketch_select": 0}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _bind(lib):
    fn = lib.sketch_select_launch
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [p, i64, i64, p, p, i32, ctypes.c_uint32, i32, i32,
                       i32, i32, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_chunks(chunks: torch.Tensor, k: int, m: int) -> None:
    if chunks.dtype != torch.uint8 or chunks.dim() != 2:
        raise ValueError("chunks must be a uint8 [B, L] tensor")
    if not chunks.is_contiguous():
        raise ValueError("chunks must be contiguous")
    if chunks.shape[1] < k:
        raise ValueError("chunks are shorter than k")
    if not 1 <= m < C:
        raise ValueError("candidate budget m=%d outside [1, %d)" % (m, C))


def sketch_select(
    chunks: torch.Tensor,
    *,
    alphabet: tuple,
    k: int,
    seed: int,
    use64: bool,
    noncanonical: bool,
    preserve_case: bool,
    m: int,
):
    """Per-subrow bottom-m candidates of a ``[B, L]`` chunk batch.

    Returns ``(cand [B*R, m] int64, boundary [B*R] int64, vcount [B*R]
    int32)`` with ``R = ceil((L-k+1) / C)``: each subrow's m smallest
    window hashes in unsigned order (invalid windows count as EMPTY),
    its (m+1)-th smallest, and its number of valid windows.
    """
    _check_chunks(chunks, k, m)
    kw = dict(alphabet=alphabet, k=k, seed=seed, use64=use64,
              noncanonical=noncanonical, preserve_case=preserve_case, m=m)
    if chunks.device.type == "cpu":
        return sketch_select_plain(chunks, **kw)
    if chunks.device.type != "cuda":
        raise ValueError("sketch_select runs on cuda or cpu tensors")
    B, L = chunks.shape
    R = (L - k + 1 + C - 1) // C
    dev = chunks.device
    cand = torch.empty((B * R, m), dtype=torch.int64, device=dev)
    boundary = torch.empty((B * R,), dtype=torch.int64, device=dev)
    vcount = torch.empty((B * R,), dtype=torch.int32, device=dev)
    alut = alphabet_lut(alphabet)
    clut = complement_lut(alphabet)
    fn = _bind(cuda_build.load("sketch_select"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            _ptr(chunks), B, L,
            alut.ctypes.data_as(ctypes.c_void_p),
            clut.ctypes.data_as(ctypes.c_void_p),
            k, seed, int(use64), int(noncanonical), int(preserve_case), m,
            _ptr(cand), _ptr(boundary), _ptr(vcount),
            ctypes.c_void_p(stream),
        )
    cuda_build.check(status, "sketch_select")
    LAUNCHES["sketch_select"] += 1
    return cand, boundary, vcount


def sketch_select_plain(
    chunks: torch.Tensor,
    *,
    alphabet: tuple,
    k: int,
    seed: int,
    use64: bool,
    noncanonical: bool,
    preserve_case: bool,
    m: int,
):
    """Plain PyTorch version of :func:`sketch_select` (same outputs)."""
    B, L = chunks.shape
    n = L - k + 1
    R = (n + C - 1) // C
    h, v = hash_chunk_plain(chunks, alphabet=alphabet, k=k, seed=seed,
                            use64=use64, noncanonical=noncanonical,
                            preserve_case=preserve_case)
    key = torch.where(v, h, torch.full_like(h, EMPTY))
    pad = R * C - n
    if pad:
        key = torch.cat([key, torch.full((B, pad), EMPTY, dtype=key.dtype,
                                         device=key.device)], dim=1)
        v = torch.cat([v, torch.zeros((B, pad), dtype=torch.bool,
                                      device=v.device)], dim=1)
    # biased() is its own inverse: sort in unsigned order, then unbias
    key = biased(torch.sort(biased(key.view(B * R, C)), dim=1).values)
    vcount = v.view(B * R, C).sum(dim=1, dtype=torch.int32)
    return key[:, :m].contiguous(), key[:, m].contiguous(), vcount


def sketch_chunks_plain(chunks, *, alphabet, k, seed, use64, noncanonical,
                        preserve_case, s):
    """``hash_chunk_plain`` + ``sketch_chunk`` (a full sort a row): the
    plain reference that tests and ``chip_smoke.py`` hold the route
    against.  No program path calls it."""
    h, v = hash_chunk_plain(chunks, alphabet=alphabet, k=k, seed=seed,
                            use64=use64, noncanonical=noncanonical,
                            preserve_case=preserve_case)
    return sketch_chunk(h, v, s=s)


def sketch_chunks_deferred(
    chunks: torch.Tensor,
    *,
    alphabet: tuple,
    k: int,
    seed: int,
    use64: bool,
    noncanonical: bool,
    preserve_case: bool,
    s: int,
):
    """Bytes -> bottom-s states via :func:`sketch_select`, with the
    certificate settled later: the counterpart of ``mash_tpu``'s
    ``lax.cond`` on the device (``mash_tpu/ops/pallas_sketch.py:553``).

    Returns ``(H [B, s], C [B, s], pending)`` without reading the
    device.  Rows without the certificate are EMPTY / 0 in ``H, C``;
    ``pending`` (a :class:`~mash_tpu_torch.ops.sketch_ops.Uncertified`)
    recomputes them with a full sort once their mask has reached the
    host, and is None when the full sort ran for the whole batch.
    Merged in at any later point, those rows give the exact state (see
    ``sketch_ops``: the merge is associative and commutative).
    """
    B, L = chunks.shape
    n = L - k + 1

    def full_sort(rows):
        h, v = hash_chunk(rows, alphabet=alphabet, k=k, seed=seed,
                          use64=use64, noncanonical=noncanonical,
                          preserve_case=preserve_case)
        return sketch_chunk(h, v, s=s)

    if n <= 8 * C or s * 8 > n or k > _MAX_K:
        return (*full_sort(chunks), None)
    m = candidate_budget(s, C, n)
    if m >= C:  # the kernel keeps at most C - 1 candidates per subrow
        return (*full_sort(chunks), None)

    cand, boundary, vcount = sketch_select(
        chunks, alphabet=alphabet, k=k, seed=seed, use64=use64,
        noncanonical=noncanonical, preserve_case=preserve_case, m=m,
    )
    # the fold and its certificate: one K6 launch on the card
    # (fold_kernel.fold_candidates)
    Hf, Cf, bad = fold_candidates(cand, boundary, vcount, B, s)
    return Hf, Cf, Uncertified(chunks, bad, full_sort)


def sketch_chunks_fused(chunks: torch.Tensor, **kw):
    """Bytes -> exact bottom-s states ``(H [B, s], C [B, s])`` via
    :func:`sketch_select`.

    Semantically identical to ``hash_chunk`` + ``sketch_chunk``: the
    candidates are folded, then a per-row certificate proves them
    complete, else that row is recomputed with a full sort.  Reads the
    certificate's mask back before it returns
    (:func:`sketch_chunks_deferred` does not).
    """
    Hf, Cf, pending = sketch_chunks_deferred(chunks, **kw)
    got = pending.states() if pending is not None else None
    if got is not None:
        sel, h, c = got
        Hf[sel], Cf[sel] = h, c
    return Hf, Cf
