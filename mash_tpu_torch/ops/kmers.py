"""Batched k-mer extraction, canonicalization and hashing in PyTorch.

The counterpart of ``mash_tpu.ops.kmers``: every window position of a
chunk is processed in parallel, invalid windows (containing non-alphabet
bytes, padding, or sequence separators) are masked instead of skipped,
and the per-k-mer hash is an unrolled MurmurHash3_x64_128 over packed
64-bit words.  These functions are the plain version of the window
hash kernel (``ops.hash_kernel``) and of the sketch kernel
(``ops.sketch_kernel``); they run on whatever device their input lies
on.  :func:`hash_chunk` dispatches: a CUDA tensor to the window hash
kernel, a CPU tensor to :func:`hash_chunk_plain`.

PyTorch has no unsigned 64-bit arithmetic, so hashes are int64 bit
patterns: ``*`` and ``+`` wrap mod 2^64 exactly as MurmurHash3 needs, a
logical right shift is an arithmetic shift followed by a mask, and
unsigned order is the signed order of ``x ^ INT64_MIN``
(``sketch_ops.biased``).

Chunking contract (host side, see ``mash_tpu_torch.core.engine``):
- sequences are concatenated with a 0x00 separator byte between records;
  0x00 is never in an alphabet, so windows crossing record boundaries
  are invalid;
- consecutive chunks of one stream overlap by k-1 bytes so no window is
  lost at a chunk boundary;
- the tail chunk is padded with 0x00.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# DNA complement for bytes 'A'..'Z', exactly the reference's table
# (``src/mash/Sketch.cpp:1071-1098``).  Ambiguity codes map to their
# IUPAC complements; non-IUPAC letters map to 'N'.
_COMPLEMENT_AZ = "TVGHNNCDNNMNKNNNNYSAABWNRN"

_MASK64 = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53
_H1_MIX = 0x52DCE729
_H2_MIX = 0x38495AB5


def i64(c: int) -> int:
    """uint64 constant -> the int64 with the same bit pattern."""
    c &= _MASK64
    return c - (1 << 64) if c >= (1 << 63) else c


def complement_byte(c: int) -> int:
    """Complement of one uppercase byte (0 if not a letter)."""
    if ord("A") <= c <= ord("Z"):
        return ord(_COMPLEMENT_AZ[c - ord("A")])
    return 0


def alphabet_bytes(alphabet: tuple) -> tuple:
    """Tuple of member byte values from a 256-entry alphabet table."""
    return tuple(i for i in range(256) if alphabet[i])


def hash_kw(params) -> dict:
    """The window hash's keyword arguments for a ``SketchParams``."""
    return dict(alphabet=alphabet_bytes(params.alphabet),
                k=params.kmer_size, seed=params.seed, use64=params.use64,
                noncanonical=params.noncanonical,
                preserve_case=params.preserve_case)


def alphabet_lut(alphabet: tuple) -> np.ndarray:
    """256-entry 0/1 membership table from a tuple of member bytes."""
    lut = np.zeros(256, dtype=np.uint8)
    lut[list(alphabet)] = 1
    return lut


def complement_lut(alphabet: tuple) -> np.ndarray:
    """256-entry byte -> complement table over the alphabet's members.

    Non-members map to 0 (their windows are masked anyway), replicating
    the uppercase-then-complement order of
    ``src/mash/Sketch.cpp:524-537, 1100-1106``.
    """
    lut = np.zeros(256, dtype=np.uint8)
    for c in alphabet:
        lut[c] = complement_byte(c)
    return lut


@functools.lru_cache(maxsize=None)
def device_table(kind: str, alphabet: tuple, device: torch.device):
    """A host table as a tensor on ``device``, copied there once.

    ``kind`` is ``"alphabet"`` (:func:`alphabet_lut`, as bool),
    ``"complement"`` (:func:`complement_lut`) or ``"bases"`` (the 2-bit
    codes' bytes A, C, T, G; ``alphabet`` unused).  A copy from pageable
    memory makes the host wait for the card, so the streaming paths keep
    these tables on the device instead of uploading them every batch.
    """
    if kind == "alphabet":
        return torch.from_numpy(alphabet_lut(alphabet)).to(device).bool()
    if kind == "complement":
        return torch.from_numpy(complement_lut(alphabet)).to(device)
    if kind == "bases":
        return torch.tensor([65, 67, 84, 71], dtype=torch.uint8,
                            device=device)
    raise ValueError("unknown table %r" % kind)


def complement_lut_az() -> np.ndarray:
    """256-entry byte -> complement table over uppercase 'A'..'Z' (0 for
    every other byte), whatever the alphabet: the host-side table of
    ``translate_frames`` (``mash_tpu.ops.kmers.complement_lut()``)."""
    lut = np.zeros(256, dtype=np.uint8)
    for i, c in enumerate(_COMPLEMENT_AZ):
        lut[ord("A") + i] = ord(c)
    return lut


def unpack_chunks(packed: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """Reconstruct ``[B, chunk_len]`` byte chunks from packed ingest rows.

    The native packer (``native/mash_native.cpp`` ``Ingest::pack_row``)
    ships 2-bit ACGT codes (``chunk_len/4`` bytes, little-endian within
    each byte) followed by a per-position validity bitmask
    (``chunk_len/8`` bytes).  Valid positions reconstruct their exact
    (case-folded) base byte; invalid positions become 0x00, which is
    never in an alphabet, so downstream window masking is unchanged.
    """
    B = packed.shape[0]
    L = chunk_len
    p2 = packed[:, : L // 4]
    pm = packed[:, L // 4 :]
    dev = packed.device
    sh4 = (torch.arange(4, dtype=torch.uint8, device=dev) * 2)[None, None]
    codes = ((p2[:, :, None] >> sh4) & 3).reshape(B, L)
    sh8 = torch.arange(8, dtype=torch.uint8, device=dev)[None, None]
    valid = ((pm[:, :, None] >> sh8) & 1).reshape(B, L)
    # code -> byte: 0->A 1->C 2->T 3->G (inverse of (byte >> 1) & 3)
    table = device_table("bases", (), dev)
    byte = table[codes.long()]
    return torch.where(valid == 1, byte, torch.zeros_like(byte))


def uppercase(seq: torch.Tensor, preserve_case: bool) -> torch.Tensor:
    """Uppercase pass replicating ``Sketch.cpp:524-530``.

    The reference compares ``char`` (signed), so bytes >= 0x80 are
    negative and never shifted; we replicate by testing the int8 view.
    """
    if preserve_case:
        return seq
    signed = seq.view(torch.int8)
    lower = (signed > 96) & (signed < 123)
    return torch.where(lower, seq - 32, seq)


def window_valid(ok: torch.Tensor, k: int) -> torch.Tensor:
    """valid[i] = all(ok[i:i+k]) via log-doubling sliding AND."""
    n = ok.shape[-1] - k + 1
    acc = ok
    width = 1  # acc[i] == all(ok[i:i+width])
    while width < k:
        step = min(width, k - width)
        acc = acc[..., : acc.shape[-1] - step] & acc[..., step:]
        width += step
    return acc[..., :n]


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _shr(k, 33)
    k = k * i64(_F1)
    k = k ^ _shr(k, 33)
    k = k * i64(_F2)
    return k ^ _shr(k, 33)


def mmh3_words_h1(words, length: int, seed: int) -> torch.Tensor:
    """MurmurHash3_x64_128 ``h1`` over little-endian packed int64 words.

    ``words``: ``ceil(length/8)`` int64 tensors of one shape, word ``i``
    holding bytes ``8i .. 8i+7``, zero-padded past ``length``.  Mirrors
    ``mash_tpu_torch.hashing.murmur3.mmh3_words_x64_128`` on int64 bit
    patterns.
    """
    if seed >> 32:
        raise ValueError("seed is uint32 in the reference")
    nblocks = length // 16
    h1 = torch.full_like(words[0], seed)
    h2 = h1
    for b in range(nblocks):
        k1 = _rotl(words[2 * b] * i64(_C1), 31) * i64(_C2)
        h1 = _rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + _H1_MIX
        k2 = _rotl(words[2 * b + 1] * i64(_C2), 33) * i64(_C1)
        h2 = _rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + _H2_MIX
    tlen = length & 15
    if tlen > 8:
        k2 = _rotl(words[2 * nblocks + 1] * i64(_C2), 33) * i64(_C1)
        h2 = h2 ^ k2
    if tlen > 0:
        k1 = _rotl(words[2 * nblocks] * i64(_C1), 31) * i64(_C2)
        h1 = h1 ^ k1
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    return h1 + h2


def hash_chunk(
    seq: torch.Tensor,
    *,
    alphabet: tuple,
    k: int,
    seed: int,
    use64: bool,
    noncanonical: bool,
    preserve_case: bool,
):
    """Hash every k-mer window of ``seq``: on the card the window hash
    kernel (``ops.hash_kernel.hash_windows``), on the CPU
    :func:`hash_chunk_plain`.  Same arguments and outputs as
    :func:`hash_chunk_plain`.
    """
    kw = dict(alphabet=alphabet, k=k, seed=seed, use64=use64,
              noncanonical=noncanonical, preserve_case=preserve_case)
    if seq.device.type == "cpu":
        return hash_chunk_plain(seq, **kw)
    if seq.device.type == "cuda":
        from mash_tpu_torch.ops import hash_kernel

        return hash_kernel.hash_windows(seq, **kw)
    raise ValueError("hash_chunk runs on cuda or cpu tensors, not %s"
                     % seq.device)


def hash_chunk_plain(
    seq: torch.Tensor,
    *,
    alphabet: tuple,
    k: int,
    seed: int,
    use64: bool,
    noncanonical: bool,
    preserve_case: bool,
):
    """Hash every k-mer window of ``seq`` with plain torch ops: the twin
    of the window hash kernel.

    Args:
      seq: uint8 tensor ``[..., L]`` of sequence bytes (with separators /
        padding as 0x00).
      alphabet: tuple of member byte values (``alphabet_bytes``).
      k: k-mer size (1..32).
      seed: hash seed (uint32 semantics).
      use64: keep 64-bit hashes; otherwise low 32 bits
        (``src/mash/hash.cpp:21-35``).
      noncanonical: skip canonicalization (strand-specific).
      preserve_case: skip the uppercase pass.

    Returns:
      ``(hashes, valid)`` with shape ``[..., L-k+1]``: int64 hash bit
      patterns per window and a bool mask of windows whose bytes are all
      in the alphabet.
    """
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32, got %d" % k)
    L = seq.shape[-1]
    n = L - k + 1
    if n < 1:
        raise ValueError("chunk of %d bytes is shorter than k=%d" % (L, k))

    seq = uppercase(seq, preserve_case)
    dev = seq.device
    idx = seq.long()
    ok = device_table("alphabet", tuple(alphabet), dev)[idx]
    valid = window_valid(ok, k)

    def window_bytes_fwd(j):
        return seq[..., j : j + n]

    if noncanonical:
        window_bytes_rev = None
    else:
        comp = device_table("complement", tuple(alphabet), dev)[idx]

        def window_bytes_rev(j):
            # rc k-mer byte j = complement(seq[i + k-1-j])
            return comp[..., k - 1 - j : k - 1 - j + n]

    h1 = hash_from_byte_fns(
        window_bytes_fwd,
        window_bytes_rev,
        k=k,
        seed=seed,
        use64=use64,
        noncanonical=noncanonical,
    )
    return h1, valid


def hash_from_byte_fns(
    fwd, rev, *, k: int, seed: int, use64: bool, noncanonical: bool
):
    """Canonicalize + MurmurHash3 given per-position byte accessors.

    ``fwd(j)`` / ``rev(j)`` return the j-th byte of every window's
    forward / reverse-complement k-mer (uint8 tensors of one shape).
    """
    if noncanonical:
        choose_fwd = None
    else:
        # memcmp(fwd, rev) <= 0 ranking, folded last byte first
        # (``Sketch.cpp:569-571``).
        f0 = fwd(0)
        cmp = torch.zeros(f0.shape, dtype=torch.int8, device=f0.device)
        minus = torch.full((), -1, dtype=torch.int8, device=f0.device)
        plus = torch.full((), 1, dtype=torch.int8, device=f0.device)
        for j in reversed(range(k)):
            f = fwd(j)
            r = rev(j)
            cmp = torch.where(f < r, minus, torch.where(f > r, plus, cmp))
        choose_fwd = cmp <= 0

    words = []
    for m in range((k + 7) // 8):
        wf = None
        wr = None
        for j in range(8 * m, min(8 * m + 8, k)):
            shift = 8 * (j - 8 * m)
            bf = fwd(j).long() << shift
            wf = bf if wf is None else (wf | bf)
            if not noncanonical:
                br = rev(j).long() << shift
                wr = br if wr is None else (wr | br)
        words.append(wf if noncanonical else torch.where(choose_fwd, wf, wr))

    h1 = mmh3_words_h1(words, k, seed)
    if not use64:
        h1 = h1 & 0xFFFFFFFF
    return h1
