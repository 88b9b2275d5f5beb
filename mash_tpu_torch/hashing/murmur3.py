"""Bit-exact MurmurHash3 (Austin Appleby's public-domain algorithm).

The reference tool hashes every k-mer with ``MurmurHash3_x64_128`` and keeps
the first 8 bytes of the little-endian digest for 64-bit sketches or the
first 4 bytes for 32-bit sketches (reference: ``src/mash/hash.cpp:10-38``,
``src/mash/MurmurHash3.cpp``).  Matching those hash values exactly is what
makes sketches interchangeable with the reference, so this module provides:

- :func:`mmh3_x64_128_py` — pure-Python scalar oracle over ``bytes``;
- :func:`mmh3_words_x64_128` — vectorized implementation over arrays of
  little-endian packed 64-bit words, generic over numpy / jax.numpy.  The
  byte length is static, so when traced by JAX the block/tail structure
  unrolls into straight-line XLA ops (k <= 32 bytes means at most 2 blocks
  plus a tail).

Only the x64_128 variant is implemented: the reference's 32-bit-architecture
fallback (``MurmurHash3_x86_32``, gated by ``ARCH_32``) changes hash values
and is not used by 64-bit builds, which are the compatibility target
(``mash info`` reports ``MurmurHash3_x64_128``).
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53
_H1_MIX = 0x52DCE729
_H2_MIX = 0x38495AB5


# ---------------------------------------------------------------------------
# Pure-Python scalar oracle (used by tests and tiny host-side hashing).
# ---------------------------------------------------------------------------

def _rotl_py(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix_py(k: int) -> int:
    k ^= k >> 33
    k = (k * _F1) & _MASK64
    k ^= k >> 33
    k = (k * _F2) & _MASK64
    k ^= k >> 33
    return k


def mmh3_x64_128_py(data: bytes, seed: int = 0) -> tuple[int, int]:
    """MurmurHash3_x64_128 of ``data``; returns ``(h1, h2)`` as uint64 ints.

    The reference's 64-bit k-mer hash is ``h1`` (first 8 little-endian bytes
    of the digest); its 32-bit hash is ``h1 & 0xFFFFFFFF``.
    """
    length = len(data)
    nblocks = length // 16
    h1 = seed & _MASK64
    h2 = seed & _MASK64

    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16 : b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8 : b * 16 + 16], "little")
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl_py(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1
        h1 = _rotl_py(h1, 27)
        h1 = (h1 + h2) & _MASK64
        h1 = (h1 * 5 + _H1_MIX) & _MASK64
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl_py(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
        h2 = _rotl_py(h2, 31)
        h2 = (h2 + h1) & _MASK64
        h2 = (h2 * 5 + _H2_MIX) & _MASK64

    tail = data[nblocks * 16 :]
    tlen = length & 15
    if tlen > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl_py(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
    if tlen > 0:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl_py(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1 = _fmix_py(h1)
    h2 = _fmix_py(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    return h1, h2


def hash_kmer_py(kmer: bytes, seed: int, use64: bool) -> int:
    """Hash a k-mer exactly like the reference (``src/mash/hash.cpp:10-38``)."""
    h1, _ = mmh3_x64_128_py(kmer, seed)
    return h1 if use64 else h1 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Vectorized word-based implementation (numpy or jax.numpy).
# ---------------------------------------------------------------------------

def _rotl(x, r: int, xp):
    u = xp.uint64
    return (x << u(r)) | (x >> u(64 - r))


def _fmix(k, xp):
    u = xp.uint64
    k = k ^ (k >> u(33))
    k = k * u(_F1)
    k = k ^ (k >> u(33))
    k = k * u(_F2)
    k = k ^ (k >> u(33))
    return k


def mmh3_words_x64_128(words, length: int, seed, xp=np):
    """Vectorized MurmurHash3_x64_128 over little-endian packed words.

    Args:
      words: sequence of ``ceil(length / 8)`` uint64 arrays (broadcastable
        against each other), word ``i`` holding input bytes ``8i .. 8i+7``
        little-endian, zero-padded past ``length``.
      length: static byte length (the k-mer size; any value >= 0 works).
      seed: scalar or array seed (uint32 semantics, zero-extended).
      xp: numpy or jax.numpy.

    Returns:
      ``(h1, h2)`` uint64 arrays. The reference's hash value is ``h1``
      (64-bit mode) or ``h1 & 0xFFFFFFFF`` (32-bit mode).
    """
    if xp is np:
        # numpy warns on intended uint64 wraparound; silence locally.
        with np.errstate(over="ignore"):
            return _mmh3_words_impl(words, length, seed, xp)
    return _mmh3_words_impl(words, length, seed, xp)


def _mmh3_words_impl(words, length: int, seed, xp):
    u = xp.uint64
    nblocks = length // 16
    nwords = (length + 7) // 8
    assert len(words) >= nwords, (len(words), length)

    zero = u(0)
    h1 = xp.asarray(seed, dtype=xp.uint64) + zero
    h2 = h1

    for b in range(nblocks):
        k1 = words[2 * b]
        k2 = words[2 * b + 1]
        k1 = k1 * u(_C1)
        k1 = _rotl(k1, 31, xp)
        k1 = k1 * u(_C2)
        h1 = h1 ^ k1
        h1 = _rotl(h1, 27, xp)
        h1 = h1 + h2
        h1 = h1 * u(5) + u(_H1_MIX)
        k2 = k2 * u(_C2)
        k2 = _rotl(k2, 33, xp)
        k2 = k2 * u(_C1)
        h2 = h2 ^ k2
        h2 = _rotl(h2, 31, xp)
        h2 = h2 + h1
        h2 = h2 * u(5) + u(_H2_MIX)

    tlen = length & 15
    if tlen > 8:
        k2 = words[2 * nblocks + 1]
        k2 = k2 * u(_C2)
        k2 = _rotl(k2, 33, xp)
        k2 = k2 * u(_C1)
        h2 = h2 ^ k2
    if tlen > 0:
        k1 = words[2 * nblocks]
        k1 = k1 * u(_C1)
        k1 = _rotl(k1, 31, xp)
        k1 = k1 * u(_C2)
        h1 = h1 ^ k1

    h1 = h1 ^ u(length)
    h2 = h2 ^ u(length)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1, xp)
    h2 = _fmix(h2, xp)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1, h2
