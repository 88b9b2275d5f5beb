"""Canonical k-mer hashes as Mash computes them, in plain PyTorch.

Mash (Ondov et al. 2016, ``Sketch.cpp``) hashes every k-mer whose bases
are all in ACGT, case folded: it takes the lexicographically smaller of
the k-mer and its reverse complement (``memcmp <= 0`` keeps the forward
strand), hashes those k ASCII bytes with MurmurHash3_x64_128 under the
seed (42 by default) and keeps the first 8 bytes of the digest, or the
first 4 where 4^k <= 2^32.  Windows never span two records or two reads.

Written from the published algorithms alone; it imports nothing of the
program under test.  PyTorch has no unsigned 64-bit type, so a hash is
the int64 with the same bits; ``*`` and ``+`` wrap mod 2^64 as
MurmurHash3 needs, and unsigned order is the signed order of the bits
with the top one flipped (:func:`biased`).
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
C1 = 0x87C37B91114253D5
C2 = 0x4CF5AD432745937F
F1 = 0xFF51AFD7ED558CCD
F2 = 0xC4CEB9FE1A85EC53
INT64_MIN = -(1 << 63)


def signed(c: int) -> int:
    """The int64 with the bits of the uint64 ``c``."""
    c &= MASK64
    return c - (1 << 64) if c >> 63 else c


def unsigned(c: int) -> int:
    return c & MASK64


# -- scalar MurmurHash3_x64_128 (Python ints), for hand checks ------------

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK64


def _fmix(x: int) -> int:
    x ^= x >> 33
    x = (x * F1) & MASK64
    x ^= x >> 33
    x = (x * F2) & MASK64
    return x ^ (x >> 33)


def mmh3_x64_128(data: bytes, seed: int = 0) -> tuple:
    """``(h1, h2)`` of MurmurHash3_x64_128 as uint64 Python ints."""
    n = len(data)
    h1 = h2 = seed & MASK64
    nblocks = n // 16
    for b in range(nblocks):
        k1 = int.from_bytes(data[16 * b: 16 * b + 8], "little")
        k2 = int.from_bytes(data[16 * b + 8: 16 * b + 16], "little")
        h1 ^= (_rotl((k1 * C1) & MASK64, 31) * C2) & MASK64
        h1 = (_rotl(h1, 27) + h2) & MASK64
        h1 = (h1 * 5 + 0x52DCE729) & MASK64
        h2 ^= (_rotl((k2 * C2) & MASK64, 33) * C1) & MASK64
        h2 = (_rotl(h2, 31) + h1) & MASK64
        h2 = (h2 * 5 + 0x38495AB5) & MASK64
    tail = data[16 * nblocks:]
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:], "little")
        h2 ^= (_rotl((k2 * C2) & MASK64, 33) * C1) & MASK64
    if tail:
        k1 = int.from_bytes(tail[:8], "little")
        h1 ^= (_rotl((k1 * C1) & MASK64, 31) * C2) & MASK64
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & MASK64
    h2 = (h2 + h1) & MASK64
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h1 = (h1 + h2) & MASK64
    h2 = (h2 + h1) & MASK64
    return h1, h2


# -- the same on int64 tensors ----------------------------------------------

def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _trotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _srl(x, 64 - r)


def _tfmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ _srl(x, 33)
    x = x * signed(F1)
    x = x ^ _srl(x, 33)
    x = x * signed(F2)
    return x ^ _srl(x, 33)


def mmh3_h1(words, length: int, seed: int) -> torch.Tensor:
    """``h1`` of MurmurHash3_x64_128 of ``length`` bytes, given as
    little-endian int64 words (word i holds bytes 8i..8i+7, zero past
    ``length``), one tensor a word."""
    h1 = torch.full_like(words[0], seed)
    h2 = h1
    nblocks = length // 16
    for b in range(nblocks):
        h1 = h1 ^ (_trotl(words[2 * b] * signed(C1), 31) * signed(C2))
        h1 = (_trotl(h1, 27) + h2) * 5 + 0x52DCE729
        h2 = h2 ^ (_trotl(words[2 * b + 1] * signed(C2), 33) * signed(C1))
        h2 = (_trotl(h2, 31) + h1) * 5 + 0x38495AB5
    tail = length - 16 * nblocks
    if tail > 8:
        h2 = h2 ^ (_trotl(words[2 * nblocks + 1] * signed(C2), 33)
                   * signed(C1))
    if tail:
        h1 = h1 ^ (_trotl(words[2 * nblocks] * signed(C1), 31) * signed(C2))
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _tfmix(h1) + _tfmix(h2)


def biased(x: torch.Tensor) -> torch.Tensor:
    """int64 bits whose signed order is the unsigned order of ``x``."""
    return x ^ INT64_MIN


_ACGT = b"ACGT"


def _code_table(device) -> torch.Tensor:
    t = torch.full((256,), -1, dtype=torch.int64)
    for i, b in enumerate(_ACGT):
        t[b] = i
        t[b + 32] = i  # lower case folds to upper
    return t.to(device)


def window_hashes(seq: torch.Tensor, k: int, seed: int, bits: int):
    """Hashes of every k-mer window of ``seq`` (uint8 ``[..., L]``, one
    record or read a row).

    Returns ``(h, valid)``, ``[..., L-k+1]``: the canonical k-mer's hash
    (int64 bits, cut to its low ``bits`` bits) and whether all k bases
    are in ACGT.
    """
    if not 1 <= k <= 32:
        raise ValueError("k must be 1..32")
    n = seq.shape[-1] - k + 1
    if n < 1:
        shape = seq.shape[:-1] + (0,)
        return (torch.zeros(shape, dtype=torch.int64, device=seq.device),
                torch.zeros(shape, dtype=torch.bool, device=seq.device))
    code = _code_table(seq.device)[seq.long()]
    bad = torch.cumsum((code < 0).long(), dim=-1)
    bad = torch.cat([torch.zeros_like(bad[..., :1]), bad], dim=-1)
    valid = bad[..., k:k + n] == bad[..., :n]
    code = code.clamp(min=0)
    # 2 bits a base, first base highest: the order of these integers is
    # the order of the k-mers' ASCII bytes, since A < C < G < T
    fwd = torch.zeros(seq.shape[:-1] + (n,), dtype=torch.int64,
                      device=seq.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | code[..., j:j + n]
        rev = (rev << 2) | (3 - code[..., k - 1 - j:k - 1 - j + n])
    kmer = torch.where(biased(fwd) <= biased(rev), fwd, rev)
    del fwd, rev
    ascii = torch.tensor(list(_ACGT), dtype=torch.int64, device=seq.device)
    words = []
    for m in range((k + 7) // 8):
        w = torch.zeros_like(kmer)
        for j in range(8 * m, min(8 * m + 8, k)):
            base = _srl(kmer, 2 * (k - 1 - j)) & 3 if k - 1 - j else kmer & 3
            w = w | (ascii[base] << (8 * (j - 8 * m)))
        words.append(w)
    h = mmh3_h1(words, k, seed)
    if bits < 64:
        h = h & ((1 << bits) - 1)
    return h, valid
