"""Pure-Python fallback for the exact streaming bottom-s selector.

Same stream-order semantics as the native ``ExactHeap`` (and the
reference's ``MinHashHeap::tryInsert``); used when no C++ toolchain is
available and as an independent oracle in tests.
"""

from __future__ import annotations

import heapq

import numpy as np


class PyBloom:
    """Pure-python Partow-compatible single-hash Bloom probe.

    Mirrors ``native/mash_native.cpp`` ``Bloom`` (see its comment for
    the degenerate-parameter analysis of the reference's fpp=0 setup):
    one hash_ap probe over a ``max_bytes*8``-bit table.
    """

    M32 = 0xFFFFFFFF

    def __init__(self, max_bytes: int, use64: bool):
        self.table_size = max(1, max_bytes * 8)
        self.bits = bytearray((self.table_size + 7) // 8)
        seed = (0xA5A5A5A55A5A5A5A * 0xA5A5A5A5 + 1) & (2**64 - 1)
        self.salt = (0xAAAAAAAA * 0xAAAAAAAA + seed) & self.M32
        self.use64 = use64

    def _hash(self, key: int) -> int:
        M = self.M32
        h = self.salt
        if self.use64:
            i1 = key & M
            i2 = (key >> 32) & M
            h ^= (
                ((h << 7) & M)
                ^ ((i1 * (h >> 3)) & M)
                ^ (~(((h << 11) & M) + (i2 ^ (h >> 5))) & M)
            )
        else:
            h ^= ~(((h << 11) & M) + ((key & M) ^ (h >> 5))) & M
        return h & M

    def probe(self, key: int, insert: bool) -> bool:
        bit_index = self._hash(key) % self.table_size
        byte, mask = bit_index // 8, 1 << (bit_index % 8)
        if self.bits[byte] & mask:
            return True
        if insert:
            self.bits[byte] |= mask
        return False


class PyExactHeap:
    def __init__(self, cap: int, min_cov: int = 1, bloom_bytes: int = 0,
                 use64: bool = True):
        self.cap = cap
        self.min_cov = min_cov
        self.counts = {}
        self.heap = []  # max-heap via negation
        self.pending = {}
        self.pending_heap = []
        self.multiplicity_sum = 0
        self.bloom = (
            PyBloom(bloom_bytes, use64) if bloom_bytes else None
        )

    @property
    def size(self) -> int:
        return len(self.counts)

    @property
    def top(self) -> int:
        if not self.heap:
            return (1 << 64) - 1
        return -self.heap[0]

    def _try_insert(self, h: int) -> None:
        if not (len(self.counts) < self.cap or h < -self.heap[0]):
            return
        if h not in self.counts:
            if self.bloom is not None:
                if self.bloom.probe(h, insert=False):
                    self.counts[h] = 2
                    heapq.heappush(self.heap, -h)
                    self.multiplicity_sum += 2
                else:
                    self.bloom.probe(h, insert=True)
                    return
            elif self.min_cov == 1:
                self.counts[h] = 1
                heapq.heappush(self.heap, -h)
                self.multiplicity_sum += 1
            else:
                seen = self.pending.get(h, 0)
                if seen == self.min_cov - 1:
                    self.counts[h] = self.min_cov
                    heapq.heappush(self.heap, -h)
                    self.multiplicity_sum += self.min_cov
                    del self.pending[h]
                else:
                    if h not in self.pending:
                        heapq.heappush(self.pending_heap, -h)
                        self.pending[h] = 1
                    else:
                        self.pending[h] += 1
                    return
        else:
            self.counts[h] += 1
            self.multiplicity_sum += 1

        if len(self.counts) > self.cap:
            top = -self.heap[0]
            self.multiplicity_sum -= self.counts.pop(top)
            while self.pending_heap and top < -self.pending_heap[0]:
                self.pending.pop(-self.pending_heap[0], None)
                heapq.heappop(self.pending_heap)
            heapq.heappop(self.heap)

    def insert(self, hashes) -> None:
        for h in np.asarray(hashes, dtype=np.uint64).tolist():
            self._try_insert(h)

    def multiplicity(self) -> float:
        if not self.counts:
            return 0.0
        return self.multiplicity_sum / len(self.counts)

    def set_size(self, use64: bool = True) -> float:
        if not self.counts:
            return 0.0
        space = 2.0 ** (64 if use64 else 32)
        return space * len(self.counts) / float(self.top)

    def extract(self):
        items = sorted(self.counts.items())
        h = np.array([k for k, _ in items], dtype=np.uint64)
        c = np.array([v for _, v in items], dtype=np.uint32)
        return h, c


def py_minmers(hashes: np.ndarray, window: int, mins: int):
    """Windowed minmer oracle: brute-force per-window bottom-h marking.

    A position p (hash v) is a minmer iff some full window W contains p,
    p is the leftmost occurrence of v in W, and v's rank among W's
    distinct hashes is <= mins.  O(n * window); used as the independent
    test oracle for the native sweep and as a fallback.
    """
    hs = hashes.tolist()
    n = len(hs)
    if n == 0:
        return (
            np.empty(0, dtype=np.uint32),
            np.empty(0, dtype=np.uint64),
        )
    window = min(window, n)
    marked = set()
    for w in range(0, n - window + 1):
        vals = hs[w : w + window]
        distinct = sorted(set(vals))
        thr = distinct[min(mins, len(distinct)) - 1]
        first = {}
        for off, v in enumerate(vals):
            if v <= thr and v not in first:
                first[v] = w + off
        marked.update(first.values())
    pos = sorted(marked)
    return (
        np.array(pos, dtype=np.uint32),
        np.array([hs[p] for p in pos], dtype=np.uint64),
    )
