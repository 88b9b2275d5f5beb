"""ctypes bindings for the native runtime (exact heap + FASTX parser).

The shared library is built lazily from ``native/mash_native.cpp`` with
g++ the first time it's needed and cached next to the package.  When no
compiler is available, callers fall back to the pure-Python equivalents
(``mash_tpu_torch.native.pyheap``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(__file__)))


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(_repo_root(), "native", "mash_native.cpp")
        if not os.path.exists(src):
            # installed layout: source shipped inside the package
            src = os.path.join(os.path.dirname(__file__), "mash_native.cpp")
        if not os.path.exists(src):
            return None
        so = os.path.join(_build_dir(), "libmash_native.so")
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(
            src
        ):
            try:
                subprocess.run(
                    [
                        "g++",
                        "-O3",
                        "-std=c++17",
                        "-shared",
                        "-fPIC",
                        "-o",
                        so,
                        src,
                    ],
                    check=True,
                    capture_output=True,
                )
            except (OSError, subprocess.CalledProcessError) as e:
                sys.stderr.write(
                    "WARNING: could not build native library (%s); using "
                    "Python fallbacks.\n" % e
                )
                return None
        lib = ctypes.CDLL(so)
        u64 = ctypes.c_uint64
        i64 = ctypes.c_int64
        u32 = ctypes.c_uint32
        p = ctypes.c_void_p
        lib.mash_heap_create.restype = p
        lib.mash_heap_create.argtypes = [u64, u32, u64, ctypes.c_int]
        lib.mash_bloom_create.restype = p
        lib.mash_bloom_create.argtypes = [u64, ctypes.c_int]
        lib.mash_bloom_destroy.argtypes = [p]
        lib.mash_bloom_contains.restype = ctypes.c_int
        lib.mash_bloom_contains.argtypes = [p, u64]
        lib.mash_bloom_insert.argtypes = [p, u64]
        lib.mash_heap_destroy.argtypes = [p]
        lib.mash_heap_insert.argtypes = [p, ctypes.c_void_p, i64]
        lib.mash_heap_size.restype = i64
        lib.mash_heap_size.argtypes = [p]
        lib.mash_heap_top.restype = u64
        lib.mash_heap_top.argtypes = [p]
        lib.mash_heap_full.restype = ctypes.c_int
        lib.mash_heap_full.argtypes = [p]
        lib.mash_heap_multiplicity.restype = ctypes.c_double
        lib.mash_heap_multiplicity.argtypes = [p]
        lib.mash_heap_set_size.restype = ctypes.c_double
        lib.mash_heap_set_size.argtypes = [p, ctypes.c_int]
        lib.mash_heap_extract.restype = i64
        lib.mash_heap_extract.argtypes = [
            p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            i64,
        ]
        lib.mash_ingest_create.restype = p
        lib.mash_ingest_create.argtypes = [i64, i64, i64]
        lib.mash_ingest_destroy.argtypes = [p]
        lib.mash_ingest_feed.restype = i64
        lib.mash_ingest_feed.argtypes = [p, ctypes.c_void_p, i64,
                                         ctypes.c_void_p, i64,
                                         ctypes.c_void_p, i64]
        lib.mash_ingest_spill_n.restype = i64
        lib.mash_ingest_spill_n.argtypes = [p]
        lib.mash_ingest_finish.restype = i64
        lib.mash_ingest_finish.argtypes = [p, ctypes.c_void_p, i64]
        lib.mash_ingest_count.restype = i64
        lib.mash_ingest_count.argtypes = [p]
        lib.mash_ingest_total_len.restype = i64
        lib.mash_ingest_total_len.argtypes = [p]
        lib.mash_ingest_skipped.restype = ctypes.c_int
        lib.mash_ingest_skipped.argtypes = [p]
        lib.mash_ingest_first_ordinal.restype = i64
        lib.mash_ingest_first_ordinal.argtypes = [p]
        lib.mash_ingest_first_header.restype = i64
        lib.mash_ingest_first_header.argtypes = [p, ctypes.c_void_p, i64]
        lib.mash_fmt_create.restype = p
        lib.mash_fmt_create.argtypes = [i64, i64]
        lib.mash_fmt_destroy.argtypes = [p]
        lib.mash_fmt_phylip_cells.restype = i64
        lib.mash_fmt_phylip_cells.argtypes = [
            p,
            ctypes.c_void_p,
            i64,
            ctypes.c_void_p,
            i64,
        ]
        lib.mash_minmers.restype = i64
        lib.mash_minmers.argtypes = [
            ctypes.c_void_p,
            i64,
            i64,
            i64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            i64,
        ]
        _LIB = lib
        return _LIB


class ExactHeap:
    """Streaming bottom-s selector with exact reference semantics.

    Native-backed when possible; transparently falls back to the Python
    implementation in :mod:`mash_tpu_torch.native.pyheap`.
    """

    def __init__(self, cap: int, min_cov: int = 1, bloom_bytes: int = 0,
                 use64: bool = True):
        self.cap = cap
        self.use64 = use64
        lib = load_library()
        if lib is not None:
            self._lib = lib
            self._h = lib.mash_heap_create(
                cap, min_cov, bloom_bytes, int(use64)
            )
            self._py = None
        else:
            from mash_tpu_torch.native.pyheap import PyExactHeap

            self._lib = None
            self._py = PyExactHeap(cap, min_cov, bloom_bytes, use64)

    def insert(self, hashes: np.ndarray) -> None:
        """Insert hashes in stream order."""
        arr = np.ascontiguousarray(hashes, dtype=np.uint64)
        if self._lib is not None:
            self._lib.mash_heap_insert(
                self._h, arr.ctypes.data, len(arr)
            )
        else:
            self._py.insert(arr)

    @property
    def size(self) -> int:
        if self._lib is not None:
            return int(self._lib.mash_heap_size(self._h))
        return self._py.size

    @property
    def full(self) -> bool:
        if self._lib is not None:
            return bool(self._lib.mash_heap_full(self._h))
        return self._py.size >= self.cap

    @property
    def top(self) -> int:
        if self._lib is not None:
            return int(self._lib.mash_heap_top(self._h))
        return self._py.top

    def multiplicity(self) -> float:
        if self._lib is not None:
            return float(self._lib.mash_heap_multiplicity(self._h))
        return self._py.multiplicity()

    def set_size(self) -> float:
        if self._lib is not None:
            return float(
                self._lib.mash_heap_set_size(self._h, int(self.use64))
            )
        return self._py.set_size(self.use64)

    def extract(self):
        """Sorted (hashes, counts) arrays."""
        if self._lib is not None:
            out_h = np.empty(self.cap, dtype=np.uint64)
            out_c = np.empty(self.cap, dtype=np.uint32)
            n = self._lib.mash_heap_extract(
                self._h, out_h.ctypes.data, out_c.ctypes.data, self.cap
            )
            return out_h[:n], out_c[:n]
        return self._py.extract()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.mash_heap_destroy(self._h)
            self._h = None


class DistFormatter:
    """Memoized "%.6g" Mash-distance text formatter (C++ backed).

    Formats packed ``common | denom << 16`` uint32 cells into the PHYLIP
    row body ``"\\t%.6g" * n`` with the exact reference distance formula
    (``src/mash/CommandDistance.cpp:387-407``).  Falls back to numpy
    formatting if the native library is unavailable.
    """

    def __init__(self, k: int, cap: int):
        self.k = k
        self.cap = cap
        lib = load_library()
        self._lib = lib
        self._f = lib.mash_fmt_create(k, cap) if lib is not None else None

    def phylip_cells(self, packed: np.ndarray) -> bytes:
        """"\\t<dist>" repeated for each packed cell."""
        n = packed.shape[0]
        if self._f is not None:
            arr = np.ascontiguousarray(packed, dtype=np.uint32)
            out = np.empty(16 * n + 16, dtype=np.uint8)
            w = self._lib.mash_fmt_phylip_cells(
                self._f, arr.ctypes.data, n, out.ctypes.data, len(out)
            )
            assert w >= 0
            return out[:w].tobytes()
        from mash_tpu_torch.core.stats import mash_distance_array

        c = (packed & 0xFFFF).astype(np.int64)
        d = (packed >> 16).astype(np.int64)
        dist = mash_distance_array(c, d, self.k)
        cells = np.char.mod("%.6g", dist)
        if n == 0:
            return b""
        return ("\t" + "\t".join(cells)).encode()

    def __del__(self):
        if getattr(self, "_f", None) is not None:
            self._lib.mash_fmt_destroy(self._f)
            self._f = None


def minmer_positions(hashes: np.ndarray, window: int, mins: int):
    """Windowed minmer (position, hash) pairs, in position order.

    Positions whose hash is among the bottom-``mins`` distinct hashes of
    some length-``window`` window (leftmost occurrence per repeated hash),
    replicating ``getMinHashPositions`` (``src/mash/Sketch.cpp:585-895``).
    Falls back to the pure-Python sweep when the native library is
    unavailable.
    """
    arr = np.ascontiguousarray(hashes, dtype=np.uint64)
    n = len(arr)
    lib = load_library()
    if lib is None:
        from mash_tpu_torch.native.pyheap import py_minmers

        return py_minmers(arr, window, mins)
    cap = n + 1
    out_pos = np.empty(cap, dtype=np.uint32)
    out_hash = np.empty(cap, dtype=np.uint64)
    cnt = lib.mash_minmers(
        arr.ctypes.data,
        n,
        window,
        mins,
        out_pos.ctypes.data,
        out_hash.ctypes.data,
        cap,
    )
    assert cnt >= 0
    return out_pos[:cnt].copy(), out_hash[:cnt].copy()


class NativeIngest:
    """Streaming FASTA/FASTQ parse + chunk-row packing (C++ backed).

    Feed raw (decompressed) file blocks; get back ready-to-upload
    ``[n_rows, chunk_len]`` uint8 row arrays in the engine's layout
    (0x00 record separators, k-1 overlap between rows).  Metadata
    (record count, total length, first valid header) is tracked natively.
    Raises RuntimeError if the native library is unavailable — callers
    should check :func:`load_library` first and fall back.
    """

    PACK_RAW = 0        # raw byte rows
    PACK_ACGT = 1       # 2-bit + validity mask, case folded on host
    PACK_ACGT_CASE = 2  # 2-bit + validity mask, case preserved

    def __init__(self, chunk_len: int, k: int, pack_mode: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.chunk_len = chunk_len
        self.k = k
        self.pack_mode = pack_mode
        self.row_bytes = (
            chunk_len // 4 + chunk_len // 8 if pack_mode else chunk_len
        )
        self._g = lib.mash_ingest_create(chunk_len, k, pack_mode)
        if not self._g:
            raise RuntimeError("invalid ingest configuration")

    def feed(self, block: bytes) -> np.ndarray:
        """Parse a block; returns the complete rows it produced."""
        n = len(block)
        step = self.chunk_len - (self.k - 1)
        cap = (n + self.chunk_len) // step + 2
        rows = np.empty((cap, self.row_bytes), dtype=np.uint8)
        buf = np.frombuffer(block, dtype=np.uint8)
        m = self._lib.mash_ingest_feed(
            self._g, buf.ctypes.data, n, rows.ctypes.data, cap, None, 0
        )
        if m < 0:
            raise RuntimeError("ingest row overflow")
        return rows[:m]

    def feed_into(
        self,
        block,
        rows_out: np.ndarray,
        row_offset: int,
        spill: np.ndarray,
    ) -> tuple:
        """Zero-copy parse: write rows into ``rows_out[row_offset:]``.

        ``block`` is a bytes-like (bytes or uint8 ndarray); overflowing
        rows land in ``spill``.  Returns ``(rows_written, spill_rows)``.
        """
        buf = np.frombuffer(block, dtype=np.uint8)
        cap = rows_out.shape[0] - row_offset
        m = self._lib.mash_ingest_feed(
            self._g,
            buf.ctypes.data,
            buf.shape[0],
            rows_out.ctypes.data + row_offset * self.row_bytes,
            cap,
            spill.ctypes.data,
            spill.shape[0],
        )
        if m < 0:
            raise RuntimeError("ingest row overflow")
        return m, int(self._lib.mash_ingest_spill_n(self._g))

    def finish(self) -> np.ndarray:
        """Flush the final (zero-padded) partial row at end of stream."""
        rows = np.empty((2, self.row_bytes), dtype=np.uint8)
        m = self._lib.mash_ingest_finish(self._g, rows.ctypes.data, 2)
        if m < 0:
            raise RuntimeError("ingest row overflow")
        return rows[:m]

    @property
    def count(self) -> int:
        return int(self._lib.mash_ingest_count(self._g))

    @property
    def total_len(self) -> int:
        return int(self._lib.mash_ingest_total_len(self._g))

    @property
    def skipped(self) -> bool:
        return bool(self._lib.mash_ingest_skipped(self._g))

    @property
    def first_ordinal(self) -> int:
        """Index (within this stream) of the first record with len >= k."""
        return int(self._lib.mash_ingest_first_ordinal(self._g))

    @property
    def first_header(self) -> str:
        out = np.empty(8192, dtype=np.uint8)
        n = self._lib.mash_ingest_first_header(
            self._g, out.ctypes.data, 8192
        )
        if n > 8192:  # rare: regrow for very long headers
            out = np.empty(n, dtype=np.uint8)
            n = self._lib.mash_ingest_first_header(
                self._g, out.ctypes.data, n
            )
        return out[:n].tobytes().decode("utf-8", "replace")

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._g:
            self._lib.mash_ingest_destroy(self._g)
            self._g = None

