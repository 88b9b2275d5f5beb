"""Cap'n Proto ``.msh`` sketch files, read and written from scratch.

The reference persists sketches via Cap'n Proto using the frozen schema in
``src/mash/capnp/MinHash.capnp`` and mmap-based zero-copy reads
(``src/mash/Sketch.cpp:255-324, 384-490, 907-1067``).  Cap'n Proto is not
available in this environment, so this module implements the wire format
directly for that one schema: segment framing, struct/list/far pointers,
XOR'd defaults, composite lists and NUL-terminated text.

Schema layout (derived from the capnp layout algorithm over the schema's
ordinals):

``MinHash`` root struct — 3 data words, 4 pointers:
  data: kmerSize u32 @bit0, windowSize u32 @32, minHashesPerWindow u32 @64,
        concatenated bool @96, noncanonical bool @97, preserveCase bool @98,
        error f32 @128, hashSeed u32 @160 (default 42, stored XOR 42)
  ptrs: 0 referenceListOld, 1 locusList, 2 alphabet (Text), 3 referenceList

``ReferenceList`` — 0 data words, 1 pointer (references: composite list)

``Reference`` — 2 data words, 7 pointers:
  data: length u32 @bit0, counts32Sorted bool @32, length64 u64 @64
  ptrs: 0 sequence, 1 quality, 2 name, 3 comment, 4 hashes32, 5 hashes64,
        6 counts32

``LocusList`` — 0 data words, 1 pointer (loci: composite list)

``Locus`` — 3 data words, 0 pointers:
  data: sequence u32 @bit0, position u32 @32, hash32 u32 @64, hash64 u64 @128

Writer quirk for compatibility: when the hash seed is 42 the reference list
is stored in the legacy ``referenceListOld`` field (``Sketch.cpp:397``);
readers prefer ``referenceList`` when non-empty and fall back
(``Sketch.cpp:300, 932``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from mash_tpu_torch.core.params import SketchParams, ALPHABET_NUCLEOTIDE
from mash_tpu_torch.core.sketch import SketchRef

_HASH_SEED_DEFAULT = 42

# list element-size codes
_SZ_VOID, _SZ_BIT, _SZ_BYTE, _SZ_2B, _SZ_4B, _SZ_8B, _SZ_PTR, _SZ_COMPOSITE = (
    range(8)
)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Message:
    """Segment-aware pointer resolution for one capnp message."""

    def __init__(self, segments: List[memoryview]):
        self.segments = segments

    @classmethod
    def from_bytes(cls, data: bytes) -> "_Message":
        if len(data) < 8:
            raise ValueError("truncated capnp message")
        nseg = struct.unpack_from("<I", data, 0)[0] + 1
        sizes = struct.unpack_from("<%dI" % nseg, data, 4)
        off = 4 + 4 * nseg
        off = (off + 7) & ~7
        segs = []
        mv = memoryview(data)
        for words in sizes:
            end = off + words * 8
            if end > len(data):
                raise ValueError("truncated capnp segment")
            segs.append(mv[off:end])
            off = end
        return cls(segs)

    def root(self) -> "_StructReader":
        obj = self._resolve(0, 0)
        if obj is None:
            return _StructReader(self, 0, 0, 0, 0, 0)
        kind, seg, off, a, b = obj
        if kind != 0:
            raise ValueError("root is not a struct")
        return _StructReader(self, seg, off, a, b, 0)

    def _word(self, seg: int, off: int) -> int:
        return struct.unpack_from("<Q", self.segments[seg], off * 8)[0]

    def _resolve(self, seg: int, ptr_off: int):
        """Decode the pointer at (seg, word ptr_off).

        Returns None for null, else (kind, seg, content_off, A, B) where
        kind 0=struct (A=data words, B=ptr words) and kind 1=list
        (A=elem size code, B=count-or-words).
        """
        w = self._word(seg, ptr_off)
        if w == 0:
            return None
        kind = w & 3
        if kind == 2:  # far pointer
            double = (w >> 2) & 1
            pad_off = (w >> 3) & ((1 << 29) - 1)
            target_seg = w >> 32
            if not double:
                return self._resolve(target_seg, pad_off)
            # double-far: pad word 0 is a far pointer to content start;
            # pad word 1 is the tag describing the object.
            far2 = self._word(target_seg, pad_off)
            content_seg = far2 >> 32
            content_off = (far2 >> 3) & ((1 << 29) - 1)
            tag = self._word(target_seg, pad_off + 1)
            tkind = tag & 3
            if tkind == 0:
                return (
                    0,
                    content_seg,
                    content_off,
                    (tag >> 32) & 0xFFFF,
                    (tag >> 48) & 0xFFFF,
                )
            return (1, content_seg, content_off, (tag >> 32) & 7, tag >> 35)
        if kind == 0:
            off = _sign30((w >> 2) & ((1 << 30) - 1))
            content = ptr_off + 1 + off
            return (0, seg, content, (w >> 32) & 0xFFFF, (w >> 48) & 0xFFFF)
        if kind == 1:
            off = _sign30((w >> 2) & ((1 << 30) - 1))
            content = ptr_off + 1 + off
            return (1, seg, content, (w >> 32) & 7, w >> 35)
        raise ValueError("unsupported pointer kind 3 (capability)")


def _sign30(v: int) -> int:
    return v - (1 << 30) if v & (1 << 29) else v


@dataclass
class _StructReader:
    msg: _Message
    seg: int
    off: int          # word offset of data section
    data_words: int
    ptr_words: int
    _pad: int = 0

    def _data_bytes(self) -> memoryview:
        s = self.msg.segments[self.seg]
        return s[self.off * 8 : (self.off + self.data_words) * 8]

    def u32(self, bit: int, default: int = 0) -> int:
        byte = bit // 8
        if byte + 4 > self.data_words * 8:
            return default
        raw = struct.unpack_from(
            "<I", self.msg.segments[self.seg], self.off * 8 + byte
        )[0]
        return raw ^ default

    def u64(self, bit: int, default: int = 0) -> int:
        byte = bit // 8
        if byte + 8 > self.data_words * 8:
            return default
        raw = struct.unpack_from(
            "<Q", self.msg.segments[self.seg], self.off * 8 + byte
        )[0]
        return raw ^ default

    def f32(self, bit: int, default: float = 0.0) -> float:
        byte = bit // 8
        if byte + 4 > self.data_words * 8:
            return default
        return struct.unpack_from(
            "<f", self.msg.segments[self.seg], self.off * 8 + byte
        )[0]

    def bool_(self, bit: int, default: bool = False) -> bool:
        byte = bit // 8
        if byte >= self.data_words * 8:
            return default
        raw = self.msg.segments[self.seg][self.off * 8 + byte]
        return bool((raw >> (bit % 8)) & 1) ^ default

    def _ptr(self, idx: int):
        if idx >= self.ptr_words:
            return None
        return self.msg._resolve(self.seg, self.off + self.data_words + idx)

    def struct_field(self, idx: int) -> Optional["_StructReader"]:
        obj = self._ptr(idx)
        if obj is None:
            return None
        kind, seg, off, a, b = obj
        if kind != 0:
            raise ValueError("expected struct pointer")
        return _StructReader(self.msg, seg, off, a, b)

    def text(self, idx: int) -> str:
        obj = self._ptr(idx)
        if obj is None:
            return ""
        kind, seg, off, code, count = obj
        if kind != 1 or code != _SZ_BYTE:
            raise ValueError("expected text")
        raw = bytes(self.msg.segments[seg][off * 8 : off * 8 + count])
        return raw.rstrip(b"\0").decode("utf-8", "replace")

    def scalar_list(self, idx: int, dtype) -> np.ndarray:
        obj = self._ptr(idx)
        if obj is None:
            return np.empty(0, dtype=dtype)
        kind, seg, off, code, count = obj
        if kind != 1:
            raise ValueError("expected list pointer")
        itemsize = np.dtype(dtype).itemsize
        expect = {4: _SZ_4B, 8: _SZ_8B, 2: _SZ_2B, 1: _SZ_BYTE}[itemsize]
        if code != expect:
            raise ValueError(
                "unexpected list element size %d for %s" % (code, dtype)
            )
        raw = self.msg.segments[seg][off * 8 : off * 8 + count * itemsize]
        return np.frombuffer(bytes(raw), dtype=dtype)

    def has_ptr(self, idx: int) -> bool:
        return self._ptr(idx) is not None

    def struct_list(self, idx: int) -> List["_StructReader"]:
        obj = self._ptr(idx)
        if obj is None:
            return []
        kind, seg, off, code, words = obj
        if kind != 1 or code != _SZ_COMPOSITE:
            if kind == 1 and code == _SZ_VOID:
                return []
            raise ValueError("expected composite list")
        tag = self.msg._word(seg, off)
        count = (tag >> 2) & ((1 << 30) - 1)
        dw = (tag >> 32) & 0xFFFF
        pw = (tag >> 48) & 0xFFFF
        stride = dw + pw
        out = []
        base = off + 1
        for i in range(count):
            out.append(
                _StructReader(self.msg, seg, base + i * stride, dw, pw)
            )
        return out


@dataclass
class MshFile:
    """Decoded contents of a .msh (or .msw) sketch file."""

    params: SketchParams
    references: List[SketchRef]
    # windowed mode: per-reference (position, hash) arrays
    position_hashes: List[np.ndarray] = field(default_factory=list)


def _decode_params(root: _StructReader) -> SketchParams:
    p = SketchParams()
    p.kmer_size = root.u32(0)
    p.window_size = root.u32(32)
    p.min_hashes_per_window = root.u32(64)
    p.concatenated = root.bool_(96)
    p.noncanonical = root.bool_(97)
    p.preserve_case = root.bool_(98)
    p.error = root.f32(128)
    p.seed = root.u32(160, default=_HASH_SEED_DEFAULT)
    alphabet = root.text(2) or ALPHABET_NUCLEOTIDE
    p.set_alphabet(alphabet)
    return p


def _reference_list(root: _StructReader) -> List[_StructReader]:
    """Prefer referenceList, falling back to the legacy field."""
    new = root.struct_field(3)
    if new is not None:
        refs = new.struct_list(0)
        if refs:
            return refs
    old = root.struct_field(0)
    if old is not None:
        return old.struct_list(0)
    return []


def _load_bytes(path: str, data: Optional[bytes]) -> bytes:
    if data is not None:
        return data
    with open(path, "rb") as f:
        return f.read()


class CorruptMshError(ValueError):
    """A ``.msh`` file whose capnp structure cannot be decoded."""


def _corrupt(path: str, exc: Exception) -> "CorruptMshError":
    return CorruptMshError(
        "corrupt or truncated sketch file %s (%s: %s)"
        % (path, type(exc).__name__, exc)
    )


# Low-level decode failures on damaged input surface as these; they are
# re-raised as CorruptMshError naming the file (a truncated segment
# table raises struct.error, a wild pointer IndexError, a list running
# past its segment ValueError from numpy).
_DECODE_ERRORS = (ValueError, IndexError, struct.error, OverflowError)


def read_msh_header(
    path: str, data: Optional[bytes] = None
) -> Tuple[SketchParams, int]:
    """Parameters + reference count (``Sketch::initParametersFromCapnp``).

    ``data``: the file's bytes when the caller already read them
    (avoids re-reading multi-GB sketch files for header+load flows).
    """
    data = _load_bytes(path, data)
    try:
        msg = _Message.from_bytes(data)
        root = msg.root()
        params = _decode_params(root)
        refs = _reference_list(root)
        params.counts = bool(refs) and refs[0].has_ptr(6)
    except _DECODE_ERRORS as e:
        raise _corrupt(path, e) from e
    return params, len(refs)


def read_msh(
    path: str, max_hashes: Optional[int] = None,
    data: Optional[bytes] = None,
) -> MshFile:
    """Full sketch load (``loadCapnp``, ``src/mash/Sketch.cpp:907-1067``).

    ``max_hashes``: truncate each reference to this many hashes (the
    caller's current sketch size), mirroring the load-time reduction.
    ``data``: pre-read file bytes (see :func:`read_msh_header`).
    """
    data = _load_bytes(path, data)
    try:
        msg = _Message.from_bytes(data)
        root = msg.root()
        params = _decode_params(root)
        ref_readers = _reference_list(root)
        params.counts = bool(ref_readers) and ref_readers[0].has_ptr(6)
    except _DECODE_ERRORS as e:
        raise _corrupt(path, e) from e

    try:
        references = []
        for r in ref_readers:
            name = r.text(2)
            comment = r.text(3)
            length = r.u64(64)
            if not length:
                length = r.u32(0)
            if params.use64:
                hashes = r.scalar_list(5, np.uint64)
            else:
                hashes = r.scalar_list(4, np.uint32).astype(np.uint64)
            if max_hashes is not None and len(hashes) > max_hashes:
                hashes = hashes[:max_hashes]
            counts = None
            if r.has_ptr(6):
                counts = r.scalar_list(6, np.uint32)[: len(hashes)]
            references.append(
                SketchRef(
                    name=name,
                    comment=comment,
                    length=int(length),
                    hashes=np.ascontiguousarray(hashes),
                    counts=counts,
                    counts_sorted=r.bool_(32),
                )
            )

        position_hashes = [
            np.empty(0, dtype=np.uint64) for _ in references
        ]
        locus_list = root.struct_field(1)
        if locus_list is not None:
            loci = locus_list.struct_list(0)
            if loci:
                by_ref = {}
                for lr in loci:
                    si = lr.u32(0)
                    by_ref.setdefault(si, []).append(
                        (lr.u32(32), lr.u64(128))
                    )
                for si, items in by_ref.items():
                    if si < len(position_hashes):
                        position_hashes[si] = np.array(
                            items, dtype=np.uint64
                        )
    except _DECODE_ERRORS as e:
        raise _corrupt(path, e) from e
    return MshFile(params, references, position_hashes)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _SegBuilder:
    """Single-segment message builder with pointer backpatching."""

    def __init__(self):
        self.buf = bytearray()

    def nwords(self) -> int:
        return len(self.buf) // 8

    def alloc(self, words: int) -> int:
        off = self.nwords()
        self.buf += b"\0" * (words * 8)
        return off

    def put_u64(self, word_off: int, byte: int, value: int):
        struct.pack_into("<Q", self.buf, word_off * 8 + byte, value & ((1 << 64) - 1))

    def put_u32(self, word_off: int, byte: int, value: int):
        struct.pack_into("<I", self.buf, word_off * 8 + byte, value & 0xFFFFFFFF)

    def put_f32(self, word_off: int, byte: int, value: float):
        struct.pack_into("<f", self.buf, word_off * 8 + byte, value)

    def set_bit(self, word_off: int, bit: int, value: bool):
        if value:
            self.buf[word_off * 8 + bit // 8] |= 1 << (bit % 8)

    def struct_ptr(self, ptr_off: int, target: int, dw: int, pw: int):
        rel = target - (ptr_off + 1)
        w = ((rel & ((1 << 30) - 1)) << 2) | (dw << 32) | (pw << 48)
        self.put_u64(ptr_off, 0, w)

    def list_ptr(self, ptr_off: int, target: int, code: int, count: int):
        rel = target - (ptr_off + 1)
        w = 1 | ((rel & ((1 << 30) - 1)) << 2) | (code << 32) | (count << 35)
        self.put_u64(ptr_off, 0, w)

    def write_text(self, ptr_off: int, text: str):
        raw = text.encode("utf-8") + b"\0"
        words = (len(raw) + 7) // 8
        target = self.alloc(words)
        self.buf[target * 8 : target * 8 + len(raw)] = raw
        self.list_ptr(ptr_off, target, _SZ_BYTE, len(raw))

    def write_scalar_list(self, ptr_off: int, arr: np.ndarray, code: int):
        raw = arr.tobytes()
        words = (len(raw) + 7) // 8
        target = self.alloc(words)
        self.buf[target * 8 : target * 8 + len(raw)] = raw
        self.list_ptr(ptr_off, target, code, len(arr))


def write_msh(path: str, params: SketchParams, references: List[SketchRef],
              position_hashes: Optional[List[np.ndarray]] = None) -> None:
    """Serialize sketches to ``.msh`` (``Sketch::writeToCapnp``)."""
    b = _SegBuilder()
    root_ptr = b.alloc(1)
    root = b.alloc(3 + 4)  # 3 data words + 4 pointers
    b.struct_ptr(root_ptr, root, 3, 4)
    rptr = root + 3  # pointer section

    b.put_u32(root, 0, params.kmer_size)
    b.put_u32(root, 4, params.window_size)
    b.put_u32(root + 1, 0, params.min_hashes_per_window)
    b.set_bit(root + 1, 32, params.concatenated)
    b.set_bit(root + 1, 33, params.noncanonical)
    b.set_bit(root + 1, 34, params.preserve_case)
    b.put_f32(root + 2, 0, params.error)
    b.put_u32(root + 2, 4, params.seed ^ _HASH_SEED_DEFAULT)

    # legacy field choice (Sketch.cpp:397)
    list_slot = 0 if params.seed == _HASH_SEED_DEFAULT else 3

    ref_list = b.alloc(1)  # ReferenceList: 0 data, 1 ptr
    b.struct_ptr(rptr + list_slot, ref_list, 0, 1)

    n = len(references)
    DW, PW = 2, 7  # Reference layout
    stride = DW + PW
    tag = b.alloc(1 + n * stride)
    elems = tag + 1
    b.put_u64(tag, 0, (n << 2) | (DW << 32) | (PW << 48))
    b.list_ptr(ref_list, tag, _SZ_COMPOSITE, n * stride)

    for i, ref in enumerate(references):
        base = elems + i * stride
        pbase = base + DW
        b.put_u32(base, 0, 0)  # legacy u32 length unset
        b.set_bit(base, 32, ref.counts_sorted and params.counts
                  and ref.counts is not None and len(ref.counts) > 0)
        b.put_u64(base + 1, 0, ref.length)
        b.write_text(pbase + 2, ref.name)
        b.write_text(pbase + 3, ref.comment)
        if len(ref.hashes):
            if params.use64:
                b.write_scalar_list(
                    pbase + 5,
                    np.ascontiguousarray(ref.hashes, dtype=np.uint64),
                    _SZ_8B,
                )
            else:
                b.write_scalar_list(
                    pbase + 4,
                    np.ascontiguousarray(
                        ref.hashes.astype(np.uint32)
                    ),
                    _SZ_4B,
                )
            if (
                params.counts
                and ref.counts is not None
                and len(ref.counts) > 0
            ):
                b.write_scalar_list(
                    pbase + 6,
                    np.ascontiguousarray(ref.counts, dtype=np.uint32),
                    _SZ_4B,
                )

    # locus list (windowed mode); always present like initLocusList()
    locus_list = b.alloc(1)
    b.struct_ptr(rptr + 1, locus_list, 0, 1)
    all_loci = []
    if position_hashes:
        for si, arr in enumerate(position_hashes):
            for pos, h in np.asarray(arr, dtype=np.uint64).reshape(-1, 2):
                all_loci.append((si, int(pos), int(h)))
    LDW = 3
    ltag = b.alloc(1 + len(all_loci) * LDW)
    b.put_u64(ltag, 0, (len(all_loci) << 2) | (LDW << 32))
    b.list_ptr(locus_list, ltag, _SZ_COMPOSITE, len(all_loci) * LDW)
    for j, (si, pos, h) in enumerate(all_loci):
        base = ltag + 1 + j * LDW
        b.put_u32(base, 0, si)
        b.put_u32(base, 4, pos)
        b.put_u64(base + 2, 0, h)

    b.write_text(rptr + 2, params.alphabet_string())

    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0, b.nwords()))
        f.write(bytes(b.buf))
