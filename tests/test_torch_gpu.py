"""mash_tpu_torch's CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are built
at first use) and carries the ``cuda`` marker; without a card the
``gpu`` fixture skips it.  Run on a GPU machine, which needs no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py

Each kernel and its plain version run on the same CUDA tensors and must
agree exactly (every output is an integer; a DB table by what it holds,
since its atomic inserts place the keys of one probe run in any order),
at edge shapes that ``chip_smoke.py``'s main-path shapes do not reach: a
ragged last subrow, a row shorter than one subrow, k from 1 to 32, both
hash widths, N-rich and lowercase input, candidate budgets on both sides
of the warp selection's limit, the protein alphabet, for the window hash
kernel every mode (k from 1 to 32, both widths, canonical or not, case
kept or not, the protein alphabet, windowed mode's raw bytes), the
screen batch, ragged and block-straddling 1-D rows, a row of exactly k
bytes and a strided view, for the pair kernels the capped walk's traps (identical and disjoint rows, zero-size rows,
widths around a warp, a cap below the sizes and above their sum), tiles
cut short, rows too wide for shared memory, the streamed path's tile
with its pad rows, a grid of 75 000 tiles, a real 32-bit hash 0xFFFFFFFF
and the streamed path against its CPU run, and for ``screen_count``
empty and all-invalid
batches, a DB of one hash, a DB hash of 2^64-1, valid 2^64-1 lanes,
32-bit hashes, totals past 2^32, a stream of one repeated hash, a DB
above ``BIG_DB_MIN`` and a batch of more than 2^31 bytes.  Commands on
the card must also print and write what they do on the CPU: ``sketch
-i`` with rows that run plain, take the kernel, or fail its certificate,
``sketch -r`` and ``-r -m 2``, ingest batches uploaded straight from
pinned memory (and kept whole while their copies wait) beside other
arrays staged, the screen fold's cardinality state through
the sketch kernel at the screen batch, the triangle's stripes with their ragged
last tiles, and the streamed ``triangle``.  The mesh functions over
``[cuda:0, cuda:0]`` must equal the one-device route, and two gloo ranks
on the card must assemble ``screen`` and the streamed ``triangle`` into
the one-process output.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from mash_tpu_torch.core.params import (
    ALPHABET_PROTEIN,
    SketchParams,
    default_nucleotide_params,
)
from mash_tpu_torch.ops import distance as td
from mash_tpu_torch.ops import pairwise_kernel as pk
from mash_tpu_torch.ops import screen_kernel as sck
from mash_tpu_torch.ops import screen_ops as so
from mash_tpu_torch.ops import sketch_kernel as sk
from mash_tpu_torch.ops.kmers import alphabet_bytes
from mash_tpu_torch.ops.sketch_ops import biased

pytestmark = pytest.mark.cuda

DNA = alphabet_bytes(default_nucleotide_params().alphabet)
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _protein():
    p = SketchParams()
    p.set_alphabet(ALPHABET_PROTEIN)
    return alphabet_bytes(p.alphabet)


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _seq(seed, symbols, shape):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(symbols, dtype=np.uint8), size=shape)


@pytest.mark.parametrize(
    "k,use64,noncanon,preserve,length,symbols",
    [(21, True, False, False, 40000, b"ACGTacgtNn\x00"),
     (21, True, True, False, 50001, b"ACGTacgtNn\x00"),
     (16, False, False, False, 40000, b"ACGTacgtNn\x00"),
     (16, True, False, True, 30000, b"ACGTacgt"),
     (1, False, False, True, 9000, b"ACGTacgtNn\x00"),
     (32, True, False, False, 2 * sk.C + 31, b"ACGTacgtNn\x00"),
     (32, False, True, False, 20000, b"ACGTACGTacgt"),
     (31, True, False, False, 25000, b"ACGTNNNNn"),
     (9, False, True, True, 70000, b"ACGTacgtNn\x00"),
     (9, True, False, False, 12000, b"AAAAAAAACGTacgtN"),
     (21, True, False, False, 1000, b"ACGTacgtNn\x00")],
    ids=["k21", "k21_noncanon", "k16_32bit", "k16_64bit_case",
         "k1_case", "k32_ragged", "k32_32bit_noncanon", "k31_n_rich",
         "k9_noncanon_case", "k9_repetitive", "short_row"],
)
def test_sketch_select_matches_plain(gpu, k, use64, noncanon, preserve,
                                     length, symbols):
    x = torch.from_numpy(_seq(k + length, symbols, (3, length))).to(gpu)
    kw = dict(alphabet=DNA, k=k, seed=42, use64=use64,
              noncanonical=noncanon, preserve_case=preserve)
    # the warp selection takes m < 32, the block sort the rest
    for m in (1, 16, 31, 32, 128, 256, 1024, sk.C - 1):
        before = sk.LAUNCHES["sketch_select"]
        got = sk.sketch_select(x, **kw, m=m)
        want = sk.sketch_select_plain(x, **kw, m=m)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["sketch_select"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (k, m)


def test_sketch_select_protein(gpu):
    alpha = _protein()
    x = torch.from_numpy(
        _seq(3, b"ACDEFGHIKLMNPQRSTVWYXacd*", (2, 30000))).to(gpu)
    kw = dict(alphabet=alpha, k=9, seed=42, use64=True, noncanonical=True,
              preserve_case=False)
    got = sk.sketch_select(x, **kw, m=32)
    want = sk.sketch_select_plain(x, **kw, m=32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["random", "repetitive", "mixed", "empty"])
def test_sketch_chunks_fused_matches_plain(gpu, case):
    rand = _seq(9, b"ACGTacgtN", (2, 60000))
    rep = np.tile(np.frombuffer(b"AT", np.uint8), 30000)[None].repeat(2, 0)
    arr = {"random": rand, "repetitive": rep,
           "mixed": np.stack([rand[0], rep[0]]),
           "empty": np.zeros((2, 60000), np.uint8)}[case]
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(gpu)
    before = sk.LAUNCHES["sketch_select"]
    for k, use64 in ((21, True), (15, False)):
        kw = dict(alphabet=DNA, k=k, seed=42, use64=use64,
                  noncanonical=False, preserve_case=False)
        H, C = sk.sketch_chunks_fused(x, **kw, s=100)
        Hp, Cp = sk.sketch_chunks_plain(x, **kw, s=100)
        assert torch.equal(H, Hp) and torch.equal(C, Cp), k
    assert sk.LAUNCHES["sketch_select"] == before + 2


@pytest.mark.parametrize("s", [5000, 10000])
def test_sketch_chunks_fused_large_s(gpu, s):
    """Sketch sizes whose candidate budget exceeds the TPU kernel's
    3m + 2 <= 128 output still launch the kernel on 1 MiB chunks."""
    x = torch.from_numpy(_seq(s, b"ACGTacgtN", (2, 1 << 20))).to(gpu)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    assert 3 * sk.candidate_budget(s, sk.C, (1 << 20) - 20) + 2 > 128
    before = sk.LAUNCHES["sketch_select"]
    H, C = sk.sketch_chunks_fused(x, **kw, s=s)
    Hp, Cp = sk.sketch_chunks_plain(x, **kw, s=s)
    assert sk.LAUNCHES["sketch_select"] == before + 1
    assert torch.equal(H, Hp) and torch.equal(C, Cp)


def _seq_rare(seed, symbols, rare, shape, p_rare=0.01):
    """``symbols`` with a fraction ``p_rare`` of ``rare`` bytes, so that
    windows of every k up to 32 are both valid and invalid."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(symbols, dtype=np.uint8), size=shape)
    hit = rng.random(shape) < p_rare
    seq[hit] = rng.choice(np.frombuffer(rare, dtype=np.uint8),
                          size=int(hit.sum()))
    return seq


HASH_CASES = [
    # k, use64, noncanonical, preserve_case, alphabet, symbols, rare, shape
    (1, False, False, False, "dna", b"ACGTacgt", b"N\x00\xc8", (3, 5000)),
    (9, True, False, False, "dna", b"ACGTacgt", b"N\x00\xc8", (3, 5000)),
    (9, False, True, True, "dna", b"ACGT", b"acgtN\x00\xc8", (3, 5000)),
    (16, False, False, False, "dna", b"ACGTacgt", b"NRY\x00", (2, 9000)),
    (16, True, True, False, "dna", b"ACGTacgt", b"\x80\xff", (2, 9000)),
    (21, True, False, False, "dna", b"ACGTacgt", b"N\x00\xc8", (4, 3000)),
    (21, True, True, True, "dna", b"ACGT", b"acgtN\x00", (4, 3000)),
    (21, False, False, True, "dna", b"ACGT", b"acgtN", (4, 3000)),
    (24, True, False, False, "dna", b"AAAAAAAAACGTacgt", b"N", (2, 4000)),
    (25, True, False, False, "dna", b"ACGTacgt", b"N\x00\xc8", (2, 4000)),
    (32, True, False, False, "dna", b"ACGTacgt", b"N\x00\xc8", (2, 4000)),
    (32, False, True, False, "dna", b"ACGTacgt", b"N\x00\xc8", (2, 4000)),
    (9, True, True, False, "protein", b"ACDEFGHIKLMNPQRSTVWYacd",
     b"X*\x00", (2, 5000)),
    (21, True, True, True, "raw", b"ACGTacgt", b"N\x00\xc8", (1, 6000)),
]


@pytest.mark.parametrize(
    "k,use64,noncanon,preserve,alpha,symbols,rare,shape", HASH_CASES,
    ids=["k%d_%s_%s%s%s" % (c[0], c[4], "64" if c[1] else "32",
                            "_nc" if c[2] else "", "_Z" if c[3] else "")
         for c in HASH_CASES])
def test_hash_windows_matches_plain(gpu, k, use64, noncanon, preserve, alpha,
                                    symbols, rare, shape):
    """K5 equals ``hash_chunk_plain`` on h and v of every window, valid or
    not, and ``hash_chunk`` on a CUDA tensor launches it."""
    from mash_tpu_torch.ops import hash_kernel as hk
    from mash_tpu_torch.ops import kmers

    alphabet = {"dna": DNA, "protein": _protein(), "raw": ()}[alpha]
    x = torch.from_numpy(_seq_rare(k + shape[1], symbols, rare,
                                   shape)).to(gpu)
    kw = dict(alphabet=alphabet, k=k, seed=42, use64=use64,
              noncanonical=noncanon, preserve_case=preserve)
    before = hk.LAUNCHES["hash_windows"]
    h, v = kmers.hash_chunk(x, **kw)
    hp, vp = kmers.hash_chunk_plain(x, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["hash_windows"] == before + 1
    assert h.shape == v.shape == (shape[0], shape[1] - k + 1)
    assert h.dtype == torch.int64 and v.dtype == torch.bool
    assert torch.equal(h, hp) and torch.equal(v, vp)
    if alpha != "raw":
        assert bool(v.any()) and not bool(v.all())


@pytest.mark.parametrize("k,use64", [(21, True), (16, False)])
def test_hash_windows_screen_batch(gpu, k, use64):
    """The screen path's batch, [32, 1 MiB]."""
    from mash_tpu_torch.ops import hash_kernel as hk
    from mash_tpu_torch.ops import kmers

    x = torch.from_numpy(_seq(k, b"ACGTACGTACGTacgtN",
                              (32, 1 << 20))).to(gpu)
    kw = dict(alphabet=DNA, k=k, seed=42, use64=use64, noncanonical=False,
              preserve_case=False)
    h, v = hk.hash_windows(x, **kw)
    hp, vp = kmers.hash_chunk_plain(x, **kw)
    assert torch.equal(h, hp) and torch.equal(v, vp)


@pytest.mark.parametrize(
    "length", [(1 << 20) + 12345, 3 * 1024 + 7 + 20, 21],
    ids=["ragged_exact_row", "not_a_block_multiple", "L_equals_k"])
def test_hash_windows_one_row(gpu, length):
    """1-D rows as the exact route hashes them (no bucket padding)."""
    from mash_tpu_torch.ops import hash_kernel as hk
    from mash_tpu_torch.ops import kmers

    x = torch.from_numpy(_seq(length, b"ACGTacgtN\n\x00", length)).to(gpu)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    h, v = hk.hash_windows(x, **kw)
    hp, vp = kmers.hash_chunk_plain(x, **kw)
    assert h.shape == (length - 20,)
    assert torch.equal(h, hp) and torch.equal(v, vp)


def test_hash_windows_windowed_raw_mode(gpu):
    """``windowed_hash``'s raw forward 64-bit hashes of a 1 MiB piece."""
    from mash_tpu_torch.core.engine import DEFAULT_CHUNK, windowed_hash
    from mash_tpu_torch.ops import hash_kernel as hk
    from mash_tpu_torch.ops import kmers

    x = torch.from_numpy(_seq(4, b"ACGTACGTacgtN", DEFAULT_CHUNK)).to(gpu)
    before = hk.LAUNCHES["hash_windows"]
    got = windowed_hash(x, 21, 42)
    want, _ = kmers.hash_chunk_plain(x, alphabet=(), k=21, seed=42,
                                     use64=True, noncanonical=True,
                                     preserve_case=True)
    assert hk.LAUNCHES["hash_windows"] == before + 1
    assert torch.equal(got, want)


def test_hash_windows_strided_and_leading_dims(gpu):
    """A non-contiguous [3, 2, L] view keeps its leading dims."""
    from mash_tpu_torch.ops import hash_kernel as hk
    from mash_tpu_torch.ops import kmers

    base = torch.from_numpy(_seq(6, b"ACGTacgtN", (3, 2, 2 * 3000))).to(gpu)
    x = base[..., ::2]
    assert not x.is_contiguous()
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    h, v = hk.hash_windows(x, **kw)
    hp, vp = kmers.hash_chunk_plain(x.contiguous(), **kw)
    assert h.shape == (3, 2, 3000 - 20)
    assert torch.equal(h, hp) and torch.equal(v, vp)


# hash_windows.cu's windows a thread (R) and a work item (TILE)
K5_R, K5_TILE = 8, 2048


def _k5_equal(x, **kw):
    """K5 against its twin on every window of ``x``."""
    from mash_tpu_torch.ops import hash_kernel as hk
    from mash_tpu_torch.ops import kmers

    h, v = hk.hash_windows(x, **kw)
    hp, vp = kmers.hash_chunk_plain(x, **kw)
    assert h.shape == hp.shape
    assert torch.equal(h, hp) and torch.equal(v, vp)
    return v


@pytest.mark.parametrize("k", [1, 8, 9, 21, 32])
def test_hash_windows_run_and_tile_edges(gpu, k):
    """Rows of k, k + R - 1 and k + R bytes (one thread's run of windows,
    short, full and one over) and of a tile - 1, a tile and a tile + 1
    windows, in every mode."""
    for extra in (0, K5_R - 1, K5_R, K5_TILE - 2, K5_TILE - 1, K5_TILE):
        x = torch.from_numpy(_seq_rare(k + extra, b"ACGTacgt",
                                       b"N\x00\xc8", (3, k + extra))).to(gpu)
        for use64, noncanon, preserve in ((True, False, False),
                                          (False, True, False),
                                          (True, False, True)):
            _k5_equal(x, alphabet=DNA, k=k, seed=42, use64=use64,
                      noncanonical=noncanon, preserve_case=preserve)


def test_hash_windows_unaligned_rows_and_outputs(gpu):
    """Odd L puts every row base and output offset off alignment; a view
    one byte into its storage moves the first row's base too."""
    base = torch.from_numpy(_seq_rare(3, b"ACGTacgt", b"N\x00",
                                      (7 * 4099 + 1,))).to(gpu)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    for off in range(1, 4):
        x = base[off:off + 7 * 4097].view(7, 4097)
        assert x.data_ptr() % 16 == off
        _k5_equal(x, **kw)


def test_hash_windows_invalid_at_run_edges(gpu):
    """A non-alphabet byte at the first byte of every thread's run, and one
    at the last byte of every run, in the second row."""
    seq = _seq(5, b"ACGTacgt", (2, 3 * K5_TILE + 37))
    seq[0, ::K5_R] = ord("N")
    seq[1, K5_R - 1::K5_R] = 0x80
    x = torch.from_numpy(seq).to(gpu)
    for k in (1, 9, 21, 32):
        for preserve in (False, True):
            v = _k5_equal(x, alphabet=DNA, k=k, seed=42, use64=True,
                          noncanonical=False, preserve_case=preserve)
            if k < K5_R - 1:
                assert bool(v.any())


def test_hash_windows_palindromes_k20(gpu):
    """Reverse-complement palindromes of 20 bytes: every such window ties,
    and the tie takes the forward strand."""
    rng = np.random.default_rng(20)
    half = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(500, 10))
    comp = np.zeros(256, dtype=np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    seq = np.concatenate([half, comp[half[:, ::-1]]], axis=1).reshape(1, -1)
    x = torch.from_numpy(seq).to(gpu)
    for use64 in (True, False):
        v = _k5_equal(x, alphabet=DNA, k=20, seed=42, use64=use64,
                      noncanonical=False, preserve_case=False)
        assert bool(v.all())


def test_hash_windows_many_short_rows(gpu):
    """More than 65 535 rows, each shorter than a tile."""
    x = torch.from_numpy(_seq_rare(70, b"ACGTacgt", b"N",
                                   (70_000, 37))).to(gpu)
    _k5_equal(x, alphabet=DNA, k=21, seed=42, use64=True,
              noncanonical=False, preserve_case=False)


def _sketches(rng, n, s, universe, bits=64, full=False):
    H = np.full((n, s), EMPTY)
    N = np.zeros(n, np.int32)
    for i in range(n):
        m = s if full else int(rng.integers(max(1, s // 2), s + 1))
        vals = rng.choice(universe, size=m, replace=False).astype(np.uint64)
        if bits == 64:
            vals = vals * np.uint64(0x9E3779B97F4A7C15)
        else:
            vals = (vals * np.uint64(2654435761)) % np.uint64(2**32)
        H[i, :m] = np.sort(vals)
        N[i] = m
    return H, N


def _t(a, dev):
    return torch.from_numpy(
        a.view(np.int64) if a.dtype == np.uint64 else a).to(dev)


# (NQ, NR, s, cap) of random rows, half to fully filled
PAIR_SHAPES = {
    "small": (5, 9, 40, 40), "cap_below_s": (33, 70, 17, 10),
    "uneven": (100, 37, 1000, 900), "square": (64, 64, 1000, 1000),
    "wider_than_smem": (3, 5, 30000, 30000), "s1": (13, 17, 1, 1),
    "s31": (13, 17, 31, 31), "s32": (13, 17, 32, 32), "s33": (13, 17, 33, 33),
    "cap_above_sizes": (9, 11, 50, 1000), "ragged_tiles": (9, 7, 200, 150),
    "one_tile_row": (6, 10, 5000, 5000),
}
PAIR_CASES = list(PAIR_SHAPES) + ["identical", "disjoint", "empty_rows",
                                  "stream_tile", "tall_grid"]


def _pair_case(case):
    """(qry, nq, ref, nr, cap) numpy rows of one edge of the pair kernels:
    the walk's traps (every element a match and on every lane boundary,
    no match, zero-size rows, widths around a warp, a cap below the sizes
    and above their sum), tiles cut short, one tile row a block (s = 5000)
    and rows read from global memory (s = 30000), the streamed path's
    tile with its zero-size pad rows, and a grid of 75 000 query tiles."""
    rng = np.random.default_rng(PAIR_CASES.index(case))
    if case in PAIR_SHAPES:
        nq, nr, s, cap = PAIR_SHAPES[case]
        universe = 2 * s + 1 if s < 40 else 3 * s
        return (*_sketches(rng, nq, s, universe),
                *_sketches(rng, nr, s, universe), cap)
    if case in ("identical", "disjoint"):
        qh, qn = _sketches(rng, 20, 1000, 10**6, full=True)
        rh = qh if case == "identical" else qh ^ np.uint64(1)
        if case == "disjoint":
            rh = np.sort(rh, axis=1)
        return qh, qn, rh, qn.copy(), 1000
    if case == "empty_rows":
        qh, qn = _sketches(rng, 12, 300, 900)
        rh, rn = _sketches(rng, 19, 300, 900)
        qh[::3], qn[::3] = EMPTY, 0
        rh[1::2], rn[1::2] = EMPTY, 0
        return qh, qn, rh, rn, 300
    if case == "stream_tile":  # 1024 real reference rows padded to 4096
        qh, qn = _sketches(rng, 512, 1000, 3000)
        rh, rn = _sketches(rng, 1024, 1000, 3000)
        rh = np.concatenate([rh, np.full((3072, 1000), EMPTY)])
        return qh, qn, rh, np.concatenate([rn, np.zeros(3072, np.int32)]), \
            1000
    if case == "tall_grid":
        n = 600_000
        qh = (rng.integers(0, 3, (n, 1)).astype(np.uint64)
              * np.uint64(0x9E3779B97F4A7C15))
        qn = (rng.random(n) < 0.9).astype(np.int32)
        qh[qn == 0] = EMPTY
        rh = np.array([[0], [0x9E3779B97F4A7C15]], np.uint64)
        return qh, qn, rh, np.ones(2, np.int32), 1
    raise ValueError(case)


# the widest rows of the thread route's tile (pairwise_kernel's docstring)
THREAD_MAX_W = {8: 599, 4: 1199}


@pytest.mark.parametrize("route", ["auto", "warp", "thread"])
@pytest.mark.parametrize("case", PAIR_CASES)
def test_pairwise_matches_plain(gpu, case, route):
    qh, qn, rh, rn, cap = _pair_case(case)
    Q, NQ, R, NR = (_t(a, gpu) for a in (qh, qn, rh, rn))
    want = td.pairwise_common_denom(Q, NQ, R, NR, cap=cap)
    kq, kr = td.rank_compress(Q, R)
    for name, fn, q, r in (("pairwise64", pk.pairwise64, Q, R),
                           ("pairwise32", pk.pairwise32, kq, kr)):
        before = pk.LAUNCHES[name]
        if route == "thread" and q.shape[1] > THREAD_MAX_W[q.element_size()]:
            with pytest.raises(RuntimeError):
                fn(q, NQ, r, NR, cap=cap, route=route)
            assert pk.LAUNCHES[name] == before
            continue
        got = fn(q, NQ, r, NR, cap=cap, route=route)
        torch.cuda.synchronize()
        assert pk.LAUNCHES[name] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "identical":
        assert bool((want[0].diagonal() == cap).all())


def test_pairwise32_on_32bit_hashes(gpu):
    """k <= 16 hashes, most rows ending in the real hash 0xFFFFFFFF: the
    CUDA route ranks them, so none reads as the 32-bit pad key."""
    rng = np.random.default_rng(1)
    qh, qn = _sketches(rng, 20, 300, 900, bits=32)
    rh, rn = _sketches(rng, 13, 300, 900, bits=32)
    for H, N in ((qh, qn), (rh, rn)):
        H[np.arange(len(N) - 1), N[:-1] - 1] = 0xFFFFFFFF
    Q, NQ, R, NR = (_t(a, gpu) for a in (qh, qn, rh, rn))
    want = td.pairwise_common_denom(Q, NQ, R, NR, cap=250)
    before = pk.LAUNCHES["pairwise32"]
    got = td.pairwise_common_denom_auto(Q, NQ, R, NR, cap=250, use64=False)
    assert pk.LAUNCHES["pairwise32"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    probe = _t(np.array([[5, 9, 0xFFFFFFFF], [5, 7, 0xFFFFFFFF]],
                        np.uint64), gpu)
    n = torch.full((2,), 3, dtype=torch.int32, device=gpu)
    c, d = td.pairwise_common_denom_auto(probe[:1], n[:1], probe[1:], n[1:],
                                         cap=10, use64=False)
    assert (int(c[0, 0]), int(d[0, 0])) == (2, 4)


@pytest.mark.parametrize("bits", [64, 32], ids=["64bit", "32bit"])
def test_stream_pair_stripes_cuda_matches_cpu(gpu, bits):
    """The streamed path ranks once per command on the card, for either
    hash width (32-bit rows ending in the real hash 0xFFFFFFFF), and
    launches ``pairwise32`` once a tile."""
    rng = np.random.default_rng(2 + (bits == 64))
    qh, qn = _sketches(rng, 40, 300, 900, bits=bits)
    rh, rn = _sketches(rng, 70, 300, 900, bits=bits)
    if bits == 32:
        qh[np.arange(40), qn - 1] = 0xFFFFFFFF
    out = {}
    before = pk.LAUNCHES["pairwise32"]
    for dev in ("cuda", "cpu"):
        out[dev] = np.concatenate([st for _, st in td.stream_pair_stripes(
            qh, qn, rh, rn, 250, dev, row_block=16, tile_r=32)])
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    assert pk.LAUNCHES["pairwise32"] == before + 3 * 3


def test_cli_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """``sketch`` and ``dist`` on the card print and write what the CPU's
    plain path does, for a small file and one that takes fast ingest."""
    from mash_tpu_torch.__main__ import main

    files = []
    for i, n in enumerate((30000, 45000, 4_300_000)):
        seq = _seq(i, b"ACGTACGTacgtN", n)
        path = tmp_path / ("g%d.fa" % i)
        path.write_bytes(b">g%d\n" % i + seq.tobytes() + b"\n")
        files.append(str(path))

    def run(device, argv):
        monkeypatch.setenv("MASH_TPU_TORCH_DEVICE", device)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        return out.getvalue()

    outs = {}
    before = (sk.LAUNCHES["sketch_select"], pk.LAUNCHES["pairwise64"])
    for device in ("cuda", "cpu"):
        msh = tmp_path / ("all_%s.msh" % device)
        run(device, ["sketch", "-o", str(msh), *files])
        outs[device] = (msh.read_bytes(),
                        run(device, ["dist", str(msh), str(msh)]))
    assert outs["cuda"] == outs["cpu"]
    assert sk.LAUNCHES["sketch_select"] > before[0]
    assert pk.LAUNCHES["pairwise64"] > before[1]


SCREEN_CASES = ["random", "empty_batch", "all_empty", "tiny_db", "db_sentinel",
                "saturation", "skewed", "one_hash", "bits32", "big_db"]


def _screen_case(case):
    """(hashes [4, n] in any order, validity, DB [H] sorted and distinct,
    int64 totals [H]) for one edge of ``screen_count``."""
    rng = np.random.default_rng(SCREEN_CASES.index(case))
    n = 0 if case == "empty_batch" else 40000
    H = {"tiny_db": 1, "big_db": 300_000}.get(case, 5000)
    hi = 2**32 if case == "bits32" else 2**64 - 1
    if case == "skewed":  # every hash inside a tiny DB range
        db = np.unique(rng.integers(0, 1000, 2000)).astype(np.uint64)
        b = rng.integers(0, 1000, n).astype(np.uint64)
    else:
        db = np.unique(rng.integers(0, hi, H + 64, dtype=np.uint64))[:H]
        if case == "db_sentinel":
            db = np.unique(np.concatenate([db, [EMPTY]]))
        b = rng.integers(0, hi, n, dtype=np.uint64)
        b[: n // 4] = db[rng.integers(0, len(db), n // 4)]
        b[n // 4 : n // 4 + 500] = EMPTY
        if case == "one_hash":
            b[:] = db[len(db) // 2]
        rng.shuffle(b)
    v = rng.random(n) < 0.9
    if case == "all_empty":
        v[:] = False
    c = rng.integers(0, 100, len(db))
    if case == "saturation":
        c[:8] = 2**32 - rng.integers(1, 4, 8)
    return b.reshape(4, -1), v.reshape(4, -1), db, c


@pytest.mark.parametrize("case", SCREEN_CASES)
def test_screen_count_matches_plain(gpu, case):
    b, v, db, c = _screen_case(case)
    h, valid, dbt = _t(b, gpu), torch.from_numpy(v).to(gpu), _t(db, gpu)
    got = torch.from_numpy(c).to(gpu)
    want = got.clone()
    before = dict(sck.LAUNCHES)
    table = sck.build_table(dbt)
    sck.screen_count(h, valid, table, got)
    plain = sck.build_table_plain(dbt)
    sck.screen_count_plain(h, valid, plain, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    occ, by_index = sck.table_contents(table)
    occ_p, by_index_p = sck.table_contents(plain)
    assert torch.equal(occ, occ_p) and torch.equal(by_index, by_index_p)
    assert torch.equal(by_index, dbt)
    assert sck.LAUNCHES["screen_table"] == before["screen_table"] + 1
    # no launch when there is nothing to count
    assert sck.LAUNCHES["screen_count"] == before["screen_count"] + (
        b.size > 0)
    if case == "saturation":
        assert int(got[:8].min()) >= 2**32 - 3
    if case == "db_sentinel":
        assert int(got[-1]) == int(c[-1])  # left for the caller
    if case == "one_hash":
        assert int(got[len(db) // 2] - c[len(db) // 2]) == int(v.sum())


def _random_i64(n, g, dev):
    hi = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    lo = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    return (hi << 32) | lo


def test_screen_count_batch_over_2gib(gpu):
    """A batch of more than 2^31 bytes: the C entry takes int64 sizes."""
    n = (1 << 28) + 4099
    free, _total = torch.cuda.mem_get_info(gpu)
    if free < 16 * 8 * n:
        pytest.skip("needs about 35 GB of free device memory")
    g = torch.Generator(device=gpu).manual_seed(3)
    db = biased(torch.unique(biased(_random_i64(1 << 20, g, gpu))))
    h = _random_i64(n, g, gpu)
    pick = torch.randint(0, db.numel(), (n // 4,), generator=g, device=gpu)
    h[: n // 4] = db[pick]
    v = torch.ones(n, dtype=torch.bool, device=gpu)
    table = sck.build_table(db)
    got = torch.zeros(db.numel(), dtype=torch.int64, device=gpu)
    want = got.clone()
    before = sck.LAUNCHES["screen_count"]
    sck.screen_count(h, v, table, got)
    sck.screen_count_plain(h, v, table, want)
    torch.cuda.synchronize()
    assert sck.LAUNCHES["screen_count"] == before + 1
    assert torch.equal(got, want)
    assert int(got.sum()) >= n // 4


def test_screen_counter_cuda_matches_cpu(gpu):
    """The whole counter (table, kernel, EMPTY-valued DB hash, seeded
    totals that wrap at 2^32) over chunks of uneven lengths."""
    rng = np.random.default_rng(11)
    db = np.unique(np.concatenate(
        [rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64), [EMPTY]]))
    seed = rng.integers(0, 100, len(db))
    seed[:50] = 2**32 - 1
    chunks = []
    for i in range(6):
        n = 5000 + 1000 * i
        h = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
        h[: n // 3] = db[rng.integers(0, len(db), n // 3)]
        h[n // 3 : n // 3 + 9] = EMPTY
        chunks.append((h, rng.random(n) < 0.9))
    out = {}
    before = sck.LAUNCHES["screen_count"]
    for dev in ("cpu", "cuda"):
        counter = so.ScreenCounter(_t(db, dev),
                                   torch.from_numpy(seed).to(dev))
        for h, v in chunks:
            counter.add(_t(h, dev), torch.from_numpy(v).to(dev))
        out[dev] = counter.finalize()
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    assert sck.LAUNCHES["screen_count"] == before + len(chunks)
    assert out["cpu"][-1] > seed[-1]  # the EMPTY-valued DB hash was counted


def test_screen_cli_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """``screen``, ``screen -w`` and ``taxscreen`` on the card print
    what the CPU's plain path does, through both ingest routes."""
    from mash_tpu_torch.__main__ import main

    files = []
    for i, n in enumerate((30000, 45000, 4_300_000)):
        seq = _seq(100 + i, b"ACGTACGTacgtN", n)
        path = tmp_path / ("g%d.fa" % i)
        path.write_bytes(b">g%d\n" % i + seq.tobytes() + b"\n")
        files.append(str(path))
    tax = tmp_path / "tax"
    tax.mkdir()
    (tax / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n561\t|\t1\t|\tgenus\t|\n"
        "562\t|\t561\t|\tspecies\t|\n563\t|\t561\t|\tspecies\t|\n")
    (tax / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "561\t|\tEscherichia\t|\t\t|\tscientific name\t|\n"
        "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n"
        "563\t|\tEscherichia other\t|\t\t|\tscientific name\t|\n")
    mapping = tmp_path / "map.txt"
    mapping.write_text("562\t%s\n563\t%s\n562\t%s\n" % tuple(files))

    def run(device, argv):
        monkeypatch.setenv("MASH_TPU_TORCH_DEVICE", device)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        return out.getvalue()

    db = str(tmp_path / "db.msh")
    run("cpu", ["sketch", "-o", db, *files])
    before = sck.LAUNCHES["screen_count"]
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = (
            run(device, ["screen", db, *files]),
            run(device, ["screen", "-w", db, files[0], files[1]]),
            run(device, ["taxscreen", "-t", str(tax), "-m", str(mapping),
                         db, files[1]]),
        )
    assert outs["cuda"] == outs["cpu"]
    assert sck.LAUNCHES["screen_count"] > before
    assert len(outs["cpu"][0].splitlines()) == 3


def _cli(monkeypatch, device, argv):
    from mash_tpu_torch.__main__ import main

    monkeypatch.setenv("MASH_TPU_TORCH_DEVICE", device)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


def test_individual_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """``sketch -i`` on the card writes the CPU's ``.msh`` bytes, for rows
    that run plain (the 4 and 16 KiB buckets), rows that take
    ``sketch_select`` with a certificate (64 and 256 KiB buckets, some
    mostly padding), and rows whose certificate fails and which are
    recomputed (a 64 KiB-bucket record of a few hundred distinct k-mers
    repeated, fewer than s, more than m a subrow)."""
    rng = np.random.default_rng(51)
    unit = _seq(1, b"ACGT", 300).tobytes()
    recs = [_seq(i, b"ACGTACGTacgtN", n).tobytes() for i, n in
            enumerate((3000, 15000, 17000, 60000, 66000, 100000, 250000))]
    recs += [unit * 70, unit * 60 + _seq(9, b"ACGT", 3000).tobytes()]
    recs += [_seq(20 + i, b"ACGT", int(n)).tobytes()
             for i, n in enumerate(rng.integers(16500, 65000, 20))]
    path = tmp_path / "multi.fa"
    path.write_bytes(b"".join(b">r%d rec\n%s\n" % (i, r)
                              for i, r in enumerate(recs)))
    before = sk.LAUNCHES["sketch_select"]
    msh = {}
    for device in ("cuda", "cpu"):
        prefix = str(tmp_path / device)
        _cli(monkeypatch, device, ["sketch", "-i", "-o", prefix, str(path)])
        msh[device] = open(prefix + ".msh", "rb").read()
    assert msh["cuda"] == msh["cpu"]
    # two launches of 16 rows in the 64 KiB bucket, one in 256 KiB
    assert sk.LAUNCHES["sketch_select"] == before + 3


def test_reads_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """``sketch -r`` (the ingest route, over the 4 MiB gate: it launches
    ``sketch_select``) and ``sketch -r -m 2`` (hashes on the card, the
    native heap) write the CPU's ``.msh`` bytes and stderr."""
    genome = _seq(3, b"ACGT", 200000)
    rng = np.random.default_rng(4)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    path = tmp_path / "reads.fq"
    with open(path, "wb") as f:
        for i in range(14000):
            p = int(rng.integers(0, genome.size - 150))
            read = genome[p : p + 150].copy()
            hit = rng.random(150) < 0.01
            read[hit] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, int(hit.sum()))]
            raw = read.tobytes()
            raw = raw.translate(comp)[::-1] if i % 2 else raw
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, raw, b"I" * 150))
    assert path.stat().st_size > 4 << 20
    for opts in (["-r"], ["-r", "-m", "2"]):
        before = sk.LAUNCHES["sketch_select"]
        got = {}
        for device in ("cuda", "cpu"):
            prefix = str(tmp_path / device)
            _, err = _cli(monkeypatch, device,
                          ["sketch", *opts, "-o", prefix, str(path)])
            got[device] = (open(prefix + ".msh", "rb").read(),
                           err.replace(prefix, "OUT"))
        assert got["cuda"] == got["cpu"], opts
        assert (sk.LAUNCHES["sketch_select"] > before) == (len(opts) == 1)


@pytest.mark.parametrize("full", [False, True], ids=["partial", "full"])
def test_triangle_stripes_cuda_matches_cpu(gpu, full):
    """``stream_pair_stripes(triangle=True)`` on the card: one ranked
    upload serves both sides, each stripe's last tile is cut short, and
    each tile is one ``pairwise32`` launch."""
    rng = np.random.default_rng(8 + full)
    H, N = _sketches(rng, 150, 400, 1200, full=full)
    out = {}
    before = pk.LAUNCHES["pairwise32"]
    for dev in ("cuda", "cpu"):
        out[dev] = [(i0, st) for i0, st in td.stream_pair_stripes(
            H, N, H, N, 400, dev, row_block=32, tile_r=48, triangle=True)]
    assert [i0 for i0, _ in out["cuda"]] == list(range(0, 150, 32))
    for (i0, a), (j0, b) in zip(out["cuda"], out["cpu"]):
        assert i0 == j0 and a.shape == b.shape == (min(32, 150 - i0),
                                                   i0 + min(32, 150 - i0) - 1)
        np.testing.assert_array_equal(a, b)
    # stripes at 0, 32, ..., 128 need ceil((i0 + rows - 1) / 48) tiles
    tiles = sum(-(-(i0 + min(32, 150 - i0) - 1) // 48)
                for i0 in range(0, 150, 32))
    assert pk.LAUNCHES["pairwise32"] == before + tiles


def test_streamed_triangle_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """The streamed ``triangle`` on the card prints the CPU's stdout and
    stderr, in PHYLIP and as an edge list."""
    import mash_tpu_torch.commands.triangle as tri
    from mash_tpu_torch.core.sketch import SketchRef
    from mash_tpu_torch.io import capnp_msh

    rng = np.random.default_rng(12)
    H, N = _sketches(rng, 300, 1000, 3000)
    refs = [SketchRef(name="s%03d" % i, comment="", length=5_000_000,
                      hashes=H[i, : N[i]]) for i in range(300)]
    msh = str(tmp_path / "t.msh")
    capnp_msh.write_msh(msh, default_nucleotide_params(21, 1000, 42), refs)
    monkeypatch.setattr(tri, "STREAM_MIN_SKETCHES", 100)
    before = pk.LAUNCHES["pairwise32"]
    for opts in ([], ["-E", "-d", "0.2"]):
        outs = [_cli(monkeypatch, dev, ["triangle", *opts, msh])
                for dev in ("cuda", "cpu")]
        assert outs[0] == outs[1], opts
        assert outs[0][0].strip()
    assert pk.LAUNCHES["pairwise32"] > before


CONTAIN_CASES = ["unequal", "empty_rows", "nq_gt_nr", "k15_max", "wide"]


def _contain_case(case):
    """(ref, nr, qry, nq) numpy rows of one edge of the containment walk:
    unequal sizes, zero-size rows, queries larger than their references,
    32-bit hashes with a real 0xFFFFFFFF in most rows, and the 4096 x 64
    shape of ``within`` of plasmid sketches against genomes."""
    rng = np.random.default_rng(70 + CONTAIN_CASES.index(case))
    if case == "wide":
        rh, rn = _sketches(rng, 64, 1000, 40000, full=True)
        qh, qn = _sketches(rng, 4096, 1000, 40000)
        return rh, rn, qh, qn
    if case == "k15_max":
        rh, rn = _sketches(rng, 40, 300, 700, bits=32)
        qh, qn = _sketches(rng, 50, 300, 700, bits=32)
        for h, n in ((rh, rn), (qh, qn)):
            for i in range(0, len(n), 3):
                row = np.unique(np.append(h[i, : n[i] - 1], 0xFFFFFFFF))
                h[i], n[i] = EMPTY, row.size
                h[i, : row.size] = row
        return rh, rn, qh, qn
    rh, rn = _sketches(rng, 40, 200, 500)
    qh, qn = _sketches(rng, 50, 200, 500)
    if case == "empty_rows":
        rh[1::4], rn[1::4] = EMPTY, 0
        qh[::5], qn[::5] = EMPTY, 0
    elif case == "nq_gt_nr":
        rn[:] = np.minimum(rn, 40)
        for i in range(len(rn)):
            rh[i, rn[i]:] = EMPTY
    return rh, rn, qh, qn


@pytest.mark.parametrize("case", CONTAIN_CASES)
def test_pairwise_containment_cuda_matches_cpu(gpu, case):
    """``pairwise_containment`` (plain torch on either device) gives the
    card's and the CPU's (common, consumed) alike; the wide case runs in
    chunks of queries."""
    rh, rn, qh, qn = _contain_case(case)
    got = {}
    for dev in ("cuda", "cpu"):
        got[dev] = [a.cpu() for a in td.pairwise_containment(
            _t(rh, dev), _t(rn, dev), _t(qh, dev), _t(qn, dev),
            max_elems=1 << 22)]
    assert all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
    assert int(got["cpu"][0].sum()) > 0


@pytest.mark.parametrize("k", [21, 15])
def test_windowed_positions_cuda_matches_cpu(gpu, k):
    """Minmers of a 2.5-chunk sequence (hashed in three pieces) with
    lowercase bytes and N: the card's hashes give the CPU's loci."""
    from mash_tpu_torch.core.engine import DEFAULT_CHUNK, SketchEngine

    seq = _seq(k, b"ACGTACGTacgN", int(2.5 * DEFAULT_CHUNK)).tobytes()
    params = default_nucleotide_params(k, 100, 42)
    params.window_size = 10000
    got = [SketchEngine(params, device=dev).windowed_positions(seq)
           for dev in ("cuda", "cpu")]
    assert len(got[0][0]) > 1000
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)


def test_within_find_cuda_match_cpu(gpu, tmp_path, monkeypatch):
    """``within`` (a FASTA reference sketched by ``sketch_select``, and
    sketches against sketches) and ``find`` (against the FASTA and a
    ``sketch -W`` .msw) on the card print what they print on the CPU."""
    genome = _seq(31, b"ACGT", 300000)
    genome[100000:110000] += 32
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">g0 genome\n" + genome.tobytes() + b"\n")
    frags = tmp_path / "frags.fa"
    rng = np.random.default_rng(32)
    with open(frags, "wb") as f:
        for i in range(8):
            p = int(rng.integers(0, genome.size - 10000))
            frag = genome[p : p + 10000].tobytes().upper()
            f.write(b">f%d\n%s\n" % (i, frag.translate(comp)[::-1]
                                     if i % 2 else frag))
    before = sk.LAUNCHES["sketch_select"]
    outs = {}
    for dev in ("cuda", "cpu"):
        msw = str(tmp_path / ("ref_%s.msw" % dev))
        msh = str(tmp_path / ("frags_%s" % dev))
        outs[dev] = [
            _cli(monkeypatch, dev, ["within", "-s", "10000", str(ref),
                                    str(frags)]),
            _cli(monkeypatch, dev, ["sketch", "-i", "-o", msh, str(frags)]),
            _cli(monkeypatch, dev, ["within", "-e", "1", msh + ".msh",
                                    msh + ".msh"]),
            _cli(monkeypatch, dev, ["find", str(ref), str(frags)]),
            _cli(monkeypatch, dev, ["sketch", "-W", "-s", "100", "-o", msw,
                                    str(ref)]),
            _cli(monkeypatch, dev, ["find", "-b", "1", msw, str(frags)]),
            open(msw, "rb").read(),
        ]
        # the output files' names in stderr ("Writing to ...")
        outs[dev] = [o if isinstance(o, bytes) else
                     (o[0], o[1].replace("_%s." % dev, "_DEV."))
                     for o in outs[dev]]
    assert outs["cuda"] == outs["cpu"]
    assert sk.LAUNCHES["sketch_select"] > before
    assert len(outs["cpu"][5][0].splitlines()) == 8


# -- the mesh over one card twice, and two ranks on one card ----------------

def _mesh2(gpu):
    return [torch.device("cuda", 0)] * 2


def test_mesh_sketch_cuda_matches_one_device(gpu):
    """``sharded_sketch_chunks`` over ``[cuda:0, cuda:0]`` (K1 a half)
    equals the one-device fold, raw and packed rows alike."""
    from mash_tpu_torch.ops import sketch_ops
    from mash_tpu_torch.ops.kmers import unpack_chunks
    from mash_tpu_torch.parallel import mesh

    params = default_nucleotide_params(21, 1000, 42)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    rows = torch.from_numpy(_seq(80, b"ACGTacgtN", (8, 1 << 18))).to(gpu)
    before = sk.LAUNCHES["sketch_select"]
    got = mesh.sharded_sketch_chunks(_mesh2(gpu), params, rows, 1000)
    assert sk.LAUNCHES["sketch_select"] == before + 2
    want = sketch_ops.tree_merge(*sk.sketch_chunks_fused(rows, **kw, s=1000),
                                 s=1000)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # packed rows (2-bit codes + mask), unpacked on each device
    L = 1 << 16
    packed = torch.from_numpy(_seq(81, bytes(range(256)), (4, L // 4 + L // 8))
                              ).to(gpu)
    got = mesh.sharded_sketch_chunks(_mesh2(gpu), params, packed, 1000,
                                     chunk_len=L)
    want = sketch_ops.tree_merge(*sk.sketch_chunks_fused(
        unpack_chunks(packed, L), **kw, s=1000), s=1000)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [48, 600], ids=["pairwise64", "ranked"])
def test_mesh_pairwise_cuda_matches_one_device(gpu, n):
    """``sharded_pairwise`` over ``[cuda:0, cuda:0]`` equals the one-device
    route: K2 under 65 536 pairs a half, rank keys and K3 above."""
    from mash_tpu_torch.parallel import mesh

    rng = np.random.default_rng(n)
    H, N = _sketches(rng, n, 1000, 3000)
    Ht, Nt = _t(H, gpu), _t(N, gpu)
    kernel = "pairwise64" if n == 48 else "pairwise32"
    before = pk.LAUNCHES[kernel]
    got = mesh.sharded_pairwise(_mesh2(gpu), Ht, Nt, Ht, Nt, 1000)
    assert pk.LAUNCHES[kernel] == before + 2
    want = td.pairwise_common_denom_auto(Ht, Nt, Ht, Nt, cap=1000)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mesh_screen_cuda_matches_one_device(gpu):
    """``sharded_screen_counts`` over ``[cuda:0, cuda:0]`` (one K4 table a
    DB range) gives the one-device fold's counts and cardinality state."""
    from mash_tpu_torch.ops import sketch_ops
    from mash_tpu_torch.ops.kmers import hash_chunk
    from mash_tpu_torch.parallel import mesh

    params = default_nucleotide_params(21, 1000, 42)
    rows = torch.from_numpy(_seq(82, b"ACGTN", (4, 1 << 18))).to(gpu)
    h, v = hash_chunk(rows, alphabet=DNA, k=21, seed=42, use64=True,
                      noncanonical=False, preserve_case=False)
    rng = np.random.default_rng(83)
    sampled = np.unique(h[v].cpu().numpy().view(np.uint64)[::50])
    db = np.unique(np.concatenate([
        sampled,
        rng.integers(0, 2**63, 20000, dtype=np.int64).astype(np.uint64)]))
    before = sck.LAUNCHES["screen_table"]
    counts, state = mesh.sharded_screen_counts(_mesh2(gpu), params, db,
                                               [rows], 1000)
    assert sck.LAUNCHES["screen_table"] == before + 2
    _f, fold_rows, c0, finalize = so.make_screen_fold(params, db, 1000,
                                                      "cuda:0")
    c0, want = fold_rows(c0, sketch_ops.empty_state(1000, gpu), rows)
    np.testing.assert_array_equal(counts, finalize(c0))
    assert all(torch.equal(a, b) for a, b in zip(state, want))
    assert (counts[np.searchsorted(db, sampled)] > 0).all()


def _read_rows(rng, genome, n_rows, width, fill=1.0):
    """``n_rows`` rows of 150 bp reads of ``genome``, a 0x00 after each,
    the last row filled to ``fill`` of its width and 0x00 after."""
    n = -(-n_rows * width // 151)
    at = rng.integers(0, len(genome) - 150, n)
    reads = np.zeros((n, 151), np.uint8)
    reads[:, :150] = genome[at[:, None] + np.arange(150)]
    rows = reads.reshape(-1)[: n_rows * width].reshape(n_rows, width).copy()
    rows[-1, int(fill * width) :] = 0
    return rows


def test_screen_fold_rows_k1_cuda_matches_cpu(gpu, monkeypatch):
    """``make_screen_fold``'s ``fold_rows`` on the card (K5 and K4 count,
    K1 and K6's candidate fold the cardinality state) against the same
    fold on the CPU: a [32, 1 MiB] batch of reads whose last row is 76 %
    full, then a batch with a row of a tandem repeat, which lacks K1's
    certificate; the second alone, then both in turn.  One K1 launch a batch,
    and the rows recomputed are those the CPU run finds uncertified."""
    from mash_tpu_torch.ops import sketch_ops
    from mash_tpu_torch.ops.kmers import hash_chunk
    from mash_tpu_torch.utils import profiling

    params = default_nucleotide_params(21, 1000, 42)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    rng = np.random.default_rng(86)
    genome = _seq(87, b"ACGT", 5_000_000)
    big = _read_rows(rng, genome, 32, 1 << 20, fill=0.76)
    small = _read_rows(rng, genome, 4, 1 << 20)
    repeat = np.resize(_seq(88, b"ACGT", 171), 1 << 21)
    small[2] = _read_rows(rng, repeat, 1, 1 << 20)[0]
    h, v = hash_chunk(torch.from_numpy(big[:1]).to(gpu), **kw)
    db = np.unique(np.concatenate([
        np.unique(h[v].cpu().numpy().view(np.uint64))[::200],
        rng.integers(0, 2**63, 20000, dtype=np.int64).astype(np.uint64)]))
    bad = [int(sk.sketch_chunks_deferred(torch.from_numpy(b), **kw, s=1000)
               [2].mask.numpy().sum()) for b in (big, small)]
    assert bad[1] >= 1

    def run(device, batches):
        _f, fold_rows, c0, finalize = so.make_screen_fold(params, db, 1000,
                                                          device)
        state = sketch_ops.empty_state(1000, device)
        for b in batches:
            c0, state = fold_rows(c0, state, torch.from_numpy(b).to(device))
        h, c = state
        return finalize(c0), h.cpu(), c.cpu()

    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    for which in ([small], [big, small]):
        want = run("cpu", which)
        profiling.pop_records()
        before = sk.LAUNCHES["sketch_select"]
        got = run(gpu, which)
        _spans, counts = profiling.pop_records()
        totals = profiling.counter_totals(counts)
        assert sk.LAUNCHES["sketch_select"] == before + len(which)
        assert totals["sketch:rows_folded"] == sum(len(b) for b in which)
        assert totals.get("sketch:rows_recomputed", 0) == sum(
            bad[0 if b is big else 1] for b in which)
        np.testing.assert_array_equal(got[0], want[0])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert got[0].sum() > 0 and int((got[2] > 0).sum()) == 1000


def test_two_ranks_screen_triangle_on_one_card(gpu, tmp_path, monkeypatch):
    """Two gloo ranks on ``cuda:0`` (``tests/torch_multihost_worker.py``):
    ``screen`` counts summed with rank 0 alone printing the one-process
    report, and the streamed ``triangle``'s stripes (512 rows, alternate
    ranks) concatenating to the one-process output."""
    import json
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    import mash_tpu_torch.commands.triangle as tri
    from mash_tpu_torch.core.sketch import SketchRef
    from mash_tpu_torch.io import capnp_msh

    rng = np.random.default_rng(90)
    n = 1100  # 3 stripes of 512
    H, N = _sketches(rng, n, 64, 400)
    refs = [SketchRef(name="s%04d" % i, comment="", length=10**6,
                      hashes=H[i, : N[i]]) for i in range(n)]
    refs_msh = str(tmp_path / "refs.msh")
    capnp_msh.write_msh(refs_msh, default_nucleotide_params(21, 64, 42), refs)
    reads = []
    for i in range(4):
        p = tmp_path / ("m%d.fa" % i)
        p.write_bytes(b"".join(b">r%d_%d\n%s\n" % (i, j, _seq(
            100 * i + j, b"ACGT", 2000).tobytes()) for j in range(20)))
        reads.append(str(p))
    db = str(tmp_path / "db.msh")
    _cli(monkeypatch, "cpu", ["sketch", "-s", "200", "-o", db] + reads[:3])
    monkeypatch.setattr(tri, "STREAM_MIN_SKETCHES", 0)
    single = {"triangle": _cli(monkeypatch, "cuda", ["triangle", refs_msh]),
              "screen": _cli(monkeypatch, "cuda", ["screen", db] + reads)}

    outdir = tmp_path / "out"
    outdir.mkdir()
    cfg = tmp_path / "cfg.json"
    root = pathlib.Path(__file__).resolve().parent
    cfg.write_text(json.dumps(dict(
        repo=str(root.parent), outdir=str(outdir), refs_msh=refs_msh,
        screen_db=db, read_files=reads, only=["triangle", "screen"])))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, MASH_TPU_TORCH_DEVICE="cuda",
                       MASH_TPU_TORCH_COORDINATOR="127.0.0.1:%d" % port,
                       MASH_TPU_TORCH_NUM_PROCESSES="2",
                       MASH_TPU_TORCH_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, str(root / "torch_multihost_worker.py"),
                 str(cfg)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]

    def rank_out(rank, name, ext=".out"):
        return (outdir / ("rank%d_%s%s" % (rank, name, ext))).read_text()

    assert rank_out(0, "screen") == single["screen"][0]
    assert single["screen"][0].strip() and rank_out(1, "screen") == ""
    lines = single["triangle"][0].splitlines(keepends=True)
    # the header line, then row i on line i + 1: stripe 0 (rows 0-511)
    # and stripe 2 (1024-1099) are rank 0's, stripe 1 (512-1023) rank 1's
    want = ["".join(lines[:513]) + "".join(lines[1025:]),
            "".join(lines[513:1025])]
    assert [rank_out(r, "triangle") for r in (0, 1)] == want
    assert "Max p-value" in rank_out(0, "triangle", ".err")
    assert "Max p-value" not in rank_out(1, "triangle", ".err")


# -- asynchronous dispatch ---------------------------------------------------

def _failing_rows(seed, n_rows, width=20 * 1024):
    """Random DNA rows (mixed case); row 1 a short tail (one subrow of
    valid windows) and row 3 a repeated motif, which fail the certificate
    at s = 1300 (m = 1024)."""
    rows = _seq(seed, b"ACGTacgt", (n_rows, width))
    rows[1, 2048 + 20 :] = 0
    rows[3] = np.resize(_seq(seed + 1, b"ACGT", 37), width)
    return np.ascontiguousarray(rows)


def _engine(device, s=1300, chunk_len=None):
    from mash_tpu_torch.core.engine import SketchEngine

    params = default_nucleotide_params(21, s, 42)
    if chunk_len is None:
        return SketchEngine(params, device=device)
    return SketchEngine(params, device=device, chunk_len=chunk_len)


def test_uploader_ring_reuse_under_load(gpu):
    """Uploads through a two-slot ring behind slow kernels: every slot is
    rewritten while earlier copies still wait in the stream, and the
    source array is rewritten after each upload; no batch is corrupted."""
    from mash_tpu_torch.utils.transfer import Uploader

    rng = np.random.default_rng(90)
    up = Uploader(gpu, slots=2)
    src = np.empty((4, 1 << 16), np.uint8)
    sent, got = [], []
    for i in range(48):
        torch.cuda._sleep(1_000_000)  # about half a millisecond
        src[:] = rng.integers(0, 256, src.shape, dtype=np.uint8)
        rows = 1 + i % 4  # the slots see batches of every size
        sent.append(src[:rows].copy())
        got.append(up.upload(src[:rows]))
        src[:] = 0  # the caller reuses its buffer at once
    torch.cuda.synchronize()
    for a, t in zip(sent, got):
        np.testing.assert_array_equal(t.cpu().numpy(), a)
    assert up.pinned_bytes() <= 2 * 4 << 16


def _upload_counts(profiling) -> dict:
    _spans, counts = profiling.pop_records()
    totals = profiling.counter_totals(counts)
    return {route: totals.get("transfer:%s_bytes" % route, 0)
            for route in ("direct", "staged")}


def _ingest(tmp_path, seed, n, chunk_len, rows, pack_mode):
    """The ingest pipeline's batches of one FASTA record of ``n`` bases."""
    from mash_tpu_torch.io.ingest import IngestPipeline, ingest_available

    if not ingest_available():
        pytest.skip("native ingest library unavailable")
    path = tmp_path / ("g%d.fa" % seed)
    seq = _seq(seed, b"ACGTacgtN", n).tobytes()
    with open(path, "wb") as f:
        f.write(b">g\n")
        f.write(b"\n".join(seq[i : i + 80] for i in range(0, n, 80)))
        f.write(b"\n")
    return IngestPipeline([str(path)], 21, chunk_len, rows,
                          pack_mode=pack_mode)


@pytest.mark.parametrize("pack_mode", [0, 1], ids=["raw", "packed"])
def test_ingest_batches_go_up_direct(gpu, tmp_path, monkeypatch, pack_mode):
    """Batches of a real ``IngestPipeline`` live in pinned memory and go
    up as they are: ``transfer:direct_bytes`` counts every byte of them,
    ``transfer:staged_bytes`` none, and they arrive byte-equal."""
    from mash_tpu_torch.utils import profiling
    from mash_tpu_torch.utils.transfer import Uploader

    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    profiling.pop_records()
    pipe = _ingest(tmp_path, 93, 3_000_000, 1 << 16, 8, pack_mode)
    up = Uploader(gpu)
    sent, got = [], []
    try:
        for batch in pipe.batches():
            assert torch.from_numpy(batch).is_pinned()
            sent.append(batch.copy())
            got.append(up.upload(batch))
    finally:
        pipe.close()
    torch.cuda.synchronize()
    assert len(sent) > 3 and sent[-1].shape[0] < 8
    assert _upload_counts(profiling) == {
        "direct": sum(a.nbytes for a in sent), "staged": 0}
    assert up.pinned_bytes() == 0
    for a, t in zip(sent, got):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_dropped_pinned_batches_stay_whole_in_flight(gpu, tmp_path):
    """The holder drops each pinned batch as soon as its upload returns,
    while the ingest thread keeps allocating and filling new pinned
    batches from torch's caching host allocator and each copy waits in
    the stream behind a slow kernel: every device tensor still equals
    the bytes of its own batch."""
    from mash_tpu_torch.utils.transfer import Uploader

    pipe = _ingest(tmp_path, 94, 16_000_000, 1 << 16, 4, 0)
    up = Uploader(gpu)
    sent, got = [], []
    try:
        for batch in pipe.batches():
            sent.append(batch.copy())
            torch.cuda._sleep(1_000_000)  # about half a millisecond
            got.append(up.upload(batch))
            del batch
    finally:
        pipe.close()
    torch.cuda.synchronize()
    assert len(sent) > 32
    for a, t in zip(sent, got):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


@pytest.mark.parametrize("source", ["pageable", "read_only",
                                    "pinned_strided"])
def test_other_arrays_are_staged(gpu, monkeypatch, source):
    """A pageable array, a read-only one (``np.frombuffer``, as the
    record paths upload) and a strided view of pinned memory are copied
    into a slot first (``transfer:staged_bytes``), and arrive
    byte-equal."""
    from mash_tpu_torch.utils import profiling
    from mash_tpu_torch.utils.transfer import Uploader

    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    profiling.pop_records()
    arr = _seq(95, b"ACGTN", (8, 1 << 14))
    if source == "read_only":
        arr = np.frombuffer(arr.tobytes(), np.uint8).reshape(arr.shape)
    elif source == "pinned_strided":
        pinned = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
        pinned.numpy()[:] = arr
        arr = pinned.numpy()[:, ::2]
    up = Uploader(gpu)
    got = up.upload(arr)
    torch.cuda.synchronize()
    assert _upload_counts(profiling) == {"direct": 0, "staged": arr.nbytes}
    np.testing.assert_array_equal(got.cpu().numpy(), arr)


def test_readback_waits_for_its_copy(gpu):
    from mash_tpu_torch.utils.transfer import Readback

    x = torch.arange(1 << 20, dtype=torch.int64, device=gpu)
    torch.cuda._sleep(5_000_000)
    back = Readback(x * 3)
    torch.cuda._sleep(50_000_000)  # work after the copy is not waited on
    np.testing.assert_array_equal(back.numpy(),
                                  np.arange(1 << 20, dtype=np.int64) * 3)


def test_deferred_certificate_planted_rows(gpu):
    """The kernel's route leaves the planted rows empty and marks them;
    settled, the states equal the CPU's plain path."""
    rows = torch.from_numpy(_failing_rows(91, 6))
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False, s=1300)
    before = sk.LAUNCHES["sketch_select"]
    H, C, pending = sk.sketch_chunks_deferred(rows.to(gpu), **kw)
    assert sk.LAUNCHES["sketch_select"] == before + 1
    bad = pending.mask.numpy()
    assert bad.tolist() == [False, True, False, True, False, False]
    assert int(C[torch.from_numpy(bad).to(gpu)].sum()) == 0
    sel, h, c = pending.states()
    H[sel], C[sel] = h, c
    want = sk.sketch_chunks_plain(rows, **kw)
    assert torch.equal(H.cpu(), want[0]) and torch.equal(C.cpu(), want[1])
    fused = sk.sketch_chunks_fused(rows.to(gpu), **kw)
    assert torch.equal(fused[0].cpu(), want[0])


@pytest.mark.parametrize("mesh2", [False, True], ids=["one", "mesh2"])
def test_fold_batches_cuda_matches_cpu(gpu, mesh2):
    """``fold_batches`` on the card (and sharded over ``[cuda:0,
    cuda:0]``) with failing rows in several batches, one of them the
    last, settled at ``state_to_ref``, equals the CPU's fold."""
    from mash_tpu_torch.ops import sketch_ops

    rows = _failing_rows(92, 12)
    batches = [rows[i : i + 4] for i in range(0, 12, 4)]
    refs = {}
    for dev in ("cuda", "cpu"):
        eng = _engine(dev)
        if dev == "cuda" and mesh2:
            eng.devices = _mesh2(gpu)
        state = eng.fold_batches(eng.empty_state(), batches)
        if dev == "cuda":
            assert isinstance(state, sketch_ops.PendingState)
        refs[dev] = eng.state_to_ref(state)
    np.testing.assert_array_equal(refs["cuda"].hashes, refs["cpu"].hashes)
    np.testing.assert_array_equal(refs["cuda"].counts, refs["cpu"].counts)


def test_fold_batches_trimmed_equals_padded_cuda(gpu, tmp_path, monkeypatch):
    """A 4.2 Mbase genome in three records through the ingest pipeline
    (packed, 1 MiB rows, 32-row batches): its one batch of filled rows
    and the same batch padded back to 32 zero rows fold on the card
    (K1, K6, K5 for the rows without the certificate) to the same
    sketch, and ``sketch:rows_folded`` counts the rows of the batches
    given."""
    from mash_tpu_torch.core.engine import DEFAULT_CHUNK
    from mash_tpu_torch.io.ingest import IngestPipeline, ingest_available
    from mash_tpu_torch.utils import profiling

    if not ingest_available():
        pytest.skip("native ingest library unavailable")
    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    path = tmp_path / "genome.fa"
    with open(path, "wb") as f:
        for r, n in enumerate((2_500_000, 1_200_000, 500_000)):
            seq = _seq(98 + r, b"ACGT", n).tobytes()
            f.write(b">g%d\n" % r)
            f.write(b"\n".join(seq[i : i + 80] for i in range(0, n, 80)))
            f.write(b"\n")
    pipe = IngestPipeline([str(path)], 21, DEFAULT_CHUNK, 32, pack_mode=1)
    try:
        trimmed = list(pipe.batches())
    finally:
        pipe.close()
    assert [b.shape[0] for b in trimmed] == [5]
    padded = np.zeros((32, trimmed[0].shape[1]), np.uint8)
    padded[:5] = trimmed[0]
    refs, folded = [], []
    for batches in (trimmed, [padded]):
        profiling.pop_records()
        before = sk.LAUNCHES["sketch_select"]
        eng = _engine("cuda", s=1000)
        refs.append(eng.state_to_ref(eng.fold_batches(
            eng.empty_state(), batches, packed=True)))
        assert sk.LAUNCHES["sketch_select"] > before
        _spans, counts = profiling.pop_records()
        folded.append(profiling.counter_totals(counts)["sketch:rows_folded"])
    assert folded == [5, 32]
    assert len(refs[0].hashes) == 1000
    np.testing.assert_array_equal(refs[0].hashes, refs[1].hashes)
    np.testing.assert_array_equal(refs[0].counts, refs[1].counts)


def test_mesh_sketch_failing_rows_cuda_matches_cpu(gpu):
    """``sharded_sketch_chunks`` over ``[cuda:0, cuda:0]`` settles both
    devices' failing rows."""
    from mash_tpu_torch.ops import sketch_ops
    from mash_tpu_torch.parallel import mesh

    rows = _failing_rows(93, 8)
    params = default_nucleotide_params(21, 1300, 42)
    got = mesh.sharded_sketch_chunks(_mesh2(gpu), params,
                                     torch.from_numpy(rows).to(gpu), 1300)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False, s=1300)
    want = sketch_ops.tree_merge(
        *sk.sketch_chunks_plain(torch.from_numpy(rows), **kw), s=1300)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_exact_route_in_flight_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """The exact route with 1100-byte chunks (seven reads each, so many
    in flight): ``-r -m 2`` and ``-c 3`` (stopped mid-stream) write the
    CPU's ``.msh`` bytes and stderr."""
    import functools

    from mash_tpu_torch.core import engine as te
    from mash_tpu_torch.core import loader

    monkeypatch.setattr(loader, "SketchEngine",
                        functools.partial(te.SketchEngine, chunk_len=1100))
    genome = _seq(94, b"ACGT", 8000)
    rng = np.random.default_rng(95)
    path = tmp_path / "reads.fq"
    with open(path, "wb") as f:
        for i in range(300):
            p = int(rng.integers(0, genome.size - 150))
            f.write(b"@q%d\n%s\n+\n%s\n"
                    % (i, genome[p : p + 150].tobytes(), b"I" * 150))
    for opts in (["-r", "-m", "2"], ["-c", "3"]):
        got = {}
        for device in ("cuda", "cpu"):
            prefix = str(tmp_path / device)
            _, err = _cli(monkeypatch, device,
                          ["sketch", *opts, "-o", prefix, str(path)])
            got[device] = (open(prefix + ".msh", "rb").read(),
                           err.replace(prefix, "OUT"))
        assert got["cuda"] == got["cpu"], opts
    assert "Reads used" in got["cpu"][1]


@pytest.mark.parametrize("triangle", [False, True], ids=["rect", "triangle"])
def test_stripes_depth3_equals_depth1(gpu, triangle):
    rng = np.random.default_rng(96)
    qh, qn = _sketches(rng, 100, 300, 900)
    rh, rn = (qh, qn) if triangle else _sketches(rng, 70, 300, 900)
    out = {}
    for depth in (1, 3):
        out[depth] = [(i0, st) for i0, st in td.stream_pair_stripes(
            qh, qn, rh, rn, 250, "cuda", row_block=16, tile_r=32,
            triangle=triangle, depth=depth)]
    cpu = list(td.stream_pair_stripes(qh, qn, rh, rn, 250, "cpu",
                                      row_block=16, tile_r=32,
                                      triangle=triangle))
    for got in (out[3], cpu):
        assert [i0 for i0, _ in got] == [i0 for i0, _ in out[1]]
        for (_, a), (_, b) in zip(got, out[1]):
            np.testing.assert_array_equal(a, b)


@contextlib.contextmanager
def _no_sync(events):
    """Every synchronizing CUDA call raises (``set_sync_debug_mode``);
    ``Event.synchronize`` calls, the waits by design, are counted."""
    sync = torch.cuda.Event.synchronize

    def counted(self):
        events.append(1)
        return sync(self)

    torch.cuda.synchronize()
    torch.cuda.Event.synchronize = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.Event.synchronize = sync


def test_streaming_paths_make_no_host_read_per_batch(gpu):
    """Steady state of each streaming path under
    ``torch.cuda.set_sync_debug_mode("error")``: ``fold_batches`` (the
    mask read a batch behind, the ring's slot waits), the exact route's
    chunk in flight, the stripes at depth 3 and the screen fold.  The
    only waits are ``Event.synchronize`` calls, at most two a batch."""
    from mash_tpu_torch.core.engine import sketch_records_exact
    from mash_tpu_torch.io.fastx import Record
    from mash_tpu_torch.utils.transfer import Uploader

    rows = _failing_rows(97, 24)
    batches = [rows[i : i + 4] for i in range(0, 24, 4)]
    eng = _engine("cuda")
    eng.state_to_ref(eng.fold_batches(eng.empty_state(), batches[:2]))
    events = []
    with _no_sync(events):
        state = eng.fold_batches(eng.empty_state(), batches)
    assert len(events) <= 2 * len(batches)
    want = _engine("cpu")
    ref, cpu_ref = eng.state_to_ref(state), want.state_to_ref(
        want.fold_batches(want.empty_state(), batches))
    np.testing.assert_array_equal(ref.hashes, cpu_ref.hashes)

    # the exact route: a chunk a drain
    p = default_nucleotide_params(21, 1000, 42)
    p.reads, p.min_cov = True, 2
    seqs = [_seq(200 + i, b"ACGT", 150).tobytes() for i in range(400)]
    recs = [Record("r%d" % i, "", s) for i, s in enumerate(seqs)]
    exact = _engine_params(p, "cuda", 1100)
    sketch_records_exact(exact, recs[:20], "warm")
    events.clear()
    with _no_sync(events):
        got, _, count, _ = sketch_records_exact(exact, recs, "x")
    n_chunks = -(-len(recs) // 7)
    assert count == len(recs) and len(events) <= 3 * n_chunks
    cpu, _, _, _ = sketch_records_exact(_engine_params(p, "cpu", 1100),
                                        recs, "x")
    np.testing.assert_array_equal(got.hashes, cpu.hashes)

    # the stripes: after the first stripe (the set-up uploads and ranks)
    rng = np.random.default_rng(98)
    qh, qn = _sketches(rng, 160, 300, 900)
    it = td.stream_pair_stripes(qh, qn, qh, qn, 250, "cuda", row_block=16,
                                tile_r=32, triangle=True, depth=3)
    stripes = [next(it)]
    events.clear()
    with _no_sync(events):
        stripes += list(it)
    tiles = sum(-(-(i0 + 15) // 32) for i0 in range(0, 160, 16))
    assert len(events) <= tiles  # a wait a tile's copy
    assert [i0 for i0, _ in stripes] == list(range(0, 160, 16))

    # the screen fold over uploaded batches
    db = np.unique(np.random.default_rng(99).integers(
        0, 2**63, 5000, dtype=np.uint64))
    _, fold_rows, counts, finalize = so.make_screen_fold(
        p, db, 1000, device="cuda")
    from mash_tpu_torch.ops import sketch_ops

    state = sketch_ops.empty_state(1000, gpu)
    up = Uploader(gpu)
    screen_rows = _failing_rows(100, 24, width=40 * 1024)
    counts, state = fold_rows(counts, state, up.upload(screen_rows[:4]))
    events.clear()
    with _no_sync(events):
        for i in range(4, 24, 4):
            counts, state = fold_rows(counts, state,
                                      up.upload(screen_rows[i : i + 4]))
    assert len(events) <= 2 * 5
    finalize(counts)
    assert int((state[1] > 0).sum()) == 1000


def _engine_params(params, device, chunk_len):
    from mash_tpu_torch.core.engine import SketchEngine

    return SketchEngine(params, device=device, chunk_len=chunk_len)


# -- K6 fold_sorted --------------------------------------------------------

def _fold_rows(seed, B, G, W, *, empty=0.0, dup=0.0, realmax=0.0,
               zero=0.0, hi=2**64 - 1):
    """``(h, c)`` int64 ``[B, G * W]``: B rows of G segments of W entries,
    each segment sorted in unsigned order, from a seed.  ``empty``: a
    share of EMPTY / 0 entries; ``dup``: a share drawn from a pool of 64
    hashes that every segment shares; ``realmax``: a share of real
    2^64-1 hashes with a count above 0; ``zero``: a share of real hashes
    whose count is 0; ``hi``: the largest hash."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, hi, (B, G, W), dtype=np.uint64, endpoint=True)
    pool = rng.integers(0, hi, 64, dtype=np.uint64, endpoint=True)
    pick = rng.random(h.shape) < dup
    h[pick] = pool[rng.integers(0, 64, int(pick.sum()))]
    c = rng.integers(1, 4, h.shape).astype(np.int64)
    c[(rng.random(h.shape) < zero) & (h != EMPTY)] = 0
    gone = rng.random(h.shape) < empty
    h[gone], c[gone] = EMPTY, 0
    real = rng.random(h.shape) < realmax
    h[real], c[real] = EMPTY, 2
    order = np.argsort(h, axis=2, kind="stable")
    h = np.take_along_axis(h, order, 2).reshape(B, G * W)
    c = np.take_along_axis(c, order, 2).reshape(B, G * W)
    return torch.from_numpy(h.view(np.int64)), torch.from_numpy(c)


# name: (rows, segments, width, s, edges); the first six are the shapes
# of the paths (chip_smoke.py phase 3), the rest the kernel's edges
FOLD_CASES = {
    "sketch_merge": (1, 6, 1000, 1000, {"empty": 0.01}),
    "screen_merge": (1, 33, 1000, 1000, {"dup": 0.3}),
    "large_merge": (1, 33, 100_000, 100_000, {"empty": 0.001}),
    "recompute_tail": (1, 1, 1_048_556, 1000, {"empty": 0.99997}),
    "recompute_full": (1, 1, 1_048_556, 1000, {"empty": 0.01}),
    "dup_across": (4, 9, 300, 500, {"dup": 0.5}),
    "realmax": (3, 5, 200, 1200, {"realmax": 0.05, "empty": 0.2}),
    "realmax_cut": (3, 5, 200, 100, {"realmax": 0.05, "empty": 0.2}),
    "zero_counts": (3, 4, 128, 300, {"zero": 0.2, "empty": 0.1}),
    "all_empty": (3, 3, 1000, 1000, {"empty": 1.0}),
    "few_distinct": (3, 8, 40, 1000, {"dup": 0.9}),
    "s1": (5, 7, 33, 1, {"dup": 0.3}),
    "g1_runs": (4, 1, 50_000, 800, {"dup": 0.95, "empty": 0.02}),
    "odd_width": (3, 13, 77, 150, {"empty": 0.1}),
    "bits32": (3, 16, 512, 1000, {"hi": 2**32 - 1, "empty": 0.3}),
    "rows_70000": (70_000, 2, 8, 10, {"dup": 0.2, "empty": 0.2}),
    "width_0": (2, 1, 0, 5, {}),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_sorted_matches_plain(gpu, case):
    """K6 equals its twin bit for bit on the same CUDA tensors."""
    from mash_tpu_torch.ops import fold_kernel as fk

    B, G, W, s, edges = FOLD_CASES[case]
    h, c = (t.to(gpu) for t in _fold_rows(list(FOLD_CASES).index(case), B,
                                          G, W, **edges))
    before = fk.LAUNCHES["fold_sorted"]
    H, C = fk.fold_sorted(h, c, s, segments=G)
    assert fk.LAUNCHES["fold_sorted"] == before + 1
    want = fk.fold_sorted_plain(h, c, s, segments=G)
    torch.cuda.synchronize()
    assert torch.equal(H, want[0]) and torch.equal(C, want[1])


# K1's candidates at the paths' shapes: rows, bytes a row, s
CAND_CASES = {
    "sketch": (5, 1 << 20, 1000),
    "sketch_i_64k": (16, 1 << 16, 1000),
    "sketch_i_256k": (16, 1 << 18, 1000),
    "s5000": (5, 1 << 20, 5000),
}


@pytest.mark.parametrize("case", list(CAND_CASES))
def test_fold_candidates_matches_plain(gpu, case):
    """K6 with the certificate equals its twin on K1's candidates, states
    and ``bad`` mask, with rows of a few valid windows (which fail it)."""
    from mash_tpu_torch.ops import fold_kernel as fk

    rows, length, s = CAND_CASES[case]
    seq = _seq_rare(list(CAND_CASES).index(case) + 40, b"ACGTacgt", b"N",
                    (rows, length))
    seq[1, 3000:] = ord("N")  # a tail row: fewer valid windows than s
    x = torch.from_numpy(seq).to(gpu)
    m = sk.candidate_budget(s, sk.C, length - 20)
    cand, boundary, vcount = sk.sketch_select(
        x, alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
        preserve_case=False, m=m)
    before = fk.LAUNCHES["fold_sorted"]
    got = fk.fold_candidates(cand, boundary, vcount, rows, s)
    assert fk.LAUNCHES["fold_sorted"] == before + 1
    want = fk.fold_candidates_plain(cand, boundary, vcount, rows, s)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(want[2][1]) and not bool(want[2][0])


def test_fold_candidates_certificate_clauses(gpu):
    """Synthetic candidates whose rows pass by ``covered`` alone, by
    ``all_in`` alone, by both, and fail: one whose K1 dropped a valid
    2^64-1 (counted in vcount, absent from the candidates)."""
    from mash_tpu_torch.ops import fold_kernel as fk

    rng = np.random.default_rng(77)
    rows, R, m, s = 8, 12, 16, 40
    cand = np.sort(rng.integers(0, 2**63, (rows * R, m), dtype=np.uint64), 1)
    bound = cand[:, -1] + rng.integers(1, 2**40, rows * R, dtype=np.uint64)
    vcount = np.full(rows * R, m, np.int32)
    vcount[R : 2 * R] += 1  # row 1: covered alone
    bound[2 * R : 3 * R] = 1  # row 2: all_in alone
    bound[3 * R : 4 * R] = 1  # row 3: neither
    vcount[3 * R] += 3
    cand[4 * R, -3:] = EMPTY  # row 4: a dropped 2^64-1, few hashes
    vcount[4 * R] -= 2
    cand[4 * R + 1 : 5 * R] = EMPTY
    vcount[4 * R + 1 : 5 * R] = 0
    bound[4 * R : 5 * R] = EMPTY
    cand[5 * R : 6 * R, 3:] = EMPTY  # row 5: all captured, fewer than s
    vcount[5 * R : 6 * R] = 3
    t = [torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)
         .to(gpu) for a in (cand, bound, vcount)]
    got = fk.fold_candidates(*t, rows, s)
    want = fk.fold_candidates_plain(*t, rows, s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want[2].tolist() == [False, False, False, True, True, False,
                                False, False]


def test_fold_sorted_refusals_on_the_card(gpu):
    """A CUDA tensor launches K6 or raises: never the plain fold."""
    from mash_tpu_torch.ops import fold_kernel as fk

    h = torch.zeros((2, 8), dtype=torch.int64, device=gpu)
    before = fk.LAUNCHES["fold_sorted"]
    with pytest.raises(ValueError):
        fk.fold_sorted(h, h.cpu(), 4)
    with pytest.raises(ValueError):
        fk.fold_sorted(h[:, ::2], h[:, ::2], 4)
    with pytest.raises(ValueError):
        fk.fold_sorted(h.int(), h.int(), 4)
    assert fk.LAUNCHES["fold_sorted"] == before


def test_sketch_two_genomes_cuda_writes_cpu_msh(gpu, tmp_path, monkeypatch):
    """``sketch`` of two genomes on the card (K1, K6's candidate fold and
    merges, K6 for each file's tail row) writes the CPU's ``.msh``."""
    from mash_tpu_torch.__main__ import main
    from mash_tpu_torch.ops import fold_kernel as fk

    files = []
    for i in range(2):
        seq = _seq(300 + i, b"ACGTACGTACGTacgtN", 2_500_000 + 7919 * i)
        path = tmp_path / ("genome%d.fa" % i)
        path.write_bytes(b">genome%d\n" % i + seq.tobytes() + b"\n")
        files.append(str(path))
    got = {}
    before = fk.LAUNCHES["fold_sorted"]
    for device in ("cuda", "cpu"):
        monkeypatch.setenv("MASH_TPU_TORCH_DEVICE", device)
        msh = tmp_path / ("two_%s.msh" % device)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["sketch", "-o", str(msh), *files]) == 0
        got[device] = msh.read_bytes()
        if device == "cuda":
            assert fk.LAUNCHES["fold_sorted"] > before
    assert got["cuda"] == got["cpu"]
