"""mash_tpu_torch.ops.hash_kernel and the ``hash_chunk`` dispatcher on the
CPU.

``ops.kmers.hash_chunk`` sends a CUDA tensor to the window hash kernel
(``ops/csrc/hash_windows.cu``) and a CPU tensor to its plain twin,
``hash_chunk_plain``.  Here, without a card, the same numpy-seeded bytes
go through the dispatcher, the twin and ``mash_tpu.ops.kmers.hash_chunk``
on JAX-CPU: the twin's hashes and masks must equal the dispatcher's on
every window and JAX's on the valid ones (exact: they are integers).  The
wrapper's shape helper, its refusals, the dispatcher's routing, the
sketch kernel's twins and the build's staleness rule are checked around
the kernel; the kernel itself is held against the twin on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mash_tpu.core.engine import SketchEngine as JaxEngine
from mash_tpu.core.params import (
    ALPHABET_PROTEIN,
    SketchParams,
    default_nucleotide_params,
)
from mash_tpu.ops import kmers as jk
from mash_tpu_torch.core import engine as te
from mash_tpu_torch.core.params import (
    default_nucleotide_params as torch_params,
)
from mash_tpu_torch.ops import cuda_build, hash_kernel
from mash_tpu_torch.ops import kmers as tk
from mash_tpu_torch.ops import sketch_kernel as sk

DNA = jk.alphabet_bytes(default_nucleotide_params().alphabet)
# lowercase, N, other IUPAC letters, separators and bytes >= 0x80 (which the
# signed uppercase pass never shifts)
SYMBOLS = b"ACGTacgt"
RARE = b"NnRYz\x00\x80\xc8\xe1\xff"


def _protein_alpha():
    p = SketchParams()
    p.set_alphabet(ALPHABET_PROTEIN)
    return jk.alphabet_bytes(p.alphabet)


def _bytes(seed, symbols=SYMBOLS, shape=(2, 1500), rare=RARE, p_rare=0.03):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(symbols, dtype=np.uint8), size=shape)
    hit = rng.random(shape) < p_rare
    seq[hit] = rng.choice(np.frombuffer(rare, dtype=np.uint8),
                          size=int(hit.sum()))
    return np.ascontiguousarray(seq)


def _assert_all_agree(seq, **kw):
    """Dispatcher == twin on every window; twin == JAX on valid ones."""
    x = torch.from_numpy(seq)
    h, v = tk.hash_chunk(x, **kw)
    hp, vp = tk.hash_chunk_plain(x, **kw)
    assert torch.equal(h, hp) and torch.equal(v, vp)
    h0, v0 = jk.hash_chunk(jnp.asarray(seq), **kw)
    v0 = np.asarray(v0)
    np.testing.assert_array_equal(v0, v.numpy())
    np.testing.assert_array_equal(np.asarray(h0)[v0],
                                  h.numpy().view(np.uint64)[v0])
    assert v0.any()
    return h, v


@pytest.mark.parametrize("k", [1, 9, 16, 21, 32])
@pytest.mark.parametrize("use64,noncanonical",
                         [(True, False), (False, True)],
                         ids=["64bit-canonical", "32bit-noncanonical"])
def test_dispatcher_cpu_matches_plain_and_jax(k, use64, noncanonical):
    seq = _bytes(k + 100 * use64)
    _assert_all_agree(seq, alphabet=DNA, k=k, seed=42, use64=use64,
                      noncanonical=noncanonical, preserve_case=False)


@pytest.mark.parametrize("k,use64,noncanonical",
                         [(21, True, False), (9, False, True)])
def test_dispatcher_cpu_preserve_case(k, use64, noncanonical):
    # -Z keeps lowercase out of the (uppercase) alphabet: keep it rare
    seq = _bytes(7 + k, symbols=b"ACGT", rare=b"acgtN\x00\xc8")
    _assert_all_agree(seq, alphabet=DNA, k=k, seed=7, use64=use64,
                      noncanonical=noncanonical, preserve_case=True)


def test_dispatcher_cpu_protein():
    seq = _bytes(3, symbols=ALPHABET_PROTEIN.encode() + b"acdef",
                 rare=b"XBJZ*\x00\xd0")
    _assert_all_agree(seq, alphabet=_protein_alpha(), k=9, seed=42,
                      use64=True, noncanonical=True, preserve_case=False)


@pytest.mark.parametrize("k", [1, 21, 32])
def test_row_of_exactly_k_bytes(k):
    seq = _bytes(50 + k, shape=(3, k), p_rare=0.0)
    h, v = _assert_all_agree(seq, alphabet=DNA, k=k, seed=42, use64=True,
                             noncanonical=False, preserve_case=False)
    assert h.shape == v.shape == (3, 1)


@pytest.mark.parametrize(
    "shape,k,want",
    [((3, 2, 50), 21, (6, 50, (3, 2, 30))),
     ((50,), 21, (1, 50, (30,))),
     ((4, 21), 21, (4, 21, (4, 1))),
     ((0, 40), 9, (0, 40, (0, 32)))],
    ids=["3x2xL", "1d", "L==k", "no-rows"])
def test_as_rows(shape, k, want):
    assert hash_kernel._as_rows(shape, k) == want


def test_leading_dims_keep_their_shape():
    seq = _bytes(9, shape=(3, 2, 300))
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    h, v = tk.hash_chunk(torch.from_numpy(seq), **kw)
    hf, vf = tk.hash_chunk_plain(torch.from_numpy(seq.reshape(6, 300)), **kw)
    assert h.shape == v.shape == (3, 2, 280)
    assert torch.equal(h.reshape(6, 280), hf)
    assert torch.equal(v.reshape(6, 280), vf)


@pytest.mark.parametrize(
    "make,k,match",
    [(lambda: torch.zeros(64, dtype=torch.uint8), 21, "cuda tensors"),
     (lambda: torch.zeros(64, dtype=torch.int32), 21, "uint8"),
     (lambda: torch.zeros(20, dtype=torch.uint8), 21, "shorter than k=21"),
     (lambda: torch.zeros(64, dtype=torch.uint8), 33, "k must be in 1..32"),
     (lambda: torch.zeros(64, dtype=torch.uint8), 0, "k must be in 1..32")],
    ids=["cpu-tensor", "dtype", "L<k", "k=33", "k=0"])
def test_hash_windows_refuses(make, k, match):
    with pytest.raises(ValueError, match=match):
        hash_kernel.hash_windows(make(), alphabet=DNA, k=k, seed=42,
                                 use64=True, noncanonical=False,
                                 preserve_case=False)


def test_hash_windows_refuses_wide_seed():
    with pytest.raises(ValueError, match="uint32"):
        hash_kernel.hash_windows(torch.zeros(64, dtype=torch.uint8),
                                 alphabet=DNA, k=21, seed=1 << 32,
                                 use64=True, noncanonical=False,
                                 preserve_case=False)


def test_dispatcher_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.hash_chunk(torch.zeros(64, dtype=torch.uint8, device="meta"),
                      alphabet=DNA, k=21, seed=42, use64=True,
                      noncanonical=False, preserve_case=False)


def test_dispatcher_sends_cuda_tensors_to_the_kernel(monkeypatch):
    """A CUDA tensor goes to ``hash_windows`` and never to the twin (a
    stand-in with a CUDA device: there is no card here)."""
    calls = []

    def kernel(seq, **kw):
        calls.append(kw)
        return "kernel"

    def plain(*_a, **_kw):
        raise AssertionError("the plain twin ran for a CUDA tensor")

    monkeypatch.setattr(hash_kernel, "hash_windows", kernel)
    monkeypatch.setattr(tk, "hash_chunk_plain", plain)
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=True)
    assert tk.hash_chunk(fake, **kw) == "kernel"
    assert calls == [kw]


def test_sketch_twins_never_reach_the_dispatcher(monkeypatch):
    """K1's twins hash with ``hash_chunk_plain``, so that holding K1 to them
    on the card does not lean on the window hash kernel."""
    chunks = torch.from_numpy(_bytes(5, shape=(2, 3000), p_rare=0.01))
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    want_sel = sk.sketch_select_plain(chunks, **kw, m=16)
    want_st = sk.sketch_chunks_plain(chunks, **kw, s=50)

    def refuse(*_a, **_kw):
        raise AssertionError("a twin reached the dispatcher")

    monkeypatch.setattr(hash_kernel, "hash_windows", refuse)
    monkeypatch.setattr(tk, "hash_chunk", refuse)
    monkeypatch.setattr(sk, "hash_chunk", refuse)
    got_sel = sk.sketch_select_plain(chunks, **kw, m=16)
    got_st = sk.sketch_chunks_plain(chunks, **kw, s=50)
    assert all(torch.equal(a, b) for a, b in zip(got_sel, want_sel))
    assert all(torch.equal(a, b) for a, b in zip(got_st, want_st))


def test_windowed_hash_matches_jax():
    """``windowed_hash`` (raw forward bytes, 64-bit, every window) against
    ``mash_tpu``'s ``_windowed_hash_fn`` on every window."""
    seq = _bytes(12, shape=(1, 2000))[0]
    params = default_nucleotide_params(21, 1000, 42)
    want = np.asarray(JaxEngine(params)._windowed_hash_fn(seq.size)(
        jnp.asarray(seq)))
    got = te.windowed_hash(torch.from_numpy(seq), 21, 42)
    np.testing.assert_array_equal(want, got.numpy().view(np.uint64))


@pytest.mark.parametrize("length", [21, 5000])
def test_exact_route_hash_bytes_matches_jax(length):
    """The exact route's ``hash_bytes`` (no bucket padding) against
    ``mash_tpu``'s (padded to a bucket) on the buffer's windows."""
    data = _bytes(length, shape=(1, length))[0].tobytes()
    h, v = te.SketchEngine(torch_params(21, 1000, 42),
                           device="cpu").hash_bytes(data)
    h0, v0 = JaxEngine(default_nucleotide_params(21, 1000, 42)).hash_bytes(
        data)
    n = length - 20
    assert h.shape == v.shape == (n,)
    v0 = np.asarray(v0)[:n]
    np.testing.assert_array_equal(v0, v)
    np.testing.assert_array_equal(np.asarray(h0)[:n][v0], h[v0])


def _touch(path, mtime):
    with open(path, "w") as f:
        f.write("x")
    os.utime(path, (mtime, mtime))


def test_stale_counts_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` makes every library stale, as an edited
    ``.cu`` makes its own."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "_CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "_BUILD", str(build))
    assert cuda_build._stale("k")  # no library yet
    _touch(csrc / "k.cu", 1000)
    _touch(csrc / "shared.cuh", 1000)
    _touch(build / "libk.so", 2000)
    assert not cuda_build._stale("k")
    _touch(csrc / "shared.cuh", 3000)
    assert cuda_build._stale("k")
    _touch(build / "libk.so", 4000)
    assert not cuda_build._stale("k")
    _touch(csrc / "k.cu", 5000)
    assert cuda_build._stale("k")


@pytest.mark.parametrize("alpha", ["dna", "protein", "raw"])
def test_tables_are_the_luts_built_once(alpha, monkeypatch):
    """``_tables`` holds ``alphabet_lut``/``complement_lut``'s tables of an
    alphabet, read-only, and builds them once an alphabet."""
    alphabet = {"dna": DNA, "protein": _protein_alpha(), "raw": ()}[alpha]
    calls = []
    real = hash_kernel.alphabet_lut

    def counted(a):
        calls.append(a)
        return real(a)

    monkeypatch.setattr(hash_kernel, "alphabet_lut", counted)
    hash_kernel._tables.cache_clear()
    try:
        alut, clut = hash_kernel._tables(alphabet)
        np.testing.assert_array_equal(alut, tk.alphabet_lut(alphabet))
        np.testing.assert_array_equal(clut, tk.complement_lut(alphabet))
        assert not alut.flags.writeable and not clut.flags.writeable
        again = hash_kernel._tables(tuple(alphabet))
        assert again[0] is alut and again[1] is clut
        assert calls == [alphabet]
    finally:
        hash_kernel._tables.cache_clear()


def test_launcher_binds_once(monkeypatch):
    """The kernel's C entry is loaded and bound once a process."""
    loads = []

    def entry(*_a):
        return 0

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(hash_windows_launch=entry)

    monkeypatch.setattr(cuda_build, "load", load)
    hash_kernel._launcher.cache_clear()
    try:
        fn = hash_kernel._launcher()
        assert hash_kernel._launcher() is fn is entry
        assert loads == ["hash_windows"]
        assert len(fn.argtypes) == 13 and fn.restype is not None
    finally:
        hash_kernel._launcher.cache_clear()
