"""mash_tpu_torch.ops.kmers against mash_tpu.ops.kmers on the CPU.

The same numpy-seeded bytes go through both packages' ``hash_chunk``;
hashes of valid windows and validity masks must be identical (exact:
they are integers).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mash_tpu.core.params import (
    ALPHABET_PROTEIN,
    SketchParams,
    default_nucleotide_params,
)
from mash_tpu.ops import kmers as jk
from mash_tpu_torch.ops import kmers as tk

DNA = jk.alphabet_bytes(default_nucleotide_params().alphabet)


def _protein_alpha():
    p = SketchParams()
    p.set_alphabet(ALPHABET_PROTEIN)
    return jk.alphabet_bytes(p.alphabet)


def _bytes(seed, symbols, shape=(2, 1500), rare=b"", p_rare=0.02):
    """Random ``symbols`` with a fraction ``p_rare`` of ``rare`` bytes."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(symbols, dtype=np.uint8), size=shape)
    if rare:
        hit = rng.random(shape) < p_rare
        seq[hit] = rng.choice(np.frombuffer(rare, dtype=np.uint8),
                              size=int(hit.sum()))
    return seq


def _assert_same(seq, **kw):
    h0, v0 = jk.hash_chunk(jnp.asarray(seq), **kw)
    h1, v1 = tk.hash_chunk(torch.from_numpy(seq), **kw)
    v0 = np.asarray(v0)
    np.testing.assert_array_equal(v0, v1.numpy())
    np.testing.assert_array_equal(
        np.asarray(h0)[v0], h1.numpy().view(np.uint64)[v0]
    )
    assert v0.any()


@pytest.mark.parametrize("k", range(1, 33))
def test_hash_chunk_every_k(k):
    seq = _bytes(k, b"ACGTacgt", rare=b"NRY\x00")
    _assert_same(seq, alphabet=DNA, k=k, seed=42, use64=k > 16,
                 noncanonical=False, preserve_case=False)


@pytest.mark.parametrize(
    "k,use64,noncanonical,preserve_case,seed",
    [
        (21, True, True, False, 42),    # -n
        (21, True, False, True, 42),    # -Z
        (21, False, False, False, 7),   # 32-bit hashes, other seed
        (9, True, False, False, 42),    # 64-bit hashes at small k
        (16, True, True, True, 0),      # -n -Z, seed 0
    ],
)
def test_hash_chunk_modes(k, use64, noncanonical, preserve_case, seed):
    # -Z keeps lowercase out of the (uppercase) alphabet: keep it rare
    seq = _bytes(100 + k, b"ACGT" if preserve_case else b"ACGTacgt",
                 rare=b"acN\x00\xc8")
    _assert_same(seq, alphabet=DNA, k=k, seed=seed, use64=use64,
                 noncanonical=noncanonical, preserve_case=preserve_case)


def test_hash_chunk_protein():
    seq = _bytes(3, ALPHABET_PROTEIN.encode() + b"acdef",
                 rare=b"XBJZ*\x00")
    _assert_same(seq, alphabet=_protein_alpha(), k=9, seed=42, use64=True,
                 noncanonical=True, preserve_case=False)


def test_separators_invalidate_windows():
    seq = np.frombuffer(b"ACGTACGTAC\x00GTACGTACGT", dtype=np.uint8)[None]
    _, v = tk.hash_chunk(torch.from_numpy(seq.copy()), alphabet=DNA, k=5,
                         seed=42, use64=True, noncanonical=False,
                         preserve_case=False)
    v = v.numpy()[0]
    assert not v[6:11].any()  # every window over the 0x00 separator
    assert v[:6].all() and v[11:].all()
    _assert_same(seq.copy(), alphabet=DNA, k=5, seed=42, use64=True,
                 noncanonical=False, preserve_case=False)


def test_hash_matches_scalar_oracle():
    from mash_tpu.hashing.murmur3 import hash_kmer_py

    seq = _bytes(11, b"ACGT", shape=(1, 200))
    h, v = tk.hash_chunk(torch.from_numpy(seq), alphabet=DNA, k=21,
                         seed=42, use64=True, noncanonical=True,
                         preserve_case=False)
    assert v.all()
    want = [hash_kmer_py(seq[0, i : i + 21].tobytes(), 42, True)
            for i in range(180)]
    assert h.numpy().view(np.uint64)[0].tolist() == want


@pytest.mark.parametrize("chunk_len", [64, 4096])
def test_unpack_chunks(chunk_len):
    rng = np.random.default_rng(chunk_len)
    packed = rng.integers(0, 256, size=(3, chunk_len // 4 + chunk_len // 8),
                          dtype=np.uint8)
    want = np.asarray(jk.unpack_chunks(jnp.asarray(packed), chunk_len))
    got = tk.unpack_chunks(torch.from_numpy(packed), chunk_len).numpy()
    np.testing.assert_array_equal(want, got)
