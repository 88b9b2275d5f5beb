"""The plain reference against hand-checked values: MurmurHash3_x64_128's
published digests, canonical k-mers written out by hand, and a tiny
bottom-s with counts."""

import numpy as np
import pytest
import torch

import benchtest_util  # noqa: F401  (the repository on the path)

from h100_bench.reference import kmers
from h100_bench.reference.sketch import bottom_s, genome_sketch


@pytest.mark.parametrize("data,seed,h1", [
    (b"", 0, 0),
    (b"hello", 0, 0xCBD8A7B341BD9B02),
    # digest 6c1b07bc7bbc4be347939ac4a93c437a, h1 its first 8 bytes
    (b"The quick brown fox jumps over the lazy dog", 0, 0xE34BBC7BBC071B6C),
])
def test_mmh3_published_values(data, seed, h1):
    assert kmers.mmh3_x64_128(data, seed)[0] == h1


def test_mmh3_agrees_with_the_scalar_oracle_of_the_port():
    from mash_tpu_torch.hashing.murmur3 import mmh3_x64_128_py

    rng = np.random.default_rng(7)
    for n in list(range(0, 40)) + [64, 100]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert kmers.mmh3_x64_128(data, 42) == mmh3_x64_128_py(data, 42)


def rc(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


@pytest.mark.parametrize("k,bits", [(21, 64), (16, 32), (5, 16), (32, 64)])
def test_window_hashes_by_hand(k, bits):
    rng = np.random.default_rng(k)
    seq = bytearray(rng.choice(list(b"ACGT"), 300).astype(np.uint8))
    seq[40] = ord("N")
    seq[100:110] = b"acgtacgtac"  # lower case folds to upper
    seq = bytes(seq)
    h, v = kmers.window_hashes(torch.frombuffer(bytearray(seq), dtype=torch.uint8),
                               k, 42, bits)
    for i in range(len(seq) - k + 1):
        kmer = seq[i:i + k].upper()
        assert bool(v[i]) == all(c in b"ACGT" for c in kmer)
        if not v[i]:
            continue
        canon = min(kmer, rc(kmer))
        want = kmers.mmh3_x64_128(canon, 42)[0] & ((1 << bits) - 1)
        assert kmers.unsigned(int(h[i])) == want


def test_window_hashes_of_reads_keep_to_their_rows():
    reads = np.frombuffer(b"ACGTTGCAAC" + b"GGGTTTAAAC", np.uint8).reshape(2, 10)
    h, v = kmers.window_hashes(torch.from_numpy(reads.copy()), 4, 42, 64)
    assert h.shape == (2, 7) and bool(v.all())
    whole, _ = kmers.window_hashes(torch.from_numpy(reads[1].copy()), 4, 42, 64)
    assert torch.equal(h[1], whole)


def test_bottom_s_and_counts_by_hand():
    x = torch.tensor([5, -1, 3, 5, 7, 3, 5, 2**40], dtype=torch.int64)
    h, c = bottom_s(x, 3)
    # unsigned order: 3, 5, 7, 2^40, then -1 (2^64 - 1)
    assert h.tolist() == [3, 5, 7] and c.tolist() == [2, 3, 1]
    h, c = bottom_s(x, 10)
    assert h.tolist() == [3, 5, 7, 2**40, 2**64 - 1]
    assert c.tolist() == [2, 3, 1, 1, 1]


def test_genome_sketch_windows_do_not_span_records():
    config = {"kmer_size": 4, "sketch_size": 100, "hash_seed": 42,
              "hash_bits": 64}
    a = np.frombuffer(b"ACGTAC", np.uint8)
    b = np.frombuffer(b"GTTTCA", np.uint8)
    h, c = genome_sketch([a, b], config, "cpu")
    joined, _ = genome_sketch([np.concatenate([a, b])], config, "cpu")
    assert c.sum() == 3 + 3  # windows of each record alone
    assert len(joined) > len(h)
