"""Hashing primitives: bit-exact MurmurHash3 for scalars, numpy and JAX."""

from mash_tpu_torch.hashing.murmur3 import (
    mmh3_x64_128_py,
    mmh3_words_x64_128,
    hash_kmer_py,
)

__all__ = ["mmh3_x64_128_py", "mmh3_words_x64_128", "hash_kmer_py"]
