// mmh3.cuh: MurmurHash3_x64_128 h1 of one k-mer and the memcmp order of
// packed words, shared by the kernels that hash windows
// (sketch_select.cu, hash_windows.cu).
//
// A k-mer of `len` bytes is held little-endian in NW = ceil(len / 8) 64-bit
// words (byte j at bits 8 (j % 8) of word j / 8), zero past len, as the
// plain torch version packs it (ops/kmers.py::hash_from_byte_fns).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ u64 rotl64(u64 x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ u64 fmix64(u64 k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// MurmurHash3_x64_128 h1 over `len` bytes packed little-endian in the
// NW = ceil(len / 8) words w[] (zero past len).  The tail's words are the
// last one or two, so every index is known at compile time.
template <int NW>
__device__ __forceinline__ u64 mmh3_h1(const u64 (&w)[NW], int len,
                                       uint32_t seed) {
  const u64 c1 = 0x87c37b91114253d5ULL;
  const u64 c2 = 0x4cf5ad432745937fULL;
  u64 h1 = seed, h2 = seed;
  const int nblocks = len >> 4;
#pragma unroll
  for (int b = 0; b < NW / 2; ++b) {
    if (b < nblocks) {
      u64 k1 = w[2 * b], k2 = w[2 * b + 1];
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
      h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
    }
  }
  const int tlen = len & 15;
  if constexpr (NW >= 2) {
    if (tlen > 8) {  // words NW-2 (k1) and NW-1 (k2)
      u64 k2 = w[NW - 1];
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      u64 k1 = w[NW - 2];
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }
  }
  if (tlen > 0 && tlen <= 8) {  // word NW-1 (k1)
    u64 k1 = w[NW - 1];
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (u64)len;
  h2 ^= (u64)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// memcmp order of little-endian packed bytes: compare byte-swapped words
__device__ __forceinline__ u64 bswap64(u64 x) {
  const unsigned lo = (unsigned)x, hi = (unsigned)(x >> 32);
  return ((u64)__byte_perm(lo, 0, 0x0123) << 32) | __byte_perm(hi, 0, 0x0123);
}

}  // namespace
