// hash_windows: sequence bytes -> every k-mer window's MurmurHash3 and
// validity.
//
// Replaces mash_tpu/ops/kmers.py::hash_chunk (:129-204), a jax.jit function
// (not a Pallas kernel) that XLA compiles into one fused loop over the bytes;
// the same function serves mash_tpu/core/engine.py::_windowed_hash_fn
// (:350-378), windowed mode's raw forward hash.  Its plain torch twin,
// ops/kmers.py::hash_chunk_plain, runs as a few hundred elementwise passes.
//
// What it computes, for window i < L - k + 1 of each row of L bytes:
//   - the window's k bytes, uppercased unless preserve_case (on the signed
//     byte, as the reference compares char: bytes >= 0x80 never shift),
//   - valid = every byte is in the alphabet (a 256-entry table),
//   - the canonical k-mer: the forward one if memcmp(fwd, revcomp) <= 0,
//     else the reverse complement (non-members complement to 0); always
//     the forward one when noncanonical,
//   - MurmurHash3_x64_128 h1 of it (its low 32 bits unless use64), for
//     every window, valid or not: windowed mode reads every hash.
//
// What bounds it on the H100: bytes.  A window reads 1 byte and writes 9
// (an int64 hash and a bool); its hash is about a hundred 32-bit integer
// instructions, which the card issues in less time than the bytes take
// ([32, 1 MiB] at k = 21: 0.100 ms of bytes at 3.35 TB/s).
//
// What the design does about it: one pass that writes nothing but the
// outputs.  A block takes TILE consecutive windows of a row and stages their
// TILE + k - 1 bytes once in shared memory, uppercased, beside each byte's
// complement and non-alphabet flag.  A thread then reads a window's forward,
// complement and flag words with ceil(k/8) + 1 eight-byte shared loads each,
// shifted into place, instead of k byte loads; the reverse complement is the
// complement words byte-reversed (__byte_perm) and shifted down, and memcmp
// order is the order of byte-swapped words.  Thread j of a block takes
// windows j, j + THREADS, ..., so each store of a warp is one contiguous run.

#include <cstdint>
#include <cuda_runtime.h>

#include "mmh3.cuh"  // u64, mmh3_h1, bswap64

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;               // windows a thread
constexpr int TILE = THREADS * ITEMS;  // windows a block
constexpr int KMAX = 32;
// the tile's TILE + k - 1 bytes and zeros up to the last word a window's
// shifted loads read (word TILE / 8 + NW - 1)
constexpr int STAGE_WORDS = (TILE + KMAX) / 8 + 1;

struct Luts {
  uint8_t alpha[256];  // 1 if the byte is in the alphabet
  uint8_t comp[256];   // complement byte of alphabet members, else 0
};

// Bytes t .. t + k - 1 of a staged array as NW little-endian words, zero
// past byte k - 1 (`top` keeps the last word's bytes below k).
template <int NW>
__device__ __forceinline__ void window_words(const u64* w, int t, u64 top,
                                             u64 (&out)[NW]) {
  const int a = t >> 3, r = 8 * (t & 7);
  u64 lo = w[a];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const u64 hi = w[a + i + 1];
    out[i] = r ? (lo >> r) | (hi << (64 - r)) : lo;
    lo = hi;
  }
  out[NW - 1] &= top;
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
hash_windows_kernel(const uint8_t* __restrict__ seq, int64_t B, int64_t L,
                    int64_t n, Luts luts, int k, uint32_t seed, int use64,
                    int noncanonical, int preserve_case,
                    u64* __restrict__ hashes, uint8_t* __restrict__ valid) {
  __shared__ u64 seq_w[STAGE_WORDS], comp_w[STAGE_WORDS], bad_w[STAGE_WORDS];
  __shared__ uint8_t alpha[256];
  __shared__ uint8_t comp[256];
  uint8_t* sb = reinterpret_cast<uint8_t*>(seq_w);
  uint8_t* cb = reinterpret_cast<uint8_t*>(comp_w);
  uint8_t* fb = reinterpret_cast<uint8_t*>(bad_w);

  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += THREADS) {
    alpha[i] = luts.alpha[i];
    comp[i] = luts.comp[i];
  }
  const int64_t w0 = (int64_t)blockIdx.x * TILE;  // the tile's first window
  const int span = TILE + k - 1;                  // bytes its windows read
  const u64 top = (k & 7) ? (1ull << (8 * (k & 7))) - 1 : ~0ull;
  // the byte-reversed complement words hold the k-mer's reverse complement
  // 8 NW - k bytes up
  const int d = 8 * (8 * NW - k);

  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* row = seq + b * L;
    __syncthreads();  // the tables staged, the previous row's bytes read
    for (int i = tid; i < STAGE_WORDS * 8; i += THREADS) {
      const int64_t p = w0 + i;
      uint8_t c = (i < span && p < L) ? row[p] : 0;
      if (!preserve_case) {
        const int8_t sc = (int8_t)c;  // the reference compares signed chars
        if (sc > 96 && sc < 123) c = (uint8_t)(c - 32);
      }
      sb[i] = c;
      cb[i] = comp[c];
      fb[i] = !alpha[c];
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int t = q * THREADS + tid;
      const int64_t w = w0 + t;
      if (w >= n) break;
      u64 fwd[NW], bad[NW], words[NW];
      window_words<NW>(seq_w, t, top, fwd);
      window_words<NW>(bad_w, t, top, bad);
      u64 any_bad = 0;
#pragma unroll
      for (int i = 0; i < NW; ++i) any_bad |= bad[i];
      if (noncanonical) {
#pragma unroll
        for (int i = 0; i < NW; ++i) words[i] = fwd[i];
      } else {
        u64 cw[NW], rw[NW + 1], rev[NW];
        window_words<NW>(comp_w, t, top, cw);
        // byte j of the reverse complement is complement byte k - 1 - j:
        // the NW words byte-reversed, then shifted down 8 NW - k bytes
#pragma unroll
        for (int i = 0; i < NW; ++i) rw[i] = bswap64(cw[NW - 1 - i]);
        rw[NW] = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i)
          rev[i] = d ? (rw[i] >> d) | (rw[i + 1] << (64 - d)) : rw[i];
        // memcmp(fwd, rev) <= 0: the first word that differs decides
        bool use_fwd = true;
#pragma unroll
        for (int i = NW - 1; i >= 0; --i) {
          const u64 x = bswap64(fwd[i]), y = bswap64(rev[i]);
          if (x != y) use_fwd = x < y;
        }
#pragma unroll
        for (int i = 0; i < NW; ++i) words[i] = use_fwd ? fwd[i] : rev[i];
      }
      const u64 h = mmh3_h1<NW>(words, k, seed);
      const int64_t out = b * n + w;
      hashes[out] = use64 ? h : (h & 0xffffffffull);
      valid[out] = any_bad == 0;
    }
  }
}

}  // namespace

extern "C" int hash_windows_launch(const uint8_t* seq, int64_t B, int64_t L,
                                   const uint8_t* alpha_lut,
                                   const uint8_t* comp_lut, int k,
                                   uint32_t seed, int use64, int noncanonical,
                                   int preserve_case, uint64_t* hashes,
                                   uint8_t* valid, void* stream) {
  if (k < 1 || k > KMAX || B < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = L - k + 1;
  const int64_t tiles = (n + TILE - 1) / TILE;
  if (n < 1 || tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Luts luts;
  for (int i = 0; i < 256; ++i) {
    luts.alpha[i] = alpha_lut[i];
    luts.comp[i] = comp_lut[i];
  }
  dim3 grid((unsigned)tiles, (unsigned)(B < 65535 ? B : 65535));
  cudaStream_t s = (cudaStream_t)stream;
  u64* h = reinterpret_cast<u64*>(hashes);
#define HASH_WINDOWS_LAUNCH(NW)                                           \
  hash_windows_kernel<NW><<<grid, THREADS, 0, s>>>(                       \
      seq, B, L, n, luts, k, seed, use64, noncanonical, preserve_case, h, \
      valid)
  switch ((k + 7) / 8) {
    case 1: HASH_WINDOWS_LAUNCH(1); break;
    case 2: HASH_WINDOWS_LAUNCH(2); break;
    case 3: HASH_WINDOWS_LAUNCH(3); break;
    default: HASH_WINDOWS_LAUNCH(4); break;
  }
#undef HASH_WINDOWS_LAUNCH
  return (int)cudaGetLastError();
}
