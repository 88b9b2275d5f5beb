// sketch_select: sequence bytes -> per-subrow bottom-m hash candidates.
//
// Replaces the Pallas kernel mash_tpu/ops/pallas_sketch.py::_kernel
// (built by _build, driven by hash_select_tiles / sketch_chunks_pallas).
//
// What it computes, for every C-window subrow of every chunk row:
//   - the alphabet check and k-window validity of each window,
//   - the canonical strand (memcmp(fwd, revcomp) <= 0, first byte first),
//   - MurmurHash3_x64_128 h1 of the k bytes (low 32 bits when !use64),
//   - the m smallest hashes of the subrow (invalid windows count as
//     UINT64_MAX), the (m+1)-th smallest as the boundary, and the number
//     of valid windows.
// The torch caller (ops/sketch_kernel.py) folds the candidates to bottom-s
// and checks the exactness certificate; it falls back to the plain path
// when the certificate fails.
//
// What bounds it on the H100: integer work.  Each window costs a k-byte
// canonical compare, the packing of ceil(k/8) words and ~40 64-bit
// multiply/rotate/xor steps (a 64-bit multiply is several 32-bit IMADs);
// the input is read once (1 byte per window), so bytes are far below the
// memory roof.  The subrow selection is a 2048-key bitonic sort in shared
// memory, ~66 compare-exchange stages.
//
// What the design does about it: one block per subrow keeps the subrow's
// bytes (C + k - 1 of them, uppercased once) and its 2048 keys in shared
// memory, so nothing but m + 2 values per subrow goes back to device
// memory.  Hashing is native uint64_t (the TPU kernel emulated it on
// int32 lanes).  Unlike the TPU kernel, no halo tile is built on the host:
// a block reads its k-1 halo bytes straight from the chunk row.
//
// A valid window whose hash is UINT64_MAX is indistinguishable from an
// invalid one here and is dropped; the caller's all-captured certificate
// then fails for that row unless the bottom-s is proven below it, so the
// result stays exact (probability 2^-64 per window in 64-bit mode, and
// impossible in 32-bit mode).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int C = 2048;        // windows per subrow (one block)
constexpr int THREADS = 512;   // C / THREADS windows per thread
constexpr int KMAX = 32;

struct Luts {
  uint8_t alpha[256];  // 1 if the byte is in the alphabet
  uint8_t comp[256];   // complement byte of alphabet members, else 0
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// MurmurHash3_x64_128 h1 over `len` bytes packed little-endian in w[].
__device__ __forceinline__ uint64_t mmh3_h1(const uint64_t* w, int len,
                                            uint32_t seed) {
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = len / 16;
  for (int b = 0; b < nblocks; ++b) {
    uint64_t k1 = w[2 * b], k2 = w[2 * b + 1];
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }
  const int tlen = len & 15;
  if (tlen > 8) {
    uint64_t k2 = w[2 * nblocks + 1];
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
  }
  if (tlen > 0) {
    uint64_t k1 = w[2 * nblocks];
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint64_t)len;
  h2 ^= (uint64_t)len;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

__global__ void __launch_bounds__(THREADS)
sketch_select_kernel(const uint8_t* __restrict__ chunks, int64_t L,
                     int64_t n, int R, Luts luts, int k, uint32_t seed,
                     int use64, int noncanonical, int preserve_case, int m,
                     uint64_t* __restrict__ cand,
                     uint64_t* __restrict__ boundary,
                     int32_t* __restrict__ vcount) {
  __shared__ uint64_t keys[C];
  __shared__ uint8_t seq[C + KMAX];
  __shared__ uint8_t alpha[256];
  __shared__ uint8_t comp[256];
  __shared__ int nvalid;

  const int r = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t w0 = (int64_t)r * C;  // first window of this subrow
  const uint8_t* row = chunks + b * L;

  if (tid < 256) {
    alpha[tid] = luts.alpha[tid];
    comp[tid] = luts.comp[tid];
  }
  if (tid == 0) nvalid = 0;
  // bytes [w0, w0 + C + k - 1) of the row, uppercased; 0 past the row end
  for (int i = tid; i < C + k - 1; i += THREADS) {
    int64_t p = w0 + i;
    uint8_t c = p < L ? row[p] : 0;
    if (!preserve_case) {
      int8_t sc = (int8_t)c;  // the reference compares signed chars
      if (sc > 96 && sc < 123) c = (uint8_t)(c - 32);
    }
    seq[i] = c;
  }
  __syncthreads();

  int my_valid = 0;
  for (int t = tid; t < C; t += THREADS) {
    uint64_t key = ~0ULL;
    if (w0 + t < n) {
      const uint8_t* s = seq + t;
      bool ok = true;
      for (int j = 0; j < k; ++j) ok &= alpha[s[j]] != 0;
      if (ok) {
        bool fwd = true;
        if (!noncanonical) {
          for (int j = 0; j < k; ++j) {
            uint8_t f = s[j], rv = comp[s[k - 1 - j]];
            if (f != rv) {
              fwd = f < rv;
              break;
            }
          }
        }
        uint64_t w[4] = {0, 0, 0, 0};
        for (int j = 0; j < k; ++j) {
          uint8_t by = fwd ? s[j] : comp[s[k - 1 - j]];
          w[j >> 3] |= (uint64_t)by << (8 * (j & 7));
        }
        uint64_t h = mmh3_h1(w, k, seed);
        key = use64 ? h : (h & 0xffffffffULL);
        ++my_valid;
      }
    }
    keys[t] = key;
  }
  if (my_valid) atomicAdd(&nvalid, my_valid);
  __syncthreads();

  // bitonic sort of the C keys, ascending
  for (int size = 2; size <= C; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < C / 2; p += THREADS) {
        int i = 2 * p - (p & (stride - 1));
        int j = i + stride;
        bool up = (i & size) == 0;
        uint64_t a = keys[i], c = keys[j];
        if ((a > c) == up) {
          keys[i] = c;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }

  const int64_t out_row = b * R + r;
  for (int q = tid; q < m; q += THREADS) cand[out_row * m + q] = keys[q];
  if (tid == 0) {
    boundary[out_row] = keys[m];
    vcount[out_row] = nvalid;
  }
}

}  // namespace

extern "C" int sketch_select_launch(const uint8_t* chunks, int64_t B,
                                    int64_t L, const uint8_t* alpha_lut,
                                    const uint8_t* comp_lut, int k,
                                    uint32_t seed, int use64,
                                    int noncanonical, int preserve_case,
                                    int m, uint64_t* cand,
                                    uint64_t* boundary, int32_t* vcount,
                                    void* stream) {
  if (k < 1 || k > KMAX || m < 1 || m >= C) return (int)cudaErrorInvalidValue;
  const int64_t n = L - k + 1;
  if (n < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int R = (int)((n + C - 1) / C);
  Luts luts;
  for (int i = 0; i < 256; ++i) {
    luts.alpha[i] = alpha_lut[i];
    luts.comp[i] = comp_lut[i];
  }
  dim3 grid(R, (unsigned)B);
  sketch_select_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      chunks, L, n, R, luts, k, seed, use64, noncanonical, preserve_case, m,
      cand, boundary, vcount);
  return (int)cudaGetLastError();
}
