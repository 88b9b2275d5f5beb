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
// What bounds it on the H100: integer work.  Each window costs about a
// hundred 32-bit integer instructions of MurmurHash3 (a 64-bit multiply,
// shift or rotate is two or more of them); the input is read once (1 byte
// per window), so bytes are far below the memory roof.
//
// What the design does about it:
//   - One block per subrow stages the subrow's C + k - 1 bytes, uppercased
//     once, in shared memory.  Nothing but m + 2 values per subrow goes back
//     to device memory, and no halo tile is built on the host.
//   - Each thread takes W consecutive windows and rolls their packed words:
//     the forward words shift one byte down and take the new byte on top,
//     the reverse-complement words shift one byte up and take the new
//     byte's complement at the bottom, and a count of non-alphabet bytes
//     gains the new byte and drops the old one.  Each byte's complement
//     and flag are staged beside it, and a thread's first state is read 8
//     bytes at a time, so a window costs four byte loads and ceil(k/8)
//     word shifts, not 3k byte loads.  memcmp order is
//     the order of byte-swapped words (__byte_perm), so the canonical
//     choice is ceil(k/8) word compares.  Hashing is native 64-bit.
//   - For m < 32, each lane sorts its W keys in registers, each warp keeps
//     its 32 smallest in a list across its lanes (bitonic merges with
//     __shfl_xor_sync, one per round of each lane's next-smallest key,
//     until no lane has a key below the list's largest), and warp 0 merges
//     the warps' lists from shared memory.  Three block barriers in all.
//   - For m >= 32 the subrow's C keys are bitonic-sorted in shared memory
//     (66 barriered stages).
//
// A valid window whose hash is UINT64_MAX is indistinguishable from an
// invalid one here and is dropped; the caller's all-captured certificate
// then fails for that row unless the bottom-s is proven below it, so the
// result stays exact (probability 2^-64 per window in 64-bit mode, and
// impossible in 32-bit mode).

#include <cstdint>
#include <cuda_runtime.h>

#include "mmh3.cuh"  // u64, mmh3_h1, bswap64

namespace {

constexpr int C = 2048;             // windows per subrow (one block)
constexpr int THREADS = 256;
constexpr int W = C / THREADS;      // consecutive windows per thread
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 32;
constexpr int FAST_M = 32;          // m below this takes the warp selection
constexpr unsigned FULL = 0xffffffffu;

struct Luts {
  uint8_t alpha[256];  // 1 if the byte is in the alphabet
  uint8_t comp[256];   // complement byte of alphabet members, else 0
};

__device__ __forceinline__ u64 min64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a < b ? b : a; }

// Bitonic sort of one key per lane across the warp, ascending by lane
// (descending if desc).
__device__ __forceinline__ u64 warp_sort(u64 x, bool desc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 y = __shfl_xor_sync(FULL, x, stride);
      const bool up = ((lane & size) == 0) != desc;
      x = (((lane & stride) == 0) == up) ? min64(x, y) : max64(x, y);
    }
  }
  return x;
}

// A bitonic sequence across the warp -> ascending by lane.
__device__ __forceinline__ u64 warp_merge(u64 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 y = __shfl_xor_sync(FULL, x, stride);
    x = (lane & stride) == 0 ? min64(x, y) : max64(x, y);
  }
  return x;
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
sketch_select_kernel(const uint8_t* __restrict__ chunks, int64_t L,
                     int64_t n, int R, Luts luts, int k, uint32_t seed,
                     int use64, int noncanonical, int preserve_case, int m,
                     u64* __restrict__ cand, u64* __restrict__ boundary,
                     int32_t* __restrict__ vcount) {
  __shared__ u64 keys[C];            // m >= FAST_M: the subrow's keys
  __shared__ u64 lists[WARPS][32];   // m < FAST_M: each warp's 32 smallest
  // the subrow's bytes, their complements and their non-alphabet flags, as
  // words so that a thread can read 8 of them at once
  constexpr int SEQ_WORDS = (C + KMAX) / 8 + 1;
  __shared__ u64 seq_w[SEQ_WORDS], comp_w[SEQ_WORDS], bad_w[SEQ_WORDS];
  __shared__ uint8_t alpha[256];
  __shared__ uint8_t comp[256];
  __shared__ int wcount[WARPS];
  uint8_t* seq = reinterpret_cast<uint8_t*>(seq_w);
  uint8_t* cseq = reinterpret_cast<uint8_t*>(comp_w);
  uint8_t* badf = reinterpret_cast<uint8_t*>(bad_w);

  const int r = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t w0 = (int64_t)r * C;  // first window of this subrow
  const uint8_t* row = chunks + b * L;

  for (int i = tid; i < 256; i += THREADS) {
    alpha[i] = luts.alpha[i];
    comp[i] = luts.comp[i];
  }
  __syncthreads();
  // bytes [w0, w0 + C + k - 1) of the row, uppercased; 0 past the row end
  for (int i = tid; i < C + k - 1; i += THREADS) {
    int64_t p = w0 + i;
    uint8_t c = p < L ? row[p] : 0;
    if (!preserve_case) {
      int8_t sc = (int8_t)c;  // the reference compares signed chars
      if (sc > 96 && sc < 123) c = (uint8_t)(c - 32);
    }
    seq[i] = c;
    cseq[i] = comp[c];
    badf[i] = !alpha[c];
  }
  __syncthreads();

  // Rolling state of this thread's windows t0 .. t0 + W - 1: fwd holds the
  // window's bytes little-endian (byte j of the k-mer at bits 8j), rev its
  // reverse complement, bad its count of non-alphabet bytes.  They start
  // as the state one byte short of window t0: bytes t0 .. t0 + k - 2,
  // read 8 at a time (t0 is a multiple of 8), each window then pushes one
  // byte.  Bytes past those are cut off below, or shifted out.
  const int t0 = tid * W;
  const int top = 8 * ((k - 1) & 7);  // bit of byte k-1 in word NW-1
  const u64 topmask = (k & 7) ? (1ull << (8 * (k & 7))) - 1 : ~0ull;
  u64 fwd[NW], rev[NW];
  int bad = 0;
  {
    // fwd: bytes t0 .. t0 + k - 2 at places 1 .. k - 1
    u64 prev = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const u64 w = seq_w[t0 / 8 + i];
      fwd[i] = (w << 8) | (prev >> 56);
      prev = w;
    }
    fwd[NW - 1] &= topmask;
    // rev: complements of bytes t0 + k - 2 .. t0 at places 0 .. k - 2, the
    // 8NW complements from t0 on reversed, then shifted down d bytes
    u64 rw[NW + 1];
#pragma unroll
    for (int i = 0; i < NW; ++i) rw[i] = bswap64(comp_w[t0 / 8 + NW - 1 - i]);
    rw[NW] = 0;
    const int d = 8 * NW - k + 1;  // 1 .. 8
#pragma unroll
    for (int i = 0; i < NW; ++i)
      rev[i] = d == 8 ? rw[i + 1]
                      : (rw[i] >> (8 * d)) | (rw[i + 1] << (64 - 8 * d));
    // bad: the flags of bytes t0 .. t0 + k - 2, one byte each
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int count = k - 1 - 8 * i;  // flags of this word to count
      u64 f = count > 0 ? bad_w[t0 / 8 + i] : 0;
      if (count > 0 && count < 8) f &= (1ull << (8 * count)) - 1;
      bad += (int)((f * 0x0101010101010101ull) >> 56);
    }
  }
  auto push = [&](int p) {
#pragma unroll
    for (int i = 0; i < NW - 1; ++i)
      fwd[i] = (fwd[i] >> 8) | (fwd[i + 1] << 56);
    fwd[NW - 1] = (fwd[NW - 1] >> 8) | ((u64)seq[p] << top);
#pragma unroll
    for (int i = NW - 1; i > 0; --i)
      rev[i] = (rev[i] << 8) | (rev[i - 1] >> 56);
    rev[0] = (rev[0] << 8) | cseq[p];
    rev[NW - 1] &= topmask;
    bad += badf[p];
  };

  u64 key[W];
  int my_valid = 0;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    push(t0 + q + k - 1);
    if (q > 0) bad -= badf[t0 + q - 1];
    bool use_fwd = true;
    if (!noncanonical) {
      // the first 8 bytes almost always decide
      const u64 a = bswap64(fwd[0]), c = bswap64(rev[0]);
      use_fwd = a < c;
      if (a == c) {
        use_fwd = true;
#pragma unroll
        for (int i = NW - 1; i > 0; --i) {
          const u64 ai = bswap64(fwd[i]), ci = bswap64(rev[i]);
          if (ai != ci) use_fwd = ai < ci;
        }
      }
    }
    u64 words[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) words[i] = use_fwd ? fwd[i] : rev[i];
    const u64 h = mmh3_h1<NW>(words, k, seed);
    const bool ok = bad == 0 && w0 + t0 + q < n;
    key[q] = ok ? (use64 ? h : (h & 0xffffffffull)) : ~0ull;
    my_valid += ok;
  }
  const int cnt = (int)__reduce_add_sync(FULL, (unsigned)my_valid);
  if (lane == 0) wcount[warp] = cnt;

  const int64_t out_row = b * R + r;
  if (m < FAST_M) {
    // each lane's keys ascending (odd-even transposition)
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int j = i & 1; j + 1 < W; j += 2) {
        const u64 a = key[j], c = key[j + 1];
        key[j] = min64(a, c);
        key[j + 1] = max64(a, c);
      }
    }
    // the warp's 32 smallest, ascending by lane: merge in each lane's
    // next-smallest key while any lane has one below the list's largest
    u64 list = warp_sort(key[0], false);
#pragma unroll
    for (int q = 1; q < W; ++q) {
      const u64 largest = __shfl_sync(FULL, list, 31);
      if (!__any_sync(FULL, key[q] < largest)) break;
      list = warp_merge(min64(list, warp_sort(key[q], true)));
    }
    lists[warp][lane] = list;
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 1; j < WARPS; ++j)
        list = warp_merge(min64(list, lists[j][31 - lane]));
      if (lane < m) cand[out_row * m + lane] = list;
      if (lane == m) boundary[out_row] = list;
      if (lane == 0) {
        int total = 0;
#pragma unroll
        for (int j = 0; j < WARPS; ++j) total += wcount[j];
        vcount[out_row] = total;
      }
    }
    return;
  }

#pragma unroll
  for (int q = 0; q < W; ++q) keys[t0 + q] = key[q];
  __syncthreads();
  // bitonic sort of the C keys, ascending
  for (int size = 2; size <= C; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < C / 2; p += THREADS) {
        int i = 2 * p - (p & (stride - 1));
        int j = i + stride;
        bool up = (i & size) == 0;
        u64 a = keys[i], c = keys[j];
        if ((a > c) == up) {
          keys[i] = c;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int q = tid; q < m; q += THREADS) cand[out_row * m + q] = keys[q];
  if (tid == 0) {
    boundary[out_row] = keys[m];
    int total = 0;
    for (int j = 0; j < WARPS; ++j) total += wcount[j];
    vcount[out_row] = total;
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
  cudaStream_t s = (cudaStream_t)stream;
  u64* cd = reinterpret_cast<u64*>(cand);
  u64* bd = reinterpret_cast<u64*>(boundary);
#define SKETCH_SELECT_LAUNCH(NW)                                             \
  sketch_select_kernel<NW><<<grid, THREADS, 0, s>>>(                         \
      chunks, L, n, R, luts, k, seed, use64, noncanonical, preserve_case, m, \
      cd, bd, vcount)
  switch ((k + 7) / 8) {
    case 1: SKETCH_SELECT_LAUNCH(1); break;
    case 2: SKETCH_SELECT_LAUNCH(2); break;
    case 3: SKETCH_SELECT_LAUNCH(3); break;
    default: SKETCH_SELECT_LAUNCH(4); break;
  }
#undef SKETCH_SELECT_LAUNCH
  return (int)cudaGetLastError();
}
