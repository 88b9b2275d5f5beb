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
// What bounds it on the H100: bytes in principle, integer instructions in
// practice.  A window reads 1 byte and writes 9 (an int64 hash and a bool):
// [32, 1 MiB] at k = 21 moves 0.100 ms of bytes at 3.35 TB/s.  But its
// hash alone is 46 instructions on the FMA pipe and 46 on the ALU pipe
// (sm_90a SASS), and the rolling, the strand choice and the per-item work
// (first state, staging, stores) add about as many again, mostly on the
// ALU pipe (64 lanes an SM): the ALU instructions a window, not the bytes,
// set this kernel's time (PERF.md gives the counts).
//
// What the design does about it:
//   - Rolled windows.  A thread takes R consecutive windows of one row,
//     builds its first state once from 8-byte shared loads, and then rolls:
//     the forward words shift one byte down and take the new byte on top,
//     the reverse-complement words shift one byte up and take its
//     complement at the bottom, and the last non-alphabet byte's place is
//     kept, so a window is valid when that place lies before it.  A window
//     costs three byte loads, ceil(k/8) word shifts per strand, and one
//     byte-swapped word compare (memcmp order; the rest only on a tie).
//   - Bytes read once.  A work item is TILE windows of a row; its
//     TILE + k - 1 bytes come in as 16-byte loads of the aligned chunks
//     that cover them (ragged row starts included: the shared copy keeps
//     the chunks' alignment, and the edge chunks are read byte by byte).
//     Each byte goes through three 256-entry tables once: uppercase,
//     complement and non-alphabet flag, with the case rule folded in.
//     The next item's chunk is loaded before this item is hashed.
//   - Coalesced, wide stores.  The tile's hashes and flags are staged in
//     shared memory and written out as 16-byte hash pairs and 4-flag words
//     where the global address allows, single elements at the edges, at
//     64-bit offsets b * n + w.
//   - k is a template parameter (64 instances: k 1-32, canonical or not),
//     so every mask and shift and the hash's block and tail structure are
//     constants, not per-window work.
//   - A persistent grid.  SMs x resident blocks (the occupancy API, asked
//     once a kernel and device) loop over the (row, tile) items, so the
//     tables are staged once a block, any B works, and a one-row 1 MiB
//     launch (512 items) fills the card.

#include <array>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "mmh3.cuh"  // u64, mmh3_h1, bswap64

namespace {

constexpr int THREADS = 256;
// Resident blocks an SM must be able to hold (ptxas caps registers to fit):
// 3 keeps every instance unspilled; 4 made some spill, and with no bound
// only 2 blocks fit, which ran slower on the H100.
constexpr int MIN_BLOCKS = 3;
constexpr int R = 8;                   // consecutive windows a thread
constexpr int TILE = THREADS * R;      // windows a work item
constexpr int KMAX = 32;
// an item's bytes span at most TILE / 16 + 3 chunks of 16: one a thread
static_assert(TILE / 16 + 3 <= THREADS, "a chunk a thread");
// staged bytes: the item's chunks (up to 15 bytes before its first byte,
// its TILE + k - 1 bytes), and the words past them that a thread's first
// state reads
constexpr int STAGE_BYTES = TILE + 48 + 96;
constexpr int STAGE_WORDS = STAGE_BYTES / 8;
// hash staging: one pad slot every 16, so that a warp's stores of its
// lanes' q-th windows (R apart) fall in distinct bank pairs
constexpr int OUT_SLOTS = TILE + TILE / 16;
constexpr int MAX_DEVICES = 64;

struct Luts {
  uint8_t alpha[256];  // 1 if the byte is in the alphabet
  uint8_t comp[256];   // complement byte of alphabet members, else 0
};

__device__ __forceinline__ int out_slot(int j) { return j + (j >> 4); }

// One work item: TILE windows of row b.
struct Item {
  int64_t b, w0;      // row, first window
  const uint8_t* g;   // the item's first byte
  int span;           // bytes its windows read
  int mis;            // g's offset in its 16-byte chunk
};

__device__ __forceinline__ Item item_at(int64_t b, int64_t tile,
                                        const uint8_t* seq, int64_t L,
                                        int k) {
  Item it;
  it.b = b;
  it.w0 = tile * TILE;
  it.g = seq + it.b * L + it.w0;
  const int64_t left = L - it.w0;
  it.span = left < TILE + k - 1 ? (int)left : TILE + k - 1;
  it.mis = (int)(reinterpret_cast<uintptr_t>(it.g) & 15);
  return it;
}

// Chunk c (16 bytes, 16-byte aligned) of the bytes that cover an item, 0
// outside the item's span: one 16-byte load when the chunk lies inside it.
__device__ __forceinline__ uint4 load_chunk(const Item& it, int c) {
  uint4 x = make_uint4(0, 0, 0, 0);
  const int lo = 16 * c - it.mis;  // the chunk's first byte, from it.g
  if (lo >= it.span) return x;
  if (lo >= 0 && lo + 16 <= it.span)
    return __ldg(reinterpret_cast<const uint4*>(it.g + lo));
  uint32_t w[4] = {0, 0, 0, 0};
  for (int j = 0; j < 16; ++j) {
    const int p = lo + j;
    if (p >= 0 && p < it.span) w[j >> 2] |= (uint32_t)it.g[p] << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The tables of 4 bytes packed in a word, packed the same way.
__device__ __forceinline__ void map4(uint32_t x, const uint8_t* up,
                                     const uint8_t* cp, const uint8_t* bad,
                                     uint32_t& u, uint32_t& c, uint32_t& f) {
  uint32_t a[4], b[4], d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t byte = __byte_perm(x, 0, 0x4440 | j);
    a[j] = up[byte];
    b[j] = cp[byte];
    d[j] = bad[byte];
  }
  u = __byte_perm(__byte_perm(a[0], a[1], 0x0040),
                  __byte_perm(a[2], a[3], 0x0040), 0x5410);
  c = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                  __byte_perm(b[2], b[3], 0x0040), 0x5410);
  f = __byte_perm(__byte_perm(d[0], d[1], 0x0040),
                  __byte_perm(d[2], d[3], 0x0040), 0x5410);
}

// N little-endian words of a staged array from byte s on (any s).
template <int N>
__device__ __forceinline__ void words_at(const u64* w, int s,
                                         u64 (&out)[N]) {
  const int a = s >> 3, r = 8 * (s & 7);
  u64 lo = w[a];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const u64 hi = w[a + i + 1];
    out[i] = r ? (lo >> r) | (hi << (64 - r)) : lo;
    lo = hi;
  }
}

template <int K, bool CANON>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
hash_windows_kernel(const uint8_t* __restrict__ seq, int64_t B, int64_t L,
                    int64_t n, int64_t tiles, Luts luts, uint32_t seed,
                    int use64, int preserve_case, u64* __restrict__ hashes,
                    uint8_t* __restrict__ valid) {
  constexpr int k = K, NW = (K + 7) / 8;
  __shared__ __align__(16) u64 seq_w[STAGE_WORDS];
  __shared__ __align__(16) u64 comp_w[STAGE_WORDS];
  __shared__ __align__(16) u64 bad_w[STAGE_WORDS];
  __shared__ __align__(16) u64 out_h[OUT_SLOTS];
  __shared__ __align__(16) uint32_t out_v[TILE / 4 + 1];
  __shared__ uint8_t t_up[256], t_cp[256], t_bad[256];
  uint8_t* sb = reinterpret_cast<uint8_t*>(seq_w);
  uint8_t* cb = reinterpret_cast<uint8_t*>(comp_w);
  uint8_t* fb = reinterpret_cast<uint8_t*>(bad_w);
  const uint8_t* ob = reinterpret_cast<const uint8_t*>(out_v);

  const int tid = threadIdx.x;
  // the tables with the case rule folded in: uppercase (on the signed
  // byte), then complement and non-alphabet flag of the uppercased byte
  for (int c = tid; c < 256; c += THREADS) {
    const int8_t sc = (int8_t)c;  // the reference compares signed chars
    const int u = (!preserve_case && sc > 96 && sc < 123) ? c - 32 : c;
    t_up[c] = (uint8_t)u;
    t_cp[c] = luts.comp[u];
    t_bad[c] = !luts.alpha[u];
  }

  constexpr int top = 8 * ((k - 1) & 7);  // bit of byte k-1 in word NW-1
  constexpr u64 topmask = (k & 7) ? (1ull << (8 * (k & 7))) - 1 : ~0ull;
  constexpr int d = 8 * NW - k + 1;       // rev's first-state shift, 1 .. 8
  const int t0 = tid * R;  // this thread's first window
  // this block's items: row b, tile t, then gridDim.x items on, as a
  // step of db rows and dt tiles (no division in the loop)
  int64_t b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
  const int64_t db = gridDim.x / tiles, dt = gridDim.x - db * tiles;
  uint4 chunk = make_uint4(0, 0, 0, 0);  // this thread's chunk of an item
  Item it;
  if (b < B) {
    it = item_at(b, t, seq, L, k);
    chunk = load_chunk(it, tid);
  }
  while (b < B) {
    __syncthreads();  // tables staged; the previous item's shared reads done
    if (16 * tid < it.mis + it.span) {
      uint4 u, c, f;
      map4(chunk.x, t_up, t_cp, t_bad, u.x, c.x, f.x);
      map4(chunk.y, t_up, t_cp, t_bad, u.y, c.y, f.y);
      map4(chunk.z, t_up, t_cp, t_bad, u.z, c.z, f.z);
      map4(chunk.w, t_up, t_cp, t_bad, u.w, c.w, f.w);
      reinterpret_cast<uint4*>(sb)[tid] = u;
      reinterpret_cast<uint4*>(cb)[tid] = c;
      reinterpret_cast<uint4*>(fb)[tid] = f;
    }
    const Item cur = it;
    __syncthreads();
    // the next item's chunk is in flight while this one is hashed
    t += dt;
    b += db;
    if (t >= tiles) {
      t -= tiles;
      ++b;
    }
    if (b < B) {
      it = item_at(b, t, seq, L, k);
      chunk = load_chunk(it, tid);
    }

    const int64_t left = n - cur.w0;  // windows of the row from w0 on
    const int cnt = left < TILE ? (int)left : TILE;
    if (t0 < cnt) {
      // Rolling state one byte short of window t0: fwd holds bytes
      // s0 .. s0 + k - 2 at places 1 .. k - 1 (little-endian, byte j of the
      // k-mer at bits 8j), rev their complements reversed at places
      // 0 .. k - 2, last_bad the place (from window t0) of the last
      // non-alphabet byte, -1 if none.  Each window pushes one byte.
      const int s0 = cur.mis + t0;
      u64 fwd[NW], rev[NW];
      int last_bad = -1;
      {
        u64 x[NW];
        words_at<NW>(seq_w, s0, x);
        u64 prev = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          fwd[i] = (x[i] << 8) | (prev >> 56);
          prev = x[i];
        }
        fwd[NW - 1] &= topmask;
        if constexpr (CANON) {
          words_at<NW>(comp_w, s0, x);
          u64 rw[NW + 1];
#pragma unroll
          for (int i = 0; i < NW; ++i) rw[i] = bswap64(x[NW - 1 - i]);
          rw[NW] = 0;
#pragma unroll
          for (int i = 0; i < NW; ++i)
            rev[i] = d == 8 ? rw[i + 1]
                            : (rw[i] >> (8 * d)) | (rw[i + 1] << (64 - 8 * d));
        }
        words_at<NW>(bad_w, s0, x);
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int count = k - 1 - 8 * i;  // flags of this word to read
          u64 f = count > 0 ? x[i] : 0;
          if (count > 0 && count < 8) f &= (1ull << (8 * count)) - 1;
          if (f) last_bad = 8 * i + (63 - __clzll((long long)f)) / 8;
        }
      }
      uint32_t flags[R / 4] = {};
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int p = s0 + q + k - 1;  // the byte this window pushes
#pragma unroll
        for (int i = 0; i < NW - 1; ++i)
          fwd[i] = (fwd[i] >> 8) | (fwd[i + 1] << 56);
        fwd[NW - 1] = (fwd[NW - 1] >> 8) | ((u64)sb[p] << top);
        if (fb[p]) last_bad = q + k - 1;
        bool use_fwd = true;
        if constexpr (CANON) {
#pragma unroll
          for (int i = NW - 1; i > 0; --i)
            rev[i] = (rev[i] << 8) | (rev[i - 1] >> 56);
          rev[0] = (rev[0] << 8) | cb[p];
          rev[NW - 1] &= topmask;
          // memcmp(fwd, rev) <= 0; the first 8 bytes almost always decide
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
        out_h[out_slot(t0 + q)] = use64 ? h : (h & 0xffffffffull);
        flags[q >> 2] |= (uint32_t)(last_bad < q) << (8 * (q & 3));
      }
#pragma unroll
      for (int i = 0; i < R / 4; ++i) out_v[t0 / 4 + i] = flags[i];
    }
    __syncthreads();

    // the item's cnt hashes and flags, from global element o0 on
    const int64_t o0 = cur.b * n + cur.w0;
    u64* hg = hashes + o0;
    // a hash pair is one 16-byte store where hg + i is 16-byte aligned
    const int lead = (int)((reinterpret_cast<uintptr_t>(hg) >> 3) & 1);
    const int pairs = (cnt - lead) >> 1;
    for (int i = tid; i < pairs; i += THREADS) {
      const int j = lead + 2 * i;
      ulonglong2 v2;
      v2.x = out_h[out_slot(j)];
      v2.y = out_h[out_slot(j + 1)];
      reinterpret_cast<ulonglong2*>(hg + j)[0] = v2;
    }
    if (tid == 0 && lead) hg[0] = out_h[0];
    if (tid == 1 && ((cnt - lead) & 1)) hg[cnt - 1] = out_h[out_slot(cnt - 1)];
    // the flags four to a store where vg + i is 4-byte aligned
    uint8_t* vg = valid + o0;
    int vlead = (int)((4 - (reinterpret_cast<uintptr_t>(vg) & 3)) & 3);
    if (vlead > cnt) vlead = cnt;
    const int quads = (cnt - vlead) >> 2;
    const int sh = 8 * vlead;  // the flags' offset in the staged words
    for (int i = tid; i < quads; i += THREADS) {
      const uint32_t lo = out_v[i], hi = out_v[i + 1];
      reinterpret_cast<uint32_t*>(vg + vlead)[i] =
          sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
    }
    const int tail = vlead + 4 * quads;
    if (tid < vlead) vg[tid] = ob[tid];
    if (tid >= 4 && tid - 4 < cnt - tail)
      vg[tail + tid - 4] = ob[tail + tid - 4];
  }
}

// Blocks of a persistent grid for one kernel on the current device:
// SMs x resident blocks, asked once a kernel and device.
template <int K, bool CANON>
int persistent_blocks(int* blocks) {
  static int per_sm[MAX_DEVICES];
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    int s = 0, b = 0;
    e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, hash_windows_kernel<K, CANON>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (b < 1) return (int)cudaErrorInvalidConfiguration;
    sms[dev] = s;
    per_sm[dev] = b;
  }
  *blocks = sms[dev] * per_sm[dev];
  return 0;
}

template <int K, bool CANON>
int launch(const uint8_t* seq, int64_t B, int64_t L, int64_t n,
           const Luts& luts, uint32_t seed, int use64, int preserve_case,
           u64* hashes, uint8_t* valid, cudaStream_t s) {
  int blocks = 0;
  const int status = persistent_blocks<K, CANON>(&blocks);
  if (status != 0) return status;
  const int64_t tiles = (n + TILE - 1) / TILE;
  const int64_t items = B * tiles;
  const int grid = items < blocks ? (int)items : blocks;
  hash_windows_kernel<K, CANON><<<grid, THREADS, 0, s>>>(
      seq, B, L, n, tiles, luts, seed, use64, preserve_case, hashes, valid);
  return (int)cudaGetLastError();
}

// launch<k, canonical> and persistent_blocks<k, canonical>, k = 1 .. KMAX
struct Entry {
  int (*launch)(const uint8_t*, int64_t, int64_t, int64_t, const Luts&,
                uint32_t, int, int, u64*, uint8_t*, cudaStream_t);
  int (*blocks)(int*);
};
template <int... I>
constexpr std::array<std::array<Entry, 2>, sizeof...(I)> entry_table(
    std::integer_sequence<int, I...>) {
  return {{{Entry{launch<I + 1, false>, persistent_blocks<I + 1, false>},
            Entry{launch<I + 1, true>, persistent_blocks<I + 1, true>}}...}};
}
constexpr auto kEntries = entry_table(std::make_integer_sequence<int, KMAX>{});

}  // namespace

extern "C" int hash_windows_launch(const uint8_t* seq, int64_t B, int64_t L,
                                   const uint8_t* alpha_lut,
                                   const uint8_t* comp_lut, int k,
                                   uint32_t seed, int use64, int noncanonical,
                                   int preserve_case, uint64_t* hashes,
                                   uint8_t* valid, void* stream) {
  if (k < 1 || k > KMAX || B < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = L - k + 1;
  if (n < 1) return (int)cudaErrorInvalidValue;
  Luts luts;
  for (int i = 0; i < 256; ++i) {
    luts.alpha[i] = alpha_lut[i];
    luts.comp[i] = comp_lut[i];
  }
  return kEntries[k - 1][noncanonical ? 0 : 1].launch(
      seq, B, L, n, luts, seed, use64, preserve_case,
      reinterpret_cast<u64*>(hashes), valid, (cudaStream_t)stream);
}

// The persistent grid's blocks (SMs x resident blocks) of the kernel for
// k and noncanonical on the current device, or -1 on an error.
extern "C" int hash_windows_grid(int k, int noncanonical) {
  int blocks = 0;
  if (k < 1 || k > KMAX ||
      kEntries[k - 1][noncanonical ? 0 : 1].blocks(&blocks) != 0)
    return -1;
  return blocks;
}
