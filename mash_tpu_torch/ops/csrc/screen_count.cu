// screen_count: DB-hash occurrence counts of `screen`, through a hash table
// of the DB that every valid hash of a batch probes, in any order.
//
// Replaces the Pallas kernel mash_tpu/ops/pallas_screen.py::_make_count_kernel
// (built by _build_count, driven by count_batch / count_batch_cond).  That
// kernel compared hi/lo int32 planes of each 1024-hash DB tile against an
// RW-row window of a sorted batch at a scalar-prefetched offset, so its
// caller sorted every batch, and a coverage certificate with an exact sort
// tier stood behind it.  Here nothing is sorted: the DB goes once into an
// open-addressing table, as the reference keeps a hash table of it
// (CommandScreen.cpp:93-116), and each streamed hash looks itself up.
//
// Two kernels:
//   screen_table_build: a table of S = 2^bits >= 2H slots (load <= 1/2) of
//     uint64 keys, EMPTY (2^64 - 1) when vacant, the int32 DB index of each
//     key, and a one-byte fingerprint of each key (0 when vacant).  A key's
//     home slot is the top `bits` bits of key * MIX (Fibonacci hashing:
//     every key bit reaches the top bits, so 32-bit-mode hashes, whose top
//     half is 0, spread as well), its fingerprint the top byte of
//     key * FP_MIX (1 where that is 0).  An insert claims a slot with a
//     64-bit atomicCAS and probes linearly.  A DB hash equal to EMPTY stays
//     out: the caller counts it.
//   screen_count: for every lane with v set and h != EMPTY, probe the
//     fingerprints from the home slot to a vacant one; where a fingerprint
//     matches, compare the key; on a hit add one to the int64 total of that
//     DB index.  The lanes of a warp that hit the DB hash its first hitting
//     lane hit are added once for all of them, so a stream of one repeated
//     hash does not serialise on one address.  Integer atomics give the same
//     totals in any order.
//
// What bounds it on the H100: bytes.  The batch is read once (8 bytes of
// hash and 1 of validity a lane), and each probe reads at least one 32-byte
// sector of the table, at random.
//
// What the design does about it: no sort and no queue, one pass over the
// batch as the hashing wrote it.  A probe reads the fingerprints, a byte a
// slot, so a run of slots lies in one sector and a RefSeq-scale DB's
// fingerprints (10^7 hashes: 2^25 slots, 32 MB) can stay in the 50 MB L2
// cache; the keys (8 bytes a slot, 268 MB) are read only where a
// fingerprint matches, for hits and 1/255 of the other probes.  Random
// probes are latency-bound, so each thread of a grid sized to the card
// takes E lanes (THREADS apart, so that every load of the batch is
// coalesced) and has the first probes of all E in flight at once (the build
// likewise its first E claims).  Staging a small DB's fingerprints in
// shared memory was measured no faster than reading them through the
// caches, and it cut the blocks an SM holds, so there is no such path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long EMPTY = ~0ull;
constexpr unsigned long long MIX = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long FP_MIX = 0xC2B2AE3D27D4EB4Full;
constexpr int THREADS = 256;
constexpr int E = 8;  // lanes a thread takes at once

__device__ __forceinline__ unsigned long long home(unsigned long long key,
                                                   int bits) {
  return (key * MIX) >> (64 - bits);
}

__device__ __forceinline__ uint8_t fingerprint(unsigned long long key) {
  const unsigned f = (unsigned)((key * FP_MIX) >> 56);
  return (uint8_t)(f ? f : 1);
}

__global__ void __launch_bounds__(THREADS)
screen_table_build_kernel(const unsigned long long* __restrict__ db,
                          int64_t H, int bits,
                          unsigned long long* __restrict__ keys,
                          int32_t* __restrict__ index,
                          uint8_t* __restrict__ fp) {
  const unsigned long long mask = (1ull << bits) - 1;
  const int64_t step = (int64_t)gridDim.x * THREADS * E;
  for (int64_t i0 = (int64_t)blockIdx.x * THREADS * E + threadIdx.x; i0 < H;
       i0 += step) {
    // the first claims of E keys (THREADS apart, so that each load is
    // coalesced) in flight together
    unsigned long long key[E], slot[E], prev[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t i = i0 + (int64_t)j * THREADS;
      key[j] = i < H ? db[i] : EMPTY;
      slot[j] = home(key[j], bits);
      prev[j] = key[j] == EMPTY ? EMPTY
                                : atomicCAS(&keys[slot[j]], EMPTY, key[j]);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (key[j] == EMPTY) continue;
      while (prev[j] != EMPTY) {
        slot[j] = (slot[j] + 1) & mask;
        prev[j] = atomicCAS(&keys[slot[j]], EMPTY, key[j]);
      }
      index[slot[j]] = (int32_t)(i0 + (int64_t)j * THREADS);
      fp[slot[j]] = fingerprint(key[j]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
screen_count_kernel(const unsigned long long* __restrict__ h,
                    const uint8_t* __restrict__ v, int64_t n,
                    const unsigned long long* __restrict__ keys,
                    const int32_t* __restrict__ index,
                    const uint8_t* __restrict__ fp, int bits,
                    unsigned long long* __restrict__ totals) {
  const unsigned long long mask = (1ull << bits) - 1;
  const int lane = threadIdx.x & 31;
  // base is the same for every thread of a block, so all 32 lanes of a
  // warp run each round and meet at the warp intrinsics below
  const int64_t step = (int64_t)gridDim.x * THREADS * E;
  for (int64_t base = (int64_t)blockIdx.x * THREADS * E; base < n;
       base += step) {
    // E lanes THREADS apart, so that each load is coalesced; an invalid
    // lane, or a valid 2^64-1, is EMPTY.  The hash is loaded whatever its
    // validity, so that both loads are in flight at once.
    unsigned long long key[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t i = base + (int64_t)j * THREADS + threadIdx.x;
      const unsigned long long x = i < n ? h[i] : EMPTY;
      key[j] = i < n && v[i] ? x : EMPTY;
    }
    // the first fingerprints of all E lanes in flight together, then each
    // lane's run to its key or a vacant slot
    unsigned long long slot[E];
    uint8_t seen[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      slot[j] = home(key[j], bits);
      seen[j] = key[j] == EMPTY ? 0 : fp[slot[j]];
    }
    int32_t hit[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      hit[j] = -1;
      const uint8_t f = fingerprint(key[j]);
      while (seen[j] != 0) {
        if (seen[j] == f && keys[slot[j]] == key[j]) {
          hit[j] = index[slot[j]];
          break;
        }
        slot[j] = (slot[j] + 1) & mask;
        seen[j] = fp[slot[j]];
      }
    }
    // the lanes that hit what the warp's first hitting lane hit are
    // counted together, across the E rounds while that hash stays the
    // same, and added by lane 0; the others add one each
    int32_t run = -1;
    unsigned run_n = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const unsigned hits = __ballot_sync(0xffffffffu, hit[j] >= 0);
      if (hits == 0) continue;
      const int32_t lead = __shfl_sync(0xffffffffu, hit[j], __ffs(hits) - 1);
      const unsigned same = __ballot_sync(0xffffffffu, hit[j] == lead);
      if (lead != run) {
        if (run_n && lane == 0)
          atomicAdd(&totals[run], (unsigned long long)run_n);
        run = lead;
        run_n = 0;
      }
      run_n += __popc(same);
      if (hit[j] >= 0 && hit[j] != lead) atomicAdd(&totals[hit[j]], 1ull);
    }
    if (run_n && lane == 0)
      atomicAdd(&totals[run], (unsigned long long)run_n);
  }
}

// Blocks of `kernel` that fill the card once (at least one).
template <typename K>
int64_t grid_cap(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem) != cudaSuccess)
    return 0;
  return (int64_t)sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// db: H distinct uint64 hashes; keys: S = 2^bits slots filled with EMPTY;
// index: S int32; fp: S zero bytes.  Inserts every DB hash but EMPTY.
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int screen_table_build_launch(const uint64_t* db, int64_t H,
                                         int bits, uint64_t* keys,
                                         int32_t* index, uint8_t* fp,
                                         void* stream) {
  if (H < 0 || H > 0x7fffffff || bits < 1 || bits > 40 ||
      (int64_t(1) << bits) < 2 * H)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int64_t cap = grid_cap(screen_table_build_kernel, 0);
  if (cap == 0) return (int)cudaGetLastError();
  int64_t blocks = (H + THREADS * E - 1) / (THREADS * E);
  if (blocks > cap) blocks = cap;
  screen_table_build_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned long long*>(db), H, bits,
      reinterpret_cast<unsigned long long*>(keys), index, fp);
  return (int)cudaGetLastError();
}

// h: n uint64 hashes; v: n bytes, nonzero where the hash is valid; keys,
// index and fp: a table built by screen_table_build_launch with `bits`;
// totals: the DB's int64 totals, updated in place.  Sizes are int64: a
// batch can pass 2^31 bytes.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int screen_count_launch(const uint64_t* h, const uint8_t* v,
                                   int64_t n, const uint64_t* keys,
                                   const int32_t* index, const uint8_t* fp,
                                   int bits, int64_t* totals, void* stream) {
  if (n < 0 || bits < 1 || bits > 40) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t cap = grid_cap(screen_count_kernel, 0);
  if (cap == 0) return (int)cudaGetLastError();
  int64_t blocks = (n + THREADS * E - 1) / (THREADS * E);
  if (blocks > cap) blocks = cap;
  const auto* hh = reinterpret_cast<const unsigned long long*>(h);
  const auto* kk = reinterpret_cast<const unsigned long long*>(keys);
  auto* tt = reinterpret_cast<unsigned long long*>(totals);
  screen_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      hh, v, n, kk, index, fp, bits, tt);
  return (int)cudaGetLastError();
}
