// screen_count: add each DB hash's occurrence count in a sorted batch of
// streamed hashes to its int32 count, saturating at 2^31 - 1.
//
// Replaces the Pallas kernel mash_tpu/ops/pallas_screen.py::_make_count_kernel
// (built by _build_count, driven by count_batch / count_batch_cond).  That
// kernel compared hi/lo int32 planes of each 1024-hash DB tile against an
// RW-row window of the batch at a scalar-prefetched offset, so a coverage
// certificate had to guard every batch and an exact sort tier stood behind
// it.  Here the span of the batch that can match a tile is found exactly,
// so there is no window, no certificate and no fallback.
//
// What it computes, for a batch b[n] sorted ascending as uint64 (masked
// lanes are the all-ones EMPTY value, so they sort last), DB hashes db[H]
// sorted ascending and distinct as uint64, and counts c[H]:
//   c[i] <- min(2^31 - 1, c[i] + #{ j : b[j] == db[i] })  for db[i] != EMPTY.
// A real DB hash equal to EMPTY is left alone: masked lanes share its value,
// so the caller counts its valid occurrences separately.
//
// What bounds it on the H100: bytes.  It does O(log) compares per DB hash
// and reads the batch (8 bytes a hash), the DB (8 bytes a hash) and the
// counts (4 bytes read, 4 written) about once.
//
// What the design does about it: one block of 256 threads takes a tile of
// 256 DB hashes, one per thread.  Warp 0 finds the lower bound of the
// tile's first hash and warp 1 the upper bound of its last one, each by a
// 32-way search over the batch in device memory (about 5 rounds of one
// coalesced-ish 32-pivot load for a flush of 6.7e7 hashes).  The tile's
// span is disjoint from the other tiles' spans, so the batch is read about
// once in all.  When the span holds at most 4096 hashes (32 KB) it is
// staged in shared memory, and each thread binary-searches its hash's
// lower and upper bound there; a wider span is searched in device memory.
// Every count is written by one thread, so the result needs no atomics and
// is deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;         // DB hashes (and threads) per block
constexpr int SPAN_SMEM = 4096;   // batch hashes staged in shared memory
constexpr uint64_t EMPTY = ~uint64_t(0);
constexpr int64_t INT32_MAX_ = 2147483647;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// First index in [lo, hi) whose value is >= v (upper == false) or > v
// (upper == true); hi if there is none.  Called by all 32 lanes of a warp
// with the same arguments; every lane returns the answer.
__device__ int64_t warp_search(const uint64_t* __restrict__ a, int64_t lo,
                               int64_t hi, uint64_t v, bool upper) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = min64(lo + (int64_t)(lane + 1) * step - 1, hi - 1);
    const uint64_t x = a[p];
    const unsigned m = __ballot_sync(0xffffffffu, upper ? x > v : x >= v);
    if (m == 0) {
      lo = hi;  // lane 31's pivot is hi - 1
      break;
    }
    const int f = __ffs(m) - 1;
    const int64_t pf = min64(lo + (int64_t)(f + 1) * step - 1, hi - 1);
    const int64_t pprev = min64(lo + (int64_t)f * step - 1, hi - 1);
    hi = pf;
    if (f > 0) lo = pprev + 1;
  }
  const int64_t i = lo + lane;
  bool pr = false;
  if (i < hi) {
    const uint64_t x = a[i];
    pr = upper ? x > v : x >= v;
  }
  const unsigned m = __ballot_sync(0xffffffffu, pr);
  return m ? lo + __ffs(m) - 1 : hi;
}

// First index in [lo, hi) with a[i] >= v (upper == false) or > v.
__device__ __forceinline__ int64_t thread_search(const uint64_t* a,
                                                 int64_t lo, int64_t hi,
                                                 uint64_t v, bool upper) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const uint64_t x = a[mid];
    if (upper ? x <= v : x < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(TILE)
screen_count_kernel(const uint64_t* __restrict__ batch, int64_t n,
                    const uint64_t* __restrict__ db, int64_t H,
                    int32_t* __restrict__ counts) {
  __shared__ uint64_t span[SPAN_SMEM];
  __shared__ int64_t bounds[2];
  const int tid = threadIdx.x;
  const int64_t t0 = (int64_t)blockIdx.x * TILE;
  int64_t last = min64(t0 + TILE, H) - 1;
  // Only the DB's last hash can be EMPTY (the DB is sorted and distinct);
  // it must not pull the batch's masked lanes into the span.
  if (db[last] == EMPTY) --last;
  if (last < t0) return;  // a tile holding only the EMPTY hash

  const int warp = tid >> 5;
  if (warp == 0) {
    const int64_t lo = warp_search(batch, 0, n, db[t0], false);
    if ((tid & 31) == 0) bounds[0] = lo;
  } else if (warp == 1) {
    const int64_t hi = warp_search(batch, 0, n, db[last], true);
    if ((tid & 31) == 0) bounds[1] = hi;
  }
  __syncthreads();
  const int64_t lo = bounds[0];
  const int64_t hi = bounds[1] > lo ? bounds[1] : lo;
  const int64_t len = hi - lo;

  const uint64_t* a = batch + lo;
  if (len <= SPAN_SMEM) {
    for (int64_t j = tid; j < len; j += TILE) span[j] = a[j];
    __syncthreads();
    a = span;
  }
  const int64_t i = t0 + tid;
  if (i > last) return;
  const uint64_t v = db[i];
  const int64_t l = thread_search(a, 0, len, v, false);
  const int64_t add = thread_search(a, l, len, v, true) - l;
  if (add > 0) {
    const int64_t s = (int64_t)counts[i] + add;
    counts[i] = (int32_t)(s > INT32_MAX_ ? INT32_MAX_ : s);
  }
}

}  // namespace

// batch: n uint64 hashes sorted ascending (EMPTY-padded at the top); db: H
// distinct uint64 hashes sorted ascending; counts: H int32, updated in
// place.  Sizes are int64: a flush can exceed 2^31 bytes.  Returns the CUDA
// error of the launch (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int screen_count_launch(const uint64_t* batch, int64_t n,
                                   const uint64_t* db, int64_t H,
                                   int32_t* counts, void* stream) {
  if (n < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || H == 0) return 0;
  const int64_t blocks = (H + TILE - 1) / TILE;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  screen_count_kernel<<<(unsigned)blocks, TILE, 0, (cudaStream_t)stream>>>(
      batch, n, db, H, counts);
  return (int)cudaGetLastError();
}
