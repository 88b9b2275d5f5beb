// fold_sorted: rows of sorted segments -> bottom-s states (K6).
//
// Replaces the jax.jit functions mash_tpu/ops/sketch_ops.py::_fold_sorted
// (:52), merge_states (:233) and tree_merge (:243), and the fold tail of
// mash_tpu/ops/pallas_sketch.py::sketch_chunks_pallas (:532-553), which
// folds the Pallas kernel's candidates and checks the exactness
// certificate.  None of them is a pallas_call: XLA fuses each into a few
// device loops (sort, prefix sums, top_k, gathers).
//
// What it computes, for each of B rows made of G segments of width W, each
// segment sorted ascending in unsigned order (uint64 hash bit patterns,
// int64 counts beside them; an entry with count 0 is EMPTY = 2^64-1 and
// sorts last): the s smallest distinct hashes of the row, each with the
// summed counts of its entries, and EMPTY / 0 in the slots past them and
// wherever a sum is 0.  That is _fold_sorted(sort(concat(segments)))
// (ops/fold_kernel.py::fold_sorted_plain), bit for bit.  Distinctness is by
// hash alone and emptiness is a count of 0, never the hash EMPTY, so a real
// hash 2^64-1 with a count above 0 sums with the EMPTY padding into one run
// that is kept, as the plain fold keeps it.
//
// With boundary and vcount (K1's candidates: G = R subrows of W = m
// candidates, a count of 1 for each candidate other than EMPTY), the kernel
// also checks the certificate of ops/sketch_kernel.py::
// sketch_chunks_deferred on the row's own state and writes bad[b]; a row
// without it comes out EMPTY / 0.
//
// What bounds it on the H100: bytes in principle (each entry read once, 16
// bytes, and 16 bytes a kept slot written: microseconds at 3.35 TB/s).  In
// practice a launch has few rows (one for a merge, five for a sketch
// batch), one block each, so most SMs idle and the time is each block's
// chain of barriers and dependent loads, a few microseconds a tile.
//
// What the design does about it (a simple kernel that is right first):
//   1. The block walks its row in tiles of TILE entries staged in shared
//      memory.  One block scan a tile gives each entry its run (a head
//      starts a run where the hash differs from its left neighbour or a
//      segment starts) and the prefix of the counts; the head of each of a
//      segment's first s runs writes its hash, the last entry of the run its
//      summed count, into the segment's list in scratch.  A segment that
//      has s runs before the tile's end is skipped to its end, so a single
//      sorted row (G = 1) is read only up to the end of its s-th run, and
//      the rest of a segment that one run fills (a short row's EMPTY
//      padding) has only its counts summed.
//   2. Pairs of lists merge, round by round, into one list.  A thread takes
//      RUN consecutive positions of a pair's merged order (a merge-path
//      search, then a two-way merge); the lists are distinct, so a hash is
//      in both at most once, and the second list's copy is folded into the
//      first's, counts summed.  A block scan of each chunk's folded copies
//      gives every kept hash its rank among the pair's distinct hashes;
//      ranks >= s are dropped.  This is exact because the bottom-s merge is
//      associative: a hash of the final bottom s is in the bottom s of
//      every part that holds it, so no cut drops one of its occurrences.
//   3. The last list goes out, masked (and the certificate checked).
// Lists live in scratch memory that the caller allocates (two buffers of
// G * min(W, s) entries a row, ping-ponged), so any G, W and s >= 1 fit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
typedef long long i64;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;  // consecutive entries a thread scans in a tile
constexpr int TILE = THREADS * ITEMS;
constexpr int RUN = 8;    // merged positions a thread takes in a merge
constexpr u64 EMPTY = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

struct Pair {
  i64 a, b;
};
__device__ __forceinline__ Pair operator+(Pair x, Pair y) {
  return {x.a + y.a, x.b + y.b};
}
__device__ __forceinline__ Pair operator-(Pair x, Pair y) {
  return {x.a - y.a, x.b - y.b};
}
__device__ __forceinline__ int shfl_up(int x, int d) {
  return __shfl_up_sync(FULL, x, d);
}
__device__ __forceinline__ i64 shfl_up(i64 x, int d) {
  return __shfl_up_sync(FULL, x, d);
}
__device__ __forceinline__ Pair shfl_up(Pair x, int d) {
  return {__shfl_up_sync(FULL, x.a, d), __shfl_up_sync(FULL, x.b, d)};
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = x + y;
  }
  return x;
}

// Exclusive prefix sum of x over the block's threads in thread order; the
// block's total in *total.  buf: shared T[WARPS + 1].  Every thread calls.
template <typename T>
__device__ T block_exclusive_sum(T x, T* total, T* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_sum(x);
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < WARPS ? buf[lane] : T{};
    const T wi = warp_inclusive_sum(w);
    if (lane < WARPS) buf[lane] = wi - w;
    if (lane == 31) buf[WARPS] = wi;
  }
  __syncthreads();
  const T out = buf[warp] + (incl - x);
  *total = buf[WARPS];
  __syncthreads();  // buf may be reused at once
  return out;
}

__device__ u64 block_min(u64 x, u64* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const u64 y = __shfl_down_sync(FULL, x, d);
    x = y < x ? y : x;
  }
  if (lane == 0) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < WARPS ? buf[lane] : EMPTY;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const u64 y = __shfl_down_sync(FULL, x, d);
      x = y < x ? y : x;
    }
    if (lane == 0) buf[WARPS] = x;
  }
  __syncthreads();
  x = buf[WARPS];
  __syncthreads();
  return x;
}

// Scratch of one row: hash and count buffers of n0 = G * min(W, s) entries,
// twice; a round's duplicates before each chunk (at most n0 + 1 ints); the
// lists' lengths, twice.
__host__ __device__ inline int64_t row_bytes(int64_t G, int64_t n0) {
  return (32 * n0 + 4 * (n0 + 1) + 8 * G + 15) / 16 * 16;
}

__global__ void __launch_bounds__(THREADS)
fold_sorted_kernel(const u64* __restrict__ hin, const i64* __restrict__ cin,
                   int64_t G, int64_t W, int s,
                   const u64* __restrict__ boundary,
                   const int32_t* __restrict__ vcount, u64* __restrict__ hout,
                   i64* __restrict__ cout, uint8_t* __restrict__ bad,
                   unsigned char* __restrict__ scratch) {
  __shared__ u64 sk[TILE + 2];   // a tile's hashes and their two neighbours
  __shared__ i64 sc[TILE];       // a tile's counts
  __shared__ int segbase[TILE];  // runs before each segment that starts
                                 // here, less those before the tile
  __shared__ Pair pbuf[WARPS + 1];
  __shared__ i64 lbuf[WARPS + 1];
  __shared__ int ibuf[WARPS + 1];
  __shared__ u64 ubuf[WARPS + 1];
  __shared__ int64_t tile0, base_runs, last_r, last_g;
  __shared__ Pair carry;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t L = G * W;
  const int64_t stride0 = W < s ? W : s;
  const int64_t n0 = G * stride0;
  unsigned char* mine = scratch + b * row_bytes(G, n0);
  u64* key[2] = {reinterpret_cast<u64*>(mine),
                 reinterpret_cast<u64*>(mine) + n0};
  i64* cnt[2] = {reinterpret_cast<i64*>(mine) + 2 * n0,
                 reinterpret_cast<i64*>(mine) + 3 * n0};
  int* E = reinterpret_cast<int*>(mine + 32 * n0);
  int* len[2] = {E + n0 + 1, E + n0 + 1 + G};
  const u64* h = hin + b * L;
  const i64* c = cin ? cin + b * L : nullptr;

  for (int64_t g = tid; g < G; g += THREADS) len[0][g] = 0;
  if (tid == 0) {
    tile0 = 0;
    base_runs = 0;
    carry = Pair{0, 0};
  }
  __syncthreads();

  // 1. each segment -> its first s distinct hashes with summed counts
  while (tile0 < L) {
    const int64_t t0 = tile0;
    const int64_t seg_end = (t0 / W + 1) * W;
    if (t0 % W != 0 && h[t0 - 1] == h[seg_end - 1]) {
      // The rest of the segment continues the run of the entry before
      // it (sorted: all equal), as the EMPTY padding of a short row
      // does: only its counts are summed.
      i64 part = 0;
      if (c) {
        i64 acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int64_t p = t0 + tid;
        for (; p + 7 * THREADS < seg_end; p += 8 * THREADS) {
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += c[p + k * THREADS];
        }
        for (; p < seg_end; p += THREADS) acc[0] += c[p];
#pragma unroll
        for (int k = 0; k < 8; ++k) part += acc[k];
      } else if (tid == 0 && h[t0 - 1] != EMPTY) {
        part = seg_end - t0;
      }
      i64 sum;
      block_exclusive_sum(part, &sum, lbuf);
      if (tid == 0) {
        const int64_t g = t0 / W, r = carry.a - 1 - base_runs;
        if (r < s) {
          const int64_t slot = g * stride0 + r;
          cnt[0][slot] = carry.b + sum - cnt[0][slot];
        }
        len[0][g] = (int)(r + 1 < s ? r + 1 : s);
        carry.b += sum;
        tile0 = seg_end;
      }
      __syncthreads();
      continue;
    }
    const int64_t t1 = t0 + TILE < L ? t0 + TILE : L;
    const int n = (int)(t1 - t0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {  // the loads first, then the stores
      const int i = k * THREADS + tid;
      if (i < n) {
        const u64 x = h[t0 + i];
        sk[i + 1] = x;
        sc[i] = c ? c[t0 + i] : (i64)(x != EMPTY);
      }
    }
    // the neighbours, read only inside a segment
    if (tid == 0) sk[0] = t0 > 0 ? h[t0 - 1] : 0;
    if (tid == THREADS - 1) sk[n + 1] = t1 < L ? h[t1] : 0;
    __syncthreads();
    const Pair before = carry;  // runs and counts before the tile
    const int i0 = tid * ITEMS;
    const int64_t p0 = t0 + i0;
    int64_t g0 = p0 / W, off0 = p0 - g0 * W;
    bool head[ITEMS];
    Pair mine_sum{0, 0};  // (heads, counts) of this thread's entries
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = i0 + k;
      const int64_t off = off0 + k;  // may pass W: only == 0 matters
      head[k] = i < n && ((off % W) == 0 || sk[i + 1] != sk[i]);
      if (i < n) mine_sum = mine_sum + Pair{head[k], sc[i]};
    }
    Pair total;
    Pair run = before + block_exclusive_sum(mine_sum, &total, pbuf);
    Pair incl[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = i0 + k;
      if (i < n) run = run + Pair{head[k], sc[i]};
      incl[k] = run;  // runs started and counts summed up to this entry
      if (i < n && ((off0 + k) % W) == 0)
        segbase[i] = (int)(run.a - 1 - before.a);
    }
    __syncthreads();
    int64_t r[ITEMS], slot[ITEMS];
    int64_t g = g0, off = off0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = i0 + k;
      r[k] = s;
      if (i < n) {
        const int64_t start = g * W;
        const int64_t base =
            start >= t0 ? before.a + segbase[start - t0] : base_runs;
        r[k] = incl[k].a - 1 - base;  // the entry's run in its segment
        slot[k] = g * stride0 + r[k];
        if (r[k] < s && head[k]) {
          key[0][slot[k]] = sk[i + 1];
          cnt[0][slot[k]] = incl[k].b - sc[i];  // counts before the run
        }
        if (off == W - 1) len[0][g] = (int)(r[k] + 1 < s ? r[k] + 1 : s);
        if (i == n - 1) {
          last_r = r[k];
          last_g = g;
        }
      }
      if (++off == W) {
        off = 0;
        ++g;
      }
    }
    __syncthreads();
    off = off0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = i0 + k;
      const int64_t p = t0 + i;
      const bool last = i < n && (p + 1 == L || off == W - 1 ||
                                  sk[i + 2] != sk[i + 1]);
      if (last && r[k] < s) cnt[0][slot[k]] = incl[k].b - cnt[0][slot[k]];
      if (++off == W) off = 0;
    }
    __syncthreads();
    if (tid == 0) {
      carry = carry + total;
      int64_t next = t1;
      const int64_t end = (last_g + 1) * W;
      if (last_r >= s && end > t1) {  // the segment has its s runs
        len[0][last_g] = s;
        next = end;
      }
      if (next % W != 0) {  // the next tile starts inside a segment
        const int64_t start = next / W * W;
        if (start >= t0) base_runs = before.a + segbase[start - t0];
      }
      tile0 = next;
    }
    __syncthreads();
  }

  // 2. merge pairs of lists, round by round
  int cur = 0;
  int64_t lists = n0 > 0 ? G : 1, stride = stride0;
  while (lists > 1) {
    const int64_t pairs = lists >> 1;
    const int64_t nstride = 2 * stride < s ? 2 * stride : s;
    const u64* K = key[cur];
    const i64* Cn = cnt[cur];
    const int* Ln = len[cur];
    u64* K2 = key[cur ^ 1];
    i64* C2 = cnt[cur ^ 1];
    // A pair's merged order (its first list first among equal hashes)
    // in chunks of RUN positions, a thread a chunk: the chunk's start
    // found by a merge-path search, then RUN steps of a two-way merge.
    // A hash of the second list equal to the first's is folded into it
    // (a duplicate); a block scan of the chunks' duplicates gives each
    // kept hash its rank among the pair's distinct hashes.
    const int64_t per_pair = (2 * stride + RUN - 1) / RUN;
    const int64_t chunks = pairs * per_pair;
    int carry_dups = 0;
    for (int64_t tile = 0; tile < chunks; tile += THREADS) {
      const int64_t chunk = tile + tid;
      const int64_t p = chunk / per_pair;
      const int64_t k0 = (chunk - p * per_pair) * RUN;
      const u64* A = K + 2 * p * stride;
      const u64* Bl = A + stride;
      const i64* CA = Cn + 2 * p * stride;
      const i64* CB = CA + stride;
      const int la = chunk < chunks ? Ln[2 * p] : 0;
      const int lb = chunk < chunks ? Ln[2 * p + 1] : 0;
      const int64_t total_len = la + lb;
      u64 v[RUN];
      i64 cv[RUN];
      unsigned kept = 0;  // bit r: position k0 + r is a kept hash
      int dups = 0;
      if (k0 < total_len) {
        // the number of the first list's entries among the first k0
        int lo = k0 > lb ? (int)(k0 - lb) : 0;
        int hi = k0 < la ? (int)k0 : la;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (A[mid] <= Bl[k0 - mid - 1])
            lo = mid + 1;
          else
            hi = mid;
        }
        int i = lo, j = (int)(k0 - lo);
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
          if (k0 + r < total_len) {
            const bool from_a = j >= lb || (i < la && A[i] <= Bl[j]);
            if (from_a) {
              v[r] = A[i];
              cv[r] = CA[i];
              if (j < lb && Bl[j] == v[r]) cv[r] += CB[j];
              ++i;
              kept |= 1u << r;
            } else {
              v[r] = Bl[j];
              if (i > 0 && A[i - 1] == v[r]) {
                ++dups;  // summed into the first list's entry
              } else {
                cv[r] = CB[j];
                kept |= 1u << r;
              }
              ++j;
            }
          }
        }
      }
      int tile_dups;
      const int before = carry_dups +
                         block_exclusive_sum(dups, &tile_dups, ibuf);
      if (chunk < chunks) E[chunk] = before;
      carry_dups += tile_dups;
      __syncthreads();
      if (kept) {
        // duplicates before this chunk in its pair
        int64_t rank = k0 - (before - E[p * per_pair]);
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
          if (kept >> r & 1) {
            if (rank < s) {
              K2[p * nstride + rank] = v[r];
              C2[p * nstride + rank] = cv[r];
            }
            ++rank;
          }
        }
      }
    }
    if (tid == 0) E[chunks] = carry_dups;
    if (lists & 1) {  // the odd last list passes through
      const int64_t from = (lists - 1) * stride, to = pairs * nstride;
      for (int64_t i = tid; i < Ln[lists - 1]; i += THREADS) {
        K2[to + i] = K[from + i];
        C2[to + i] = Cn[from + i];
      }
    }
    __syncthreads();
    for (int64_t jn = tid; jn < lists - pairs; jn += THREADS) {
      int64_t l2 = Ln[lists - 1];
      if (jn < pairs) {
        l2 = Ln[2 * jn] + Ln[2 * jn + 1] -
             (E[(jn + 1) * per_pair] - E[jn * per_pair]);
        if (l2 > s) l2 = s;
      }
      len[cur ^ 1][jn] = (int)l2;
    }
    __syncthreads();
    cur ^= 1;
    lists -= pairs;
    stride = nstride;
  }

  // 3. the state, masked; the certificate of K1's candidates
  const int64_t kept = len[cur][0];
  const u64* K = key[cur];
  const i64* Cn = cnt[cur];
  bool drop = false;
  if (boundary) {
    Pair part{0, 0};  // (candidates other than EMPTY, valid windows)
    u64 minb = EMPTY;
    for (int64_t p = tid; p < L; p += THREADS) part.a += h[p] != EMPTY;
    for (int64_t q = tid; q < G; q += THREADS) {
      part.b += vcount[b * G + q];
      const u64 x = boundary[b * G + q];
      minb = x < minb ? x : minb;
    }
    int nd = 0;  // kept hashes with a count above 0
    for (int64_t q = tid; q < kept; q += THREADS) nd += Cn[q] > 0;
    Pair sums;
    block_exclusive_sum(part, &sums, pbuf);
    int ndist;
    block_exclusive_sum(nd, &ndist, ibuf);
    minb = block_min(minb, ubuf);
    const u64 x = kept == s && Cn[s - 1] > 0 ? K[s - 1] : EMPTY;
    const bool covered = ndist >= s && x < minb;
    drop = !(covered || sums.a == sums.b);
    if (tid == 0) bad[b] = drop;
  }
  for (int64_t q = tid; q < s; q += THREADS) {
    u64 hv = EMPTY;
    i64 cv = 0;
    if (!drop && q < kept && Cn[q] > 0) {
      hv = K[q];
      cv = Cn[q];
    }
    hout[b * s + q] = hv;
    cout[b * s + q] = cv;
  }
}

}  // namespace

// Bytes of scratch a row needs (the caller allocates B times this).
extern "C" int64_t fold_sorted_scratch_bytes(int64_t G, int64_t W, int s) {
  if (G < 1 || W < 0 || s < 1) return -1;
  return row_bytes(G, G * (W < s ? W : s));
}

// B rows of G sorted segments of width W (hashes h, counts c; c null: a
// count of 1 for each hash other than EMPTY) -> H, C [B, s].  boundary and
// vcount [B * G] (or null): K1's candidates, with the certificate into
// bad [B].  scratch: B * fold_sorted_scratch_bytes(G, W, s) bytes.
extern "C" int fold_sorted_launch(const uint64_t* h, const int64_t* c,
                                  int64_t B, int64_t G, int64_t W, int s,
                                  const uint64_t* boundary,
                                  const int32_t* vcount, uint64_t* H,
                                  int64_t* C, uint8_t* bad, void* scratch,
                                  void* stream) {
  if (B < 1 || B > 0x7fffffff || G < 1 || W < 0 || s < 1 ||
      (boundary != nullptr) != (vcount != nullptr) ||
      (boundary != nullptr && bad == nullptr))
    return (int)cudaErrorInvalidValue;
  // the scan and the search results are ints
  if (G * (W < s ? W : s) >= 0x7fffffff) return (int)cudaErrorInvalidValue;
  fold_sorted_kernel<<<(unsigned)B, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const u64*>(h), reinterpret_cast<const i64*>(c), G, W,
      s, reinterpret_cast<const u64*>(boundary), vcount,
      reinterpret_cast<u64*>(H), reinterpret_cast<i64*>(C), bad,
      static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}
