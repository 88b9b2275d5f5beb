// pairwise64 / pairwise32: all-pairs (common, denom) of sorted sketches.
//
// Replaces the Pallas kernels mash_tpu/ops/pallas_pairwise.py::_kernel_body
// (two int32 planes per 64-bit hash; built by _build, driven by
// pairwise_common_denom_pallas) and ::_kernel_body32 (one uint32 key plane;
// built by _build32, driven by pairwise_common_denom_keys32 and the
// use64=False branch), as two instantiations of one template.
//
// What it computes, for every (query row, reference row) pair: the first
// n entries of a row are its real values, sorted and distinct (the rest
// are pads and are never read), and the result is the reference's capped
// merge walk (src/mash/CommandDistance.cpp:336-425).  With A, B the real
// parts and U their union, denom = min(cap, |U|) and common = the matches
// among the first cap union elements.  The walk stops as soon as cap union
// elements are consumed (denom = cap), or when a row runs out, where
// |U| = (union elements walked) + (elements left in the other row).  A
// 64-bit value of 2^64-1 never matches, as in the plain version.  Each
// pair is walked once; no element is searched for.
//
// What bounds it on the H100: operations.  A pair reads cap + common
// elements (cap = s to 2s at the main path's full sketches), each a
// dependent compare-and-advance from shared memory; the inputs are only
// (NQ + NR) * s values and stay in the L2 cache.  So the cost is
// instructions issued and shared-memory wavefronts per step, and the
// latency of one step's load where too few walks are in flight.
//
// What the design does about it: two parallel shapes of the same walk.
//
// The thread route (many pairs): one thread walks one pair, Mash's loop
// itself, branch-free at about nine instructions and two shared loads a
// step.  A
// block of 16 warps holds a tile of 32 reference rows, transposed (value j
// of row k at j * 32 + k), so the 32 lanes of a warp, one reference row
// each, read 32 banks at any mix of positions; the warp's query row is a
// plain shared row whose lanes read within a narrow window.  A pair of full
// rows (both sizes >= cap) takes exactly cap steps with no other test, so
// its warp's lanes run in lockstep.  The block stages its reference tile
// once and walks two query tiles, each copied with cp.async (small
// blocks, so that where whole reference tiles are pads the real ones still
// spread over every SM); a tile of pad rows (n = 0) stages no query row.
//
// The warp route (few pairs, or rows too wide for the thread route's
// tile): one warp walks one pair as a merge path, so that a pair's
// latency is a few rounds rather than s steps.  A round merges 32 * E
// positions: each lane finds where its E positions start with a diagonal
// search of the round's window, merges them in registers and marks its
// matches (a B value equal to the A value before it, ties taking A first;
// a lane's first value compares with the A value before its start, read
// from the row).  A warp scan of the match counts gives each match its
// union rank, so matches past the cap are dropped, and the last lane hands
// the cursors to the next round.  Lanes whose positions lie past the cap
// (a match at position p has union rank >= u0 + p / 2) skip their merge;
// a match that straddles the last round's end is resolved after the loop.
// E is odd so that lanes E positions apart spread over the banks.  A block
// stages a tile of query rows and walks a group of reference tiles, each
// staged with cp.async into one of two buffers while the warps walk the
// other; rows too wide for shared memory are read from global memory.
//
// Both routes take a row's size from n, so pads and zero-size rows (the
// stream's row padding) cost no read, and copy only the first n values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_TWO = 110 * 1024;  // two blocks an SM
constexpr int SMEM_ONE = 225 * 1024;  // one block an SM
// the thread route from this many pairs: with fewer, its blocks of 512
// pairs leave SMs idle, and a pair's s dependent steps are the latency
// where the warp route's is a few rounds
constexpr int64_t THREAD_MIN_PAIRS = 1 << 16;

enum Route { AUTO = 0, WARP = 1, THREAD = 2 };

template <typename T>
__device__ __forceinline__ bool is_match(T a, T b) {
  return a == b && (sizeof(T) == 4 || a != ~T(0));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <typename T>
__device__ __forceinline__ void cp_async_value(T* dst, const T* src) {
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of the real values of rows [row0, row0 + rows) into
// shared rows of stride WS (a multiple of 16 bytes), one warp a row.
template <typename T>
__device__ void stage_rows(T* dst, int WS, const T* src, int W,
                           const int32_t* n, int64_t row0, int rows,
                           int warp, int warps, int lane) {
  constexpr int PER = 16 / sizeof(T);
  for (int r = warp; r < rows; r += warps) {
    const T* s = src + (row0 + r) * W;
    T* d = dst + (int64_t)r * WS;
    const int len = min(max(n[row0 + r], 0), W);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      done = len / PER * PER;
      for (int v = lane * PER; v < done; v += 32 * PER)
        cp_async16(d + v, s + v);
    }
    for (int x = done + lane; x < len; x += 32) cp_async_value(d + x, s + x);
  }
}

__device__ __forceinline__ int rows_from(int64_t row0, int tile, int64_t N) {
  return (int)(N - row0 < tile ? N - row0 : tile);
}

// ---- the thread route ---------------------------------------------------

constexpr int TQ = 16;  // query rows a tile: one a warp
constexpr int TR = 32;  // reference rows a tile: one a lane
constexpr int QG = 2;   // query tiles a block

template <typename T>
__device__ __forceinline__ T lds(unsigned addr) {
  T v;
  if constexpr (sizeof(T) == 8)
    asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(addr));
  else
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Mash's loop for one pair by one thread; B's value j is B[j * TR].  A
// step consumes one union value: A's next value, B's, or both on a match.
// It is branch-free, so that a warp's lanes never split: both next values
// are loaded whichever row advanced (a row's slot n is spare, so a load
// never leaves the row); the cursors are 32-bit shared addresses; and the
// matches are counted at the end, as (values consumed) - (steps).
template <typename T>
__device__ __forceinline__ void thread_walk(const T* A, int na, const T* B,
                                            int nb, int cap, int& common,
                                            int& denom) {
  constexpr unsigned SA = sizeof(T), SB = TR * sizeof(T);
  const unsigned a0 = smem_addr(A), b0 = smem_addr(B);
  unsigned ia = a0, ib = b0;
  T a = lds<T>(ia), b = lds<T>(ib);
  int u = 0;
  auto step = [&] {
    const bool ai = a <= b, aj = b < a || is_match(a, b);
    ia += ai ? SA : 0;
    ib += aj ? SB : 0;
    a = lds<T>(ia);
    b = lds<T>(ib);
  };
  if (na >= cap && nb >= cap) {
    // no row runs out before cap union values
#pragma unroll 4
    for (; u < cap; ++u) step();
  } else {
    const unsigned ea = a0 + na * SA, eb = b0 + nb * SB;
    for (; u < cap && ia < ea && ib < eb; ++u) step();
  }
  const int i = (int)((ia - a0) / SA), j = (int)((ib - b0) / SB);
  common = i + j - u;
  denom = u >= cap ? cap : min(cap, u + (na - i) + (nb - j));
}

// Block b walks reference tile b / groups (lane k: reference row k)
// against query tiles [g * QG, (g + 1) * QG), g = b % groups (warp w:
// query row w).  Shared: the reference tile transposed, (W + 1) * TR
// values, then TQ query rows of stride WS >= W + 1.
template <typename T>
__global__ void __launch_bounds__(TQ * 32)
thread_kernel(const T* __restrict__ q, const int32_t* __restrict__ nq,
              int64_t NQ, const T* __restrict__ r,
              const int32_t* __restrict__ nr, int64_t NR, int W, int WS,
              int64_t qtiles, int cap, int32_t* __restrict__ common,
              int32_t* __restrict__ denom) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bt = reinterpret_cast<T*>(smem_raw);
  T* qs = bt + (int64_t)(W + 1) * TR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t groups = (qtiles + QG - 1) / QG;
  const int64_t rrow = (int64_t)(blockIdx.x / groups) * TR + lane;
  const int64_t t0 = (int64_t)(blockIdx.x % groups) * QG;
  const int64_t t1 = t0 + QG < qtiles ? t0 + QG : qtiles;
  const bool rok = rrow < NR;
  const int nb = rok ? min(max(nr[rrow], 0), W) : 0;
  {  // the reference tile, transposed: lane k copies row k
    const T* src = r + (rok ? rrow : 0) * W;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(r) | ((uintptr_t)W * sizeof(T))) & 15)
        == 0;
    if (vec) {
      for (int v = warp; v * VEC < nb; v += TQ) {
        const uint4 x = reinterpret_cast<const uint4*>(src)[v];
        const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) bt[(v * VEC + e) * TR + lane] = xs[e];
      }
    } else {
      for (int x = warp; x < nb; x += TQ) bt[x * TR + lane] = src[x];
    }
  }
  // a tile of pad rows needs no query row
  const bool any = __syncthreads_or(nb > 0);
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t q0 = t * TQ, qrow = q0 + warp;
    const bool qok = qrow < NQ;
    const int na = qok ? min(max(nq[qrow], 0), W) : 0;
    if (any) {
      if (t > t0) __syncthreads();  // the last tile's walks are done
      stage_rows(qs, WS, q, W, nq, q0, rows_from(q0, TQ, NQ), warp, TQ,
                 lane);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (qok && rok) {
      int c, d;
      thread_walk(qs + warp * WS, na, bt + lane, nb, cap, c, d);
      common[qrow * NR + rrow] = c;
      denom[qrow * NR + rrow] = d;
    }
  }
}

// ---- the warp route -----------------------------------------------------

constexpr int WARPS = 8;
constexpr int E = 15;          // merged positions per lane and round
constexpr int ROUND = 32 * E;  // merged positions per warp and round

// The capped merge walk of one pair by one warp; lane 0 gets the result.
template <typename T>
__device__ __forceinline__ void warp_walk(const T* A, int na, const T* B,
                                          int nb, int cap, int lane,
                                          int& common, int& denom) {
  int i0 = 0, j0 = 0;  // cursors: the round starts at A[i0], B[j0]
  int u0 = 0;          // union values before the round
  int cnt = 0;         // this lane's matches within the cap
  while (u0 < cap && i0 < na && j0 < nb) {  // uniform across the warp
    const int remA = na - i0, remB = nb - j0, total = remA + remB;
    const int d = lane * E;
    int i_end = na, j_end = nb;
    unsigned mask = 0;
    // a match at merged position p >= d has union rank >= u0 + p / 2
    if (d < total && u0 + (d >> 1) <= cap) {
      const T* a0 = A + i0;
      const T* b0 = B + j0;
      int lo = max(0, d - remB), hi = min(d, remA);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a0[mid] <= b0[d - 1 - mid]) lo = mid + 1; else hi = mid;
      }
      int i = i0 + lo, j = j0 + d - lo;
      const int steps = min(E, total - d);
      T a = i < na ? A[i] : T(0);
      T b = j < nb ? B[j] : T(0);
      bool has_prev = i > 0;
      T prev = has_prev ? A[i - 1] : T(0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e < steps) {
          if (i < na && (j >= nb || a <= b)) {
            prev = a;
            has_prev = true;
            if (++i < na) a = A[i];
          } else {
            if (has_prev && is_match(b, prev)) mask |= 1u << e;
            if (++j < nb) b = B[j];
          }
        }
      }
      i_end = i;
      j_end = j;
    }
    const int m = __popc(mask);
    int incl = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    // the k-th match (from 1) at position e has union rank rank0 + e - k
    const int rank0 = u0 + d + 1 - (incl - m);
    int k = 0;
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      if (rank0 + (__ffs(mm) - 1) - ++k > cap) break;
      ++cnt;
    }
    u0 += min(ROUND, total) - __shfl_sync(FULL, incl, 31);
    i0 = __shfl_sync(FULL, i_end, 31);
    j0 = __shfl_sync(FULL, j_end, 31);
  }
  cnt = __reduce_add_sync(FULL, cnt);
  if (lane == 0) {
    // a match whose A value ended the last round has union rank u0
    const bool straddle =
        u0 <= cap && i0 > 0 && j0 < nb && is_match(B[j0], A[i0 - 1]);
    common = cnt + straddle;
    denom = u0 >= cap ? cap
                      : min(cap, u0 + (na - i0) + (nb - j0) - (int)straddle);
  }
}

// Block b walks query tile b / groups against reference tiles
// [g * group, (g + 1) * group) with g = b % groups; each warp takes the
// tile's pairs one at a time.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(WARPS * 32)
warp_kernel(const T* __restrict__ q, const int32_t* __restrict__ nq,
            int64_t NQ, const T* __restrict__ r,
            const int32_t* __restrict__ nr, int64_t NR, int W, int WS,
            int tile, int64_t rtiles, int64_t group, int cap,
            int32_t* __restrict__ common, int32_t* __restrict__ denom) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* rs = qs + (int64_t)tile * WS;  // two buffers of `tile` rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t groups = (rtiles + group - 1) / group;
  const int64_t q0 = (int64_t)(blockIdx.x / groups) * tile;
  const int64_t t0 = (int64_t)(blockIdx.x % groups) * group;
  const int64_t t1 = t0 + group < rtiles ? t0 + group : rtiles;
  const int qrows = rows_from(q0, tile, NQ);
  if constexpr (SMEM) {
    stage_rows(qs, WS, q, W, nq, q0, qrows, warp, WARPS, lane);
    stage_rows(rs, WS, r, W, nr, t0 * tile, rows_from(t0 * tile, tile, NR),
               warp, WARPS, lane);
    cp_async_commit();
  }
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t r0 = t * tile;
    const int rrows = rows_from(r0, tile, NR);
    const T* rbuf = rs + ((t - t0) & 1) * (int64_t)tile * WS;
    if constexpr (SMEM) {
      if (t + 1 < t1) {
        stage_rows(rs + ((t - t0 + 1) & 1) * (int64_t)tile * WS, WS, r, W,
                   nr, r0 + tile, rows_from(r0 + tile, tile, NR), warp,
                   WARPS, lane);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    for (int p = warp; p < qrows * rrows; p += WARPS) {
      const int qi = p / rrows, ri = p % rrows;
      const int64_t qrow = q0 + qi, rrow = r0 + ri;
      const int na = min(max(nq[qrow], 0), W);
      const int nb = min(max(nr[rrow], 0), W);
      int c = 0, d = 0;
      if constexpr (SMEM)
        warp_walk(qs + qi * WS, na, rbuf + ri * WS, nb, cap, lane, c, d);
      else
        warp_walk(q + qrow * W, na, r + rrow * W, nb, cap, lane, c, d);
      if (lane == 0) {
        common[qrow * NR + rrow] = c;
        denom[qrow * NR + rrow] = d;
      }
    }
    if constexpr (SMEM) __syncthreads();  // before the buffer is refilled
  }
}

// ---- launch -------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// Raises `kernel`'s dynamic shared memory limit on device `dev` the first
// time a launch there needs more than the default 48 KiB.
template <auto kernel>
cudaError_t allow_smem(int64_t smem, int dev) {
  static int granted[MAX_DEVICES] = {};
  if (smem <= 48 * 1024 || granted[dev] >= smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) granted[dev] = (int)smem;
  return e;
}

template <typename T>
int launch(const T* q, const int32_t* nq, int64_t NQ, const T* r,
           const int32_t* nr, int64_t NR, int64_t W, int cap, int route,
           int32_t* common, int32_t* denom, void* stream) {
  if (NQ < 0 || NR < 0 || W < 1 || W >= (1 << 30) || route < AUTO ||
      route > THREAD)
    return (int)cudaErrorInvalidValue;
  if (NQ == 0 || NR == 0) return 0;
  static int sms_of[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= MAX_DEVICES) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !sms_of[dev])
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const int sms = sms_of[dev];
  auto s = (cudaStream_t)stream;
  constexpr int64_t PER = 16 / sizeof(T);

  // the thread route: TR transposed reference rows and TQ query rows, each
  // with a spare slot
  const int64_t WS1 = (W + 1 + PER - 1) / PER * PER;
  const int64_t smem1 = ((W + 1) * TR + TQ * WS1) * (int64_t)sizeof(T);
  const bool fits = smem1 <= SMEM_ONE;
  if (route == THREAD && !fits) return (int)cudaErrorInvalidValue;
  if (route == THREAD ||
      (route == AUTO && fits && NQ * NR >= THREAD_MIN_PAIRS)) {
    const int64_t qtiles = (NQ + TQ - 1) / TQ, rtiles = (NR + TR - 1) / TR;
    const int64_t blocks = rtiles * ((qtiles + QG - 1) / QG);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if ((e = allow_smem<thread_kernel<T>>(smem1, dev)) != cudaSuccess)
      return (int)e;
    thread_kernel<T><<<(unsigned)blocks, TQ * 32, (size_t)smem1, s>>>(
        q, nq, NQ, r, nr, NR, (int)W, (int)WS1, qtiles, cap, common, denom);
    return (int)cudaGetLastError();
  }

  // the warp route: the largest tile of which three (queries, two
  // reference buffers) fit beside a second block, and of which there is
  // one for each SM; else one tile row; else rows from global memory
  const int64_t WS = (W + PER - 1) / PER * PER;
  const int64_t row_bytes = WS * (int64_t)sizeof(T);
  int tile = 0;
  for (int t = 8; t >= 1 && !tile; t >>= 1)
    if (3 * t * row_bytes <= SMEM_TWO &&
        (t == 1 || ((NQ + t - 1) / t) * ((NR + t - 1) / t) >= sms))
      tile = t;
  if (!tile && 3 * row_bytes <= SMEM_ONE) tile = 1;
  const bool use_smem = tile > 0;
  if (!use_smem) tile = 8;
  const int64_t smem = use_smem ? 3 * tile * row_bytes : 0;
  const int64_t qtiles = (NQ + tile - 1) / tile;
  const int64_t rtiles = (NR + tile - 1) / tile;
  // a block walks enough reference tiles to make about eight waves of
  // the card's block slots, if there is work for that many
  const int64_t slots = (int64_t)sms * (smem > SMEM_TWO ? 1 : 2);
  int64_t group = qtiles * rtiles / (8 * slots);
  group = group < 1 ? 1 : (group > rtiles ? rtiles : group);
  const int64_t blocks = qtiles * ((rtiles + group - 1) / group);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (use_smem) {
    if ((e = allow_smem<warp_kernel<T, true>>(smem, dev)) != cudaSuccess)
      return (int)e;
    warp_kernel<T, true><<<(unsigned)blocks, WARPS * 32, (size_t)smem, s>>>(
        q, nq, NQ, r, nr, NR, (int)W, (int)WS, tile, rtiles, group, cap,
        common, denom);
  } else {
    warp_kernel<T, false><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        q, nq, NQ, r, nr, NR, (int)W, (int)WS, tile, rtiles, group, cap,
        common, denom);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pairwise64_launch(const uint64_t* q, const int32_t* nq,
                                 int64_t NQ, const uint64_t* r,
                                 const int32_t* nr, int64_t NR, int64_t W,
                                 int cap, int route, int32_t* common,
                                 int32_t* denom, void* stream) {
  return launch<uint64_t>(q, nq, NQ, r, nr, NR, W, cap, route, common,
                          denom, stream);
}

extern "C" int pairwise32_launch(const uint32_t* q, const int32_t* nq,
                                 int64_t NQ, const uint32_t* r,
                                 const int32_t* nr, int64_t NR, int64_t W,
                                 int cap, int route, int32_t* common,
                                 int32_t* denom, void* stream) {
  return launch<uint32_t>(q, nq, NQ, r, nr, NR, W, cap, route, common,
                          denom, stream);
}
