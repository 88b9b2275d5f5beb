// pairwise64 / pairwise32: all-pairs (common, denom) of sorted sketches.
//
// Replaces the Pallas kernels mash_tpu/ops/pallas_pairwise.py::_kernel_body
// (two int32 planes per 64-bit hash; built by _build, driven by
// pairwise_common_denom_pallas) and ::_kernel_body32 (one uint32 key plane;
// built by _build32, driven by pairwise_common_denom_keys32 and the
// use64=False branch), as two instantiations of one template.
//
// What it computes, for every (query row, reference row) pair of sorted,
// sentinel-padded sketch rows holding distinct values: the reference's
// capped merge walk (src/mash/CommandDistance.cpp:336-425), in the
// order-free form of mash_tpu/ops/distance.py:
//   total  = #values present in both rows (the all-ones sentinel excluded)
//   denom  = min(cap, nq + nr - total)
//   common = #matches whose union rank is <= denom, where the match of
//            query element i with reference element j has union rank
//            i + j + 1 - (#matches before it).
//
// What bounds it on the H100: operations.  A merge of two s-element rows
// is O(s) compares per pair and the inputs are only (NQ + NR) * s keys, so
// at the main path's shapes (s = 1000, 10^6 pairs) the work is ~10^9
// compares against ~16 MB of input.
//
// What the design does about it: one block per (query tile of 32 rows,
// reference row).  The reference row sits in shared memory (8 KB at
// s = 1000 in 64 bits, 4 KB as 32-bit keys); each warp walks one query
// row 32 elements at a time, every lane binary-searches its element in
// the shared row (native 64-bit compares; the TPU kernel split them into
// two int32 planes), and a warp ballot + popcount gives both the match
// count and each match's count of earlier matches.  Two passes: the first
// counts matches to fix denom, the second counts the matches within the
// cap.  The binary search costs log2(s) shared-memory reads per element
// where a merge path would cost ~1; that is the next step for speed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int TQ = 32;  // query rows per block
constexpr int SMEM_MAX = 200 * 1024;

template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
pairwise_kernel(const T* __restrict__ q, const int32_t* __restrict__ nq,
                int64_t NQ, const T* __restrict__ r,
                const int32_t* __restrict__ nr, int64_t NR, int W, int cap,
                int use_smem, int32_t* __restrict__ common,
                int32_t* __restrict__ denom) {
  extern __shared__ unsigned char smem_raw[];
  const T EMPTY = ~T(0);
  const int64_t rrow = blockIdx.x;
  const int64_t q0 = (int64_t)blockIdx.y * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* rr = r + rrow * W;
  if (use_smem) {
    T* rs = reinterpret_cast<T*>(smem_raw);
    for (int i = tid; i < W; i += WARPS * 32) rs[i] = rr[i];
    __syncthreads();
    rr = rs;
  }
  const int nr_row = nr[rrow];
  const unsigned lt_mask = (1u << lane) - 1;

  for (int qi = warp; qi < TQ; qi += WARPS) {
    const int64_t qrow = q0 + qi;
    if (qrow >= NQ) break;  // uniform across the warp
    const T* qq = q + qrow * W;

    int total = 0;
    for (int base = 0; base < W; base += 32) {
      const int i = base + lane;
      bool match = false;
      if (i < W) {
        const T v = qq[i];
        if (v != EMPTY) {
          const int j = lower_bound(rr, W, v);
          match = j < W && rr[j] == v;
        }
      }
      total += __popc(__ballot_sync(0xffffffffu, match));
    }
    const int d = min(cap, nq[qrow] + nr_row - total);

    int before = 0, cnt = 0;
    for (int base = 0; base < W; base += 32) {
      const int i = base + lane;
      bool match = false;
      int j = 0;
      if (i < W) {
        const T v = qq[i];
        if (v != EMPTY) {
          j = lower_bound(rr, W, v);
          match = j < W && rr[j] == v;
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, match);
      const int rank = i + j + 1 - (before + __popc(mask & lt_mask));
      cnt += __popc(__ballot_sync(0xffffffffu, match && rank <= d));
      before += __popc(mask);
    }
    if (lane == 0) {
      common[qrow * NR + rrow] = cnt;
      denom[qrow * NR + rrow] = d;
    }
  }
}

template <typename T>
int launch(const T* q, const int32_t* nq, int64_t NQ, const T* r,
           const int32_t* nr, int64_t NR, int64_t W, int cap,
           int32_t* common, int32_t* denom, void* stream) {
  if (NQ < 0 || NR < 0 || W < 1 || W > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (NQ == 0 || NR == 0) return 0;
  const int64_t qtiles = (NQ + TQ - 1) / TQ;
  if (qtiles > 65535 || NR > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t bytes = W * (int64_t)sizeof(T);
  const int use_smem = bytes <= SMEM_MAX;
  const int smem = use_smem ? (int)bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pairwise_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)NR, (unsigned)qtiles);
  pairwise_kernel<T><<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      q, nq, NQ, r, nr, NR, (int)W, cap, use_smem, common, denom);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pairwise64_launch(const uint64_t* q, const int32_t* nq,
                                 int64_t NQ, const uint64_t* r,
                                 const int32_t* nr, int64_t NR, int64_t W,
                                 int cap, int32_t* common, int32_t* denom,
                                 void* stream) {
  return launch<uint64_t>(q, nq, NQ, r, nr, NR, W, cap, common, denom,
                          stream);
}

extern "C" int pairwise32_launch(const uint32_t* q, const int32_t* nq,
                                 int64_t NQ, const uint32_t* r,
                                 const int32_t* nr, int64_t NR, int64_t W,
                                 int cap, int32_t* common, int32_t* denom,
                                 void* stream) {
  return launch<uint32_t>(q, nq, NQ, r, nr, NR, W, cap, common, denom,
                          stream);
}
