// Bitonic sorting network over n = 2^m int32 keys, with or without an int32
// payload, in CUDA C++ for sm_90a.
//
// Replaces the TPU kernels experiments/pallas_bitonic.py::make_pallas_sort
// and ::make_pallas_sort_kv (every stage unrolled in one kernel) and
// experiments/pallas_bitonic2.py::make_sort (the same stages walked from a
// stage table in one fori_loop).  The two compute one function; they differ
// only in how Mosaic was made to compile it, so this one source serves both.
// The plain PyTorch version, which defines the contract, is
// linkpred_tpu_torch/experiments/pallas_bitonic.py::bitonic_stages.
//
// Contract: the caller hands a stage table (k, j), in order, and arrays it
// owns (the wrappers copy the caller's input first).  Stage (k, j)
// compare-exchanges every lane i with (i & j) == 0 against its partner
// i | j, ascending iff (i & k) == 0, with i the global lane index.  A pair
// swaps, key and payload together, only on a strict inequality:
// asc ? key[i] > key[i|j] : key[i] < key[i|j].  On equal keys both lanes
// keep their own payload, which is the TPU kernels' keep_own rule, so the
// payload equals theirs lane for lane, not just up to ties.
//
// What bounds it: memory.  The least traffic is each key (and payload) read
// once and written once, 8 n bytes (16 n with a payload); the network does
// n/2 compares in each of m(m+1)/2 stages, which at 2^20 lanes is a few
// microseconds of integer work.  This design moves far more than the bound:
// every stage with j >= the tile is a full pass over the arrays.
//
// Design.  The TPU design (pltpu.roll partner exchange, rows and lanes
// split at 128, one VMEM-resident block) exists only for Mosaic.  Here:
//   * bitonic_tile: a CTA loads a tile of kTile = 2^12 consecutive lanes
//     (32 KB of key and payload) into shared memory and runs a run of
//     consecutive stages with j < kTile there, one __syncthreads per stage;
//     the partner of a lane in the tile is in the tile;
//   * bitonic_global: each stage with j >= kTile is one launch with one
//     thread per pair;
//   * lp_bitonic_sort walks the table on the host: a global launch for each
//     stage with j >= kTile, one tile launch for each maximal run of stages
//     with j < kTile.
// The direction comes from the global lane index, so how the stages are
// grouped into launches does not change the result.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog2 = 12;
constexpr int kTile = 1 << kTileLog2;  // lanes a CTA holds in shared memory
constexpr int kTileThreads = 512;
constexpr int kGlobalThreads = 256;

// Lane of pair q at stride j: q with a 0 bit inserted at log2(j).
__device__ __forceinline__ int64_t pair_lane(int64_t q, int64_t j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// Stages (k_first, j_first), ..., (k_last, 1) in table order over the CTA's
// tile of `tile` lanes.
template <bool kPayload>
__global__ void bitonic_tile(int32_t *key, int32_t *pay, int tile,
                             int64_t k_first, int j_first, int64_t k_last) {
  __shared__ int32_t sk[kTile];
  __shared__ int32_t sp[kPayload ? kTile : 1];
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = key[base + t];
    if (kPayload)
      sp[t] = pay[base + t];
  }
  __syncthreads();
  int64_t k = k_first;
  int j = j_first;
  while (true) {
    for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
      const int i = (int)pair_lane(q, j);
      const int l = i | j;
      const bool asc = ((base + i) & k) == 0;
      const int32_t a = sk[i];
      const int32_t b = sk[l];
      if (asc ? a > b : a < b) {
        sk[i] = b;
        sk[l] = a;
        if (kPayload) {
          const int32_t t = sp[i];
          sp[i] = sp[l];
          sp[l] = t;
        }
      }
    }
    __syncthreads();
    if (j > 1) {
      j >>= 1;
    } else if (k < k_last) {
      k <<= 1;
      j = (int)(k >> 1);
    } else {
      break;
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    key[base + t] = sk[t];
    if (kPayload)
      pay[base + t] = sp[t];
  }
}

// One stage (k, j) over all n lanes: one thread per pair.
template <bool kPayload>
__global__ void bitonic_global(int32_t *key, int32_t *pay, int64_t pairs,
                               int64_t k, int64_t j) {
  const int64_t q = (int64_t)blockIdx.x * kGlobalThreads + threadIdx.x;
  if (q >= pairs)
    return;
  const int64_t i = pair_lane(q, j);
  const int64_t l = i | j;
  const bool asc = (i & k) == 0;
  const int32_t a = key[i];
  const int32_t b = key[l];
  if (asc ? a > b : a < b) {
    key[i] = b;
    key[l] = a;
    if (kPayload) {
      const int32_t t = pay[i];
      pay[i] = pay[l];
      pay[l] = t;
    }
  }
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

template <bool kPayload>
int walk(int32_t *key, int32_t *pay, int64_t n, const int32_t *ks,
         const int32_t *js, int64_t nstages, cudaStream_t s) {
  const int tile = (int)(n < kTile ? n : kTile);
  const int tile_threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  const int64_t pairs = n / 2;
  const unsigned global_blocks =
      (unsigned)((pairs + kGlobalThreads - 1) / kGlobalThreads);
  int64_t st = 0;
  while (st < nstages) {
    const int64_t k = ks[st];
    const int64_t j = js[st];
    if (!pow2(k) || !pow2(j) || j >= k || k > n)
      return (int)cudaErrorInvalidValue;
    if (j >= tile) {
      bitonic_global<kPayload>
          <<<global_blocks, kGlobalThreads, 0, s>>>(key, pay, pairs, k, j);
    } else {
      // the maximal run of stages with j < tile; it must follow the
      // network's order, since the tile kernel walks it that way, and end
      // at j = 1
      int64_t kk = k, jj = j, e = st;
      while (true) {
        if (jj > 1) {
          jj >>= 1;
        } else {
          kk <<= 1;
          jj = kk >> 1;
        }
        if (e + 1 >= nstages || js[e + 1] >= tile)
          break;
        if (ks[e + 1] != kk || js[e + 1] != jj || kk > n)
          return (int)cudaErrorInvalidValue;
        ++e;
      }
      if (js[e] != 1)
        return (int)cudaErrorInvalidValue;
      bitonic_tile<kPayload><<<(unsigned)(n / tile), tile_threads, 0, s>>>(
          key, pay, tile, k, (int)j, (int64_t)ks[e]);
      st = e;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
      return (int)err;
    ++st;
  }
  return 0;
}

}  // namespace

extern "C" {

// Runs the stage table (ks[s], js[s]), s < nstages, in order over the n
// int32 keys at `key` and, unless `pay` is null, the int32 payload at `pay`,
// in place, on `stream` of CUDA device `device`.  n is a power of two; the
// tables are host arrays.  Returns a CUDA error code: cudaErrorInvalidValue
// for a bad n or table, else cudaGetLastError() after each launch.
int lp_bitonic_sort(int device, void *key, void *pay, int64_t n,
                    const int32_t *ks, const int32_t *js, int64_t nstages,
                    void *stream) {
  if (!pow2(n) || n < 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t *k = static_cast<int32_t *>(key);
  int32_t *p = static_cast<int32_t *>(pay);
  return p ? walk<true>(k, p, n, ks, js, nstages, s)
           : walk<false>(k, p, n, ks, js, nstages, s);
}

}  // extern "C"
