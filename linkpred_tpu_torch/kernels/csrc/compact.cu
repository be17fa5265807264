// Survivor pack for the deferred top-k selection, in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel linkpred_tpu/ops/compact.py::_pack_kernel
// (launched by pack_survivors).  Its plain PyTorch twin, which defines the
// contract, is linkpred_tpu_torch/ops/compact.py::pack_survivors_reference.
//
// Contract: given int32 selection keys (sign-flipped order-preserving form
// of the reference's u32 keys) and a threshold T, write exactly the lanes
// with key <= T, in lane order, each with its original lane index, to the
// front of an output of `capacity` lanes; fill the rest with the sentinel
// key INT32_MAX and index 0; return the global survivor count (survivors
// past `capacity` are counted but not written, and the caller then takes
// the full-sort arm).
//
// What bounds it: memory.  Two reads of the keys (count, then scatter) and
// one write of the output; no arithmetic to speak of.  At 2^24 lanes that is
// ~130 MB of reads, a few tens of microseconds of HBM time.
//
// Design.  The TPU kernel moves survivors with LSB-first shift routing
// because the TPU has no vector scatter, and counts per fixed chunk.  A GPU
// scatters freely, so this is the textbook stream compaction: per-block
// survivor counts, one block's exclusive scan of them (which also yields the
// global count), then each block ranks its survivors with a block scan and
// stores them at their global positions.  Each thread owns kItems
// consecutive lanes, so ranks follow lane order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // lanes per block
constexpr int kScanThreads = 1024;
constexpr int32_t kDeadKey = 0x7FFFFFFF;  // sorts after every real key

// Exclusive sum of one int per thread over a block of N threads (warp
// shuffles, then a scan of the warp totals); *total gets the block sum.
template <int N>
__device__ int block_exclusive_sum(int v, int *total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o)
      x += y;
  }
  if (lane == 31)
    warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < N / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o)
        w += y;
    }
    if (lane < N / 32)
      warp_sums[lane] = w;
  }
  __syncthreads();
  const int ex = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[N / 32 - 1];
  __syncthreads();
  return ex;
}

__device__ __forceinline__ int thread_count(const int32_t *key, int32_t thr,
                                            int64_t base, int64_t total) {
  int c = 0;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i < total && key[i] <= thr)
      ++c;
  }
  return c;
}

__global__ void pack_count(const int32_t *key, const int32_t *thr,
                           int64_t total, int *blk_cnt) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  const int c = thread_count(key, *thr, base, total);
  int sum;
  block_exclusive_sum<kThreads>(c, &sum);
  if (threadIdx.x == 0)
    blk_cnt[blockIdx.x] = sum;
}

__global__ void pack_scan(const int *blk_cnt, int *blk_off, int nblk,
                          int *count) {
  const int per = (nblk + kScanThreads - 1) / kScanThreads;
  const int b0 = min((int)threadIdx.x * per, nblk);
  const int b1 = min(b0 + per, nblk);
  int c = 0;
  for (int b = b0; b < b1; ++b)
    c += blk_cnt[b];
  int sum;
  int ex = block_exclusive_sum<kScanThreads>(c, &sum);
  for (int b = b0; b < b1; ++b) {
    blk_off[b] = ex;
    ex += blk_cnt[b];
  }
  if (threadIdx.x == 0)
    *count = sum;
}

__global__ void pack_scatter(const int32_t *key, const int32_t *thr,
                             int64_t total, const int *blk_off,
                             const int *count, int64_t capacity, int32_t *pk,
                             int32_t *pidx) {
  const int32_t t = *thr;
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  const int c = thread_count(key, t, base, total);
  int sum;
  int64_t pos =
      (int64_t)blk_off[blockIdx.x] + block_exclusive_sum<kThreads>(c, &sum);
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i < total) {
      const int32_t k = key[i];
      if (k <= t) {
        if (pos < capacity) {
          pk[pos] = k;
          pidx[pos] = (int32_t)i;
        }
        ++pos;
      }
    }
  }
  // dead output lanes: [count, capacity), grid-strided
  const int64_t live = *count < capacity ? (int64_t)*count : capacity;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t p = live + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       p < capacity; p += stride) {
    pk[p] = kDeadKey;
    pidx[p] = 0;
  }
}

}  // namespace

extern "C" {

// Scratch the launch needs, in bytes: block counts and block offsets.
int64_t lp_pack_scratch_bytes(int64_t total) {
  const int64_t nblk = (total + kTile - 1) / kTile;
  return 2 * nblk * (int64_t)sizeof(int);
}

// Launches the three phases on `stream` of CUDA device `device`; `thr` and
// `count` are device scalars (int32).  Returns cudaGetLastError().
int lp_pack_survivors(int device, const void *key, const void *thr,
                      int64_t total, int64_t capacity, void *pk, void *pidx,
                      void *count, void *scratch, void *stream) {
  const int nblk = (int)((total + kTile - 1) / kTile);
  if (nblk == 0)
    return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  int *blk_cnt = static_cast<int *>(scratch);
  int *blk_off = blk_cnt + nblk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t *k = static_cast<const int32_t *>(key);
  const int32_t *t = static_cast<const int32_t *>(thr);
  int *cnt = static_cast<int *>(count);
  pack_count<<<nblk, kThreads, 0, s>>>(k, t, total, blk_cnt);
  pack_scan<<<1, kScanThreads, 0, s>>>(blk_cnt, blk_off, nblk, cnt);
  pack_scatter<<<nblk, kThreads, 0, s>>>(
      k, t, total, blk_off, cnt, capacity, static_cast<int32_t *>(pk),
      static_cast<int32_t *>(pidx));
  return (int)cudaGetLastError();
}

}  // extern "C"
