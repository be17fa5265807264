// Sequential dynamic-offset block stores into one resident int32 array, in
// CUDA C++ for sm_90a: the scatter primitive of a block-scatter radix sort.
//
// Replaces the TPU kernel experiments/radix_probe.py::dynstore_run (a grid
// of `iters` steps; each step makes 256 stores of an 8 x 128 int32 block
// into one VMEM-resident (512, 128) output).  Its plain PyTorch version,
// which defines the contract, is
// linkpred_tpu_torch/experiments/radix_probe.py::dynstore_reference; the
// order this kernel applies the stores in is written out in plain PyTorch
// as radix_probe.py::dynstore_banded.
//
// Contract: `iters` times, for store i = 0 .. 255 in order,
//   out[off[i] : off[i] + 8, :] = x[(i % 64) * 8 : (i % 64) * 8 + 8, :] + i,
// with off[i] clamped to [0, 504] as the reference's dynamic slice clamps a
// start index.  The stores overlap (offsets are not multiples of 8) and a
// later store wins, so their order is part of the function.  Rows that no
// store touches keep what `out` held (the wrapper fills it with INT32_MIN,
// what the TPU kernel's interpret mode leaves there).  Every store of every
// iteration is applied: nothing uses the fact that the iterations repeat,
// and nothing stops at a row's last covering store.
//
// What bounds it: not memory.  x, the offsets and the output are ~0.5 MB,
// read and written once (0.16 us at 3.35 TB/s), below one launch.  The
// work is the stores: iters * 256 of them, each a compare of a row against
// the store's offset and a select of the new value, for every element of
// the rows it may touch.  So the bound is the issue rate of that
// compare-and-select, and what the design does is cut the candidates each
// element is compared with and spread them over the card.
//
// Design (the earlier one gave each of 4 one-warp CTAs a column and made
// every store of it one after another through shared memory: 4 of the 132
// SMs busy, 2,048 dependent stores a thread per iteration).
//  * Output-stationary: a thread owns 4 neighbouring columns (one int4) of
//    one row and keeps them in registers from its first read of `out` to
//    its one write at the end.
//  * Stores binned by 32-row band: a store of 8 rows starting at `off`
//    touches at most two bands.  Each CTA owns one band and one strip of
//    16 columns (16 bands x 8 strips = 128 CTAs of 128 threads, so ~every
//    SM has a CTA); its first warp keeps, once a launch and in store order,
//    the stores that touch its band (a ballot over the 256 clamped
//    offsets), ~20 on the probe's offsets instead of 256.
//  * In-order application: each thread walks its band's list in order,
//    `iters` times, and for each store selects the new value where its row
//    lies in [off, off + 8).  With one warp on each of an SM's schedulers
//    there is no other warp to hide a load behind, so a store's two
//    shared-memory loads (its list word, then its source word) would
//    serialize: the list is walked four stores at a time, their eight
//    loads issued before their four selects, in store order.  The select
//    is branch-free and the source load does not wait for the compare.
//  * x is staged in shared memory, the CTA's 16 columns of all 512 rows
//    (32 KB, one coalesced read a launch): any store may read any source
//    row, and every iteration reads them again, so a fixed-latency,
//    conflict-free source (the 8 lanes of one row read 8 neighbouring
//    16-byte words) serves them better than L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 512;
constexpr int kCols = 128;
constexpr int kStores = 256;
constexpr int kBlk = 8;
constexpr int kBand = 32;                    // rows of a band
constexpr int kBands = kRows / kBand;        // 16
constexpr int kStrip = 16;                   // columns of a CTA
constexpr int kStrips = kCols / kStrip;      // 8
constexpr int kVecs = kStrip / 4;            // int4 words of a strip row
constexpr int kThreads = kBand * kVecs;      // 128
constexpr size_t kSmemBytes =
    (size_t)kRows * kStrip * sizeof(int32_t) + kStores * sizeof(int4);
static_assert(kSmemBytes <= 48 * 1024,
              "the launch asks for no more dynamic shared memory than the "
              "default 48 KB");

__device__ __forceinline__ int4 add_i(int4 a, int i) {
  // int32 adds that wrap, as the plain version's do
  return make_int4((int)((unsigned)a.x + (unsigned)i),
                   (int)((unsigned)a.y + (unsigned)i),
                   (int)((unsigned)a.z + (unsigned)i),
                   (int)((unsigned)a.w + (unsigned)i));
}

// Store e = {off, (i % 64) * 8 - off, i, 0} on the thread's row: where the
// row lies in [off, off + 8), the new value is the source word s + i.
__device__ __forceinline__ void apply(int4 &acc, int row, int4 e, int4 s) {
  const bool covered = (unsigned)(row - e.x) < (unsigned)kBlk;
  const int4 val = add_i(s, e.z);
  acc.x = covered ? val.x : acc.x;
  acc.y = covered ? val.y : acc.y;
  acc.z = covered ? val.z : acc.z;
  acc.w = covered ? val.w : acc.w;
}

// The source word of store e for the thread's row and int4 column v: row
// (i % 64) * 8 + (row - off) of x where the store covers the row; wrapped
// into the array where not (its value is not taken), so the load waits
// for no compare and a row's lanes read neighbouring words.
__device__ __forceinline__ int4 source(const int4 *sx, int row, int v,
                                       int4 e) {
  return sx[((e.y + row) & (kRows - 1)) * kVecs + v];
}

__global__ void __launch_bounds__(kThreads)
    dynstore(const int32_t *__restrict__ off, const int4 *__restrict__ x,
             int4 *__restrict__ out, int iters) {
  extern __shared__ int4 smem[];
  int4 *sx = smem;                           // [kRows][kVecs]
  int4 *list = sx + kRows * kVecs;           // [kStores] {off, base, i, 0}
  __shared__ int count;
  const int strip = blockIdx.x, band = blockIdx.y;
  const int v = threadIdx.x % kVecs, r = threadIdx.x / kVecs;
  const int row = band * kBand + r;
  const int gcol = strip * kVecs + v;        // int4 column in a full row

  for (int k = threadIdx.x; k < kRows * kVecs; k += kThreads) {
    const int sr = k / kVecs, sv = k % kVecs;
    sx[k] = x[sr * (kCols / 4) + strip * kVecs + sv];
  }
  if (threadIdx.x < 32) {
    // the stores that touch rows [lo, lo + kBand), in store order
    const int lane = threadIdx.x, lo = band * kBand;
    int n = 0;
    for (int c = 0; c < kStores; c += 32) {
      const int i = c + lane;
      const int o = min(max(off[i], 0), kRows - kBlk);
      const bool touch = o < lo + kBand && o + kBlk > lo;
      const unsigned mask = __ballot_sync(0xffffffffu, touch);
      if (touch) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
        list[at] = make_int4(o, (i % (kRows / kBlk)) * kBlk - o, i, 0);
      }
      n += __popc(mask);
    }
    if (lane == 0)
      count = n;
  }
  __syncthreads();

  const int n = count, n4 = n & ~3;
  int4 acc = out[row * (kCols / 4) + gcol];
  for (int it = 0; it < iters; ++it) {
    int j = 0;
    for (; j < n4; j += 4) {
      // four stores' loads first, then their selects in store order
      int4 e[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        e[u] = list[j + u];                  // broadcast: one word a warp
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] = source(sx, row, v, e[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        apply(acc, row, e[u], s[u]);
    }
    for (; j < n; ++j) {
      const int4 e = list[j];
      apply(acc, row, e, source(sx, row, v, e));
    }
  }
  out[row * (kCols / 4) + gcol] = acc;
}

}  // namespace

extern "C" {

// Launches the stores on `stream` of CUDA device `device`: `off` int32[256],
// `x` and `out` int32[512, 128] row-major and 16-byte aligned, `out`
// updated in place.  Returns cudaErrorInvalidValue for iters < 1 or a
// misaligned x or out, else cudaGetLastError().
int lp_dynstore(int device, const void *off, const void *x, void *out,
                int iters, void *stream) {
  if (iters < 1 || ((uintptr_t)x | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  dynstore<<<dim3(kStrips, kBands), kThreads, kSmemBytes,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(off), static_cast<const int4 *>(x),
      static_cast<int4 *>(out), iters);
  return (int)cudaGetLastError();
}

// The CTAs a launch runs (the grid's size), for the smoke's check that
// the stores are spread over the card.
int lp_dynstore_ctas(void) { return kStrips * kBands; }

}  // extern "C"
