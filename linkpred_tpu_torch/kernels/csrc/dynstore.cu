// Sequential dynamic-offset block stores into one resident int32 array, in
// CUDA C++ for sm_90a: the scatter primitive of a block-scatter radix sort.
//
// Replaces the TPU kernel experiments/radix_probe.py::dynstore_run (a grid
// of `iters` steps; each step makes 256 stores of an 8 x 128 int32 block
// into one VMEM-resident (512, 128) output).  Its plain PyTorch version,
// which defines the contract, is
// linkpred_tpu_torch/experiments/radix_probe.py::dynstore_reference.
//
// Contract: `iters` times, for store i = 0 .. 255 in order,
//   out[off[i] : off[i] + 8, :] = x[(i % 64) * 8 : (i % 64) * 8 + 8, :] + i,
// with off[i] clamped to [0, 504] as the reference's dynamic slice clamps a
// start index.  The stores overlap (offsets are not multiples of 8) and a
// later store wins, so their order is part of the function.  Rows that no
// store touches keep what `out` held (the wrapper fills it with INT32_MIN,
// what the TPU kernel's interpret mode leaves there).
//
// What bounds it: at the probe's shape nothing but latency.  The least
// traffic is x and the offsets read once and the output written once
// (~0.5 MB); the work is iters * 256 * 8 * 128 integer adds.
//
// Design.  A parallel scatter of the stores would race on the overlapping
// rows, so each thread owns one column and makes every store of that column
// in order: the 256 stores of one step are sequential per column, as on the
// TPU, and columns are independent.  A CTA of one warp holds its 32 columns
// of x and of the output in shared memory (the counterpart of the
// VMEM-resident blocks: 2 x 64 KB, conflict-free, a row of a warp's store
// is one 128-byte line), and the offsets beside them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 512;
constexpr int kCols = 128;
constexpr int kStores = 256;
constexpr int kBlk = 8;
constexpr int kColsPerCta = 32;
constexpr size_t kSmemBytes =
    (2 * (size_t)kRows * kColsPerCta + kStores) * sizeof(int32_t);

__global__ void dynstore(const int32_t *off, const int32_t *x, int32_t *out,
                         int iters) {
  extern __shared__ int32_t smem[];
  int32_t *so = smem;                       // [kRows][kColsPerCta]
  int32_t *sx = so + kRows * kColsPerCta;   // [kRows][kColsPerCta]
  int32_t *soff = sx + kRows * kColsPerCta; // [kStores]
  const int c = threadIdx.x;
  const int col = blockIdx.x * kColsPerCta + c;
  for (int r = 0; r < kRows; ++r) {
    so[r * kColsPerCta + c] = out[r * kCols + col];
    sx[r * kColsPerCta + c] = x[r * kCols + col];
  }
  for (int i = c; i < kStores; i += kColsPerCta)
    soff[i] = min(max(off[i], 0), kRows - kBlk);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < kStores; ++i) {
      const int dst = soff[i] * kColsPerCta + c;
      const int src = (i % (kRows / kBlk)) * kBlk * kColsPerCta + c;
#pragma unroll
      for (int r = 0; r < kBlk; ++r)
        so[dst + r * kColsPerCta] =
            (int32_t)((uint32_t)sx[src + r * kColsPerCta] + (uint32_t)i);
    }
  }
  for (int r = 0; r < kRows; ++r)
    out[r * kCols + col] = so[r * kColsPerCta + c];
}

}  // namespace

extern "C" {

// Launches the stores on `stream` of CUDA device `device`: `off` int32[256],
// `x` and `out` int32[512, 128] row-major, `out` updated in place.  Returns
// cudaErrorInvalidValue for iters < 1, else cudaGetLastError().
int lp_dynstore(int device, const void *off, const void *x, void *out,
                int iters, void *stream) {
  if (iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  err = cudaFuncSetAttribute(dynstore,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess)
    return (int)err;
  dynstore<<<kCols / kColsPerCta, kColsPerCta, kSmemBytes,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(off), static_cast<const int32_t *>(x),
      static_cast<int32_t *>(out), iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
