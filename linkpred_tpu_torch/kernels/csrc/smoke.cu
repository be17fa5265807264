// Toolchain smoke kernel: out = 2 * x + 1 over int32, in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel experiments/pallas_smoke.py::f (the `2x + 1`
// Pallas smoke that showed Mosaic kernels compile and run on the TPU).  Its
// plain PyTorch twin is
// linkpred_tpu_torch/experiments/pallas_smoke.py::affine_smoke_reference.
//
// What bounds it: memory (4 bytes read and 4 written per element) and, at
// the probe's (8, 128) shape, the launch itself.  One thread per element;
// the multiply wraps in unsigned arithmetic, as int32 tensors do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void affine_smoke(const int32_t *x, int32_t *out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n)
    out[i] = (int32_t)(2u * (uint32_t)x[i] + 1u);
}

}  // namespace

extern "C" {

// Launches on `stream` of CUDA device `device`; returns cudaGetLastError().
int lp_affine_smoke(int device, const void *x, void *out, int64_t n,
                    void *stream) {
  if (n == 0)
    return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  const int64_t nblk = (n + kThreads - 1) / kThreads;
  affine_smoke<<<(unsigned)nblk, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(x), static_cast<int32_t *>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
