// Toolchain smoke kernel: out = 2 * x + 1 over int32, in CUDA C++ for sm_90a,
// and the card's launch floor.
//
// Replaces the TPU kernel experiments/pallas_smoke.py::f (the `2x + 1`
// Pallas smoke that showed Mosaic kernels compile and run on the TPU).  Its
// plain PyTorch twin is
// linkpred_tpu_torch/experiments/pallas_smoke.py::affine_smoke_reference.
//
// What bounds it: memory, 4 bytes read and 4 written an element (2^26
// elements: 537 MB, 0.160 ms at 3.35 TB/s); at the probe's (8, 128) shape
// (8 KB) nothing but the launch, whose floor lp_launch_floor measures.
//
// Design (the earlier one was one thread an element, 4-byte accesses).
// Each thread reads and writes 16 bytes at a time (int4) in a grid-stride
// loop.  The grid is a multiple of the SM count: as many CTAs of 256
// threads as one int4 word a thread needs, rounded up to a multiple of the
// SM count and at most kMaxCtasPerSm an SM.  So each SM keeps its 2,048
// threads' loads in flight and the block scheduler refills it as CTAs
// retire; the loop strides only on arrays past that grid.  The last n % 4
// elements take a scalar loop, and so does the whole array when x or out
// is not 16-byte aligned (a view that starts inside its buffer).  The
// multiply wraps in unsigned arithmetic, as int32 tensors do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCtasPerSm = 8192;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int32_t affine(int32_t v) {
  return (int32_t)(2u * (uint32_t)v + 1u);
}

__global__ void __launch_bounds__(kThreads)
    affine_smoke(const int32_t *__restrict__ x, int32_t *__restrict__ out,
                 int64_t n, bool vec) {
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / 4;
    const int4 *xv = reinterpret_cast<const int4 *>(x);
    int4 *ov = reinterpret_cast<int4 *>(out);
    for (int64_t i = first; i < nv; i += stride) {
      const int4 a = xv[i];
      ov[i] = make_int4(affine(a.x), affine(a.y), affine(a.z), affine(a.w));
    }
    done = nv * 4;
  }
  for (int64_t i = done + first; i < n; i += stride)
    out[i] = affine(x[i]);
}

__global__ void empty_kernel() {}

// The SM count of each device, read once.
int sm_count(int device) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices)
    return -1;
  if (cached[device] == 0 &&
      cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return cached[device];
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
  const int sms = sm_count(device);
  if (sms < 1)
    return (int)cudaErrorInvalidDevice;
  const bool vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  const int64_t work = vec ? n / 4 : n;
  const int64_t per_sm = (work + (int64_t)sms * kThreads - 1) /
                         ((int64_t)sms * kThreads);
  const int ctas = sms * (int)(per_sm < 1 ? 1
                               : per_sm > kMaxCtasPerSm ? kMaxCtasPerSm
                                                        : per_sm);
  affine_smoke<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(x), static_cast<int32_t *>(out), n, vec);
  return (int)cudaGetLastError();
}

// The card's launch floor: `n_launches` launches of an empty kernel back to
// back on `stream`, issued from C between two CUDA events (after one
// warm-up launch); writes the microseconds a launch to *out_us.  Returns
// cudaErrorInvalidValue for n_launches < 1, else the first CUDA error.
int lp_launch_floor(int device, int n_launches, void *stream,
                    double *out_us) {
  if (n_launches < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t start, stop;
  if ((err = cudaEventCreate(&start)) != cudaSuccess)
    return (int)err;
  if ((err = cudaEventCreate(&stop)) != cudaSuccess) {
    cudaEventDestroy(start);
    return (int)err;
  }
  empty_kernel<<<1, 1, 0, s>>>();
  err = cudaStreamSynchronize(s);
  if (err == cudaSuccess)
    err = cudaEventRecord(start, s);
  for (int i = 0; i < n_launches && err == cudaSuccess; ++i) {
    empty_kernel<<<1, 1, 0, s>>>();
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaEventRecord(stop, s);
  if (err == cudaSuccess)
    err = cudaEventSynchronize(stop);
  float ms = 0.f;
  if (err == cudaSuccess)
    err = cudaEventElapsedTime(&ms, start, stop);
  if (err == cudaSuccess)
    *out_us = (double)ms * 1e3 / n_launches;
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return (int)err;
}

}  // extern "C"
