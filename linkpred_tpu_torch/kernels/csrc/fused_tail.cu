// Fused post-sort tail for one sorted tile: run reduction, scoring and the
// selection-key emit, in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel linkpred_tpu/ops/fused_tail.py::_tail_kernel
// (launched by fused_tail).  Its plain PyTorch twin, which defines the
// contract, is linkpred_tpu_torch/ops/fused_tail.py::fused_tail_reference.
//
// Input: one tile of `cap` lanes sorted by the pair (hi = candidate w,
// lo = source u), the degree payload (deg16-packed pair, or two wide
// arrays) and up to two float weight arrays (AA/RA), all gathered through
// the sort permutation.  Output per lane: one int32 selection key per metric
// (the order-preserving sign-flipped form of the reference's u32 key),
// ku = min(u, n-1) and kw = min(w, n-1).
//
// What bounds it: memory.  Per lane it reads 8-16 bytes of keys and degrees
// (+4 per weight array) and writes 4 bytes per metric + 8; the arithmetic is
// a handful of float ops.  At cap 2^20 that is ~20-30 MB, a few microseconds
// of HBM time, so the launch count and the passes over the lanes decide.
//
// Design.  The TPU kernel walks its grid in order and carries the run-start
// cummax and the segmented weight sums from one chunk to the next in SMEM
// scalars.  CUDA blocks run in no order, so the carry is a three-phase scan:
//   1. tail_aggregate: each block folds its lanes into one Carry (the last
//      run start it holds, and the weight sums since that start);
//   2. tail_scan_blocks: one block scans the per-block Carries into each
//      block's exclusive carry-in (runs may span many blocks);
//   3. tail_emit: each block rescans its lanes seeded by its carry-in and
//      scores every lane.
// Run boundaries come from comparing lane i with its neighbours directly;
// the reference's separate `neq` pass folds in.  Each thread owns kItems
// consecutive lanes, so the in-thread fold is in lane order.  The float
// formulas use the _rn intrinsics so no FMA contraction or fast-math
// approximation can change a bit: unweighted scores equal the twin's
// exactly.  Weighted sums are added in another order than the twin's
// log-step scan, so they agree to float32 rounding.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // lanes per block
constexpr int kScanThreads = 1024;

// Metric codes: the order of linkpred_tpu_torch/predict/metrics.py METRICS.
enum Metric : int {
  kCommonNeighbors = 0,
  kJaccard = 1,
  kSorensen = 2,
  kSalton = 3,
  kHubPromoted = 4,
  kHubDepressed = 5,
  kLeichtHolmeNerman = 6,
  kAdamicAdar = 7,
  kResourceAllocation = 8,
};

// State of both scans over a range of lanes: `start` is the last run start
// in the range (-1 if none), s0/s1 the weight sums since that start (or over
// the whole range when it holds no start).
struct Carry {
  int start;
  float s0;
  float s1;
  int pad;
};

__device__ __forceinline__ Carry identity() { return {-1, 0.f, 0.f, 0}; }

// `a` covers the lanes before `b`.
__device__ __forceinline__ Carry combine(const Carry &a, const Carry &b) {
  if (b.start >= 0)
    return b;
  return {a.start, __fadd_rn(a.s0, b.s0), __fadd_rn(a.s1, b.s1), 0};
}

// Exclusive scan of one Carry per thread over a block of N threads
// (Hillis-Steele in shared memory); *total receives the block's fold.
template <int N>
__device__ Carry block_exclusive_scan(Carry mine, Carry *sh, Carry *total) {
  const int t = threadIdx.x;
  sh[t] = mine;
  __syncthreads();
  for (int off = 1; off < N; off <<= 1) {
    Carry v = mine;
    if (t >= off)
      v = combine(sh[t - off], mine);
    __syncthreads();
    sh[t] = v;
    mine = v;
    __syncthreads();
  }
  *total = sh[N - 1];
  Carry ex = t > 0 ? sh[t - 1] : identity();
  __syncthreads();
  return ex;
}

__device__ __forceinline__ bool run_start(const int32_t *hi, const int32_t *lo,
                                          int i) {
  return i == 0 || hi[i] != hi[i - 1] || lo[i] != lo[i - 1];
}

struct TailArgs {
  const int32_t *hi;
  const int32_t *lo;
  const int32_t *deg0;  // deg16 pair, or deg(u) when wide
  const int32_t *deg1;  // deg(w) when wide, else null
  const float *w0;      // first weighted metric's weights, or null
  const float *w1;      // second weighted metric's weights, or null
  int32_t *skeys;       // [n_metrics, cap]
  int32_t *ku;
  int32_t *kw;
  int cap;
  int n_metrics;
  uint64_t codes;  // 4 bits per metric, metric 0 in the low bits
  int w_bits;
  int n;
  int maxf2;
  float min_score;
};

__device__ __forceinline__ Carry lane_carry(const TailArgs &a, int i) {
  return {run_start(a.hi, a.lo, i) ? i : -1, a.w0 ? a.w0[i] : 0.f,
          a.w1 ? a.w1[i] : 0.f, 0};
}

__global__ void tail_aggregate(TailArgs a, Carry *agg) {
  __shared__ Carry sh[kThreads];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  Carry c = identity();
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i < a.cap)
      c = combine(c, lane_carry(a, i));
  }
  Carry total;
  block_exclusive_scan<kThreads>(c, sh, &total);
  if (threadIdx.x == 0)
    agg[blockIdx.x] = total;
}

__global__ void tail_scan_blocks(const Carry *agg, Carry *carry_in,
                                 int nblk) {
  __shared__ Carry sh[kScanThreads];
  const int per = (nblk + kScanThreads - 1) / kScanThreads;
  const int b0 = min((int)threadIdx.x * per, nblk);
  const int b1 = min(b0 + per, nblk);
  Carry c = identity();
  for (int b = b0; b < b1; ++b)
    c = combine(c, agg[b]);
  Carry total;
  Carry ex = block_exclusive_scan<kScanThreads>(c, sh, &total);
  for (int b = b0; b < b1; ++b) {
    carry_in[b] = ex;
    ex = combine(ex, agg[b]);
  }
}

__device__ __forceinline__ float metric_score(int code, float nuv, float acc,
                                              float du, float dw) {
  switch (code) {
  case kCommonNeighbors:
    return nuv;
  case kJaccard:
    return __fdiv_rn(nuv, __fsub_rn(__fadd_rn(du, dw), nuv));
  case kSorensen:
    return __fdiv_rn(nuv, __fadd_rn(du, dw));
  case kSalton:
    return __fdiv_rn(nuv, __fsqrt_rn(__fmul_rn(du, dw)));
  case kHubPromoted:
    return __fdiv_rn(nuv, fminf(du, dw));
  case kHubDepressed:
    return __fdiv_rn(nuv, fmaxf(du, dw));
  case kLeichtHolmeNerman:
    return __fdiv_rn(nuv, __fmul_rn(du, dw));
  default:  // kAdamicAdar, kResourceAllocation: the summed weight
    return acc;
  }
}

// int32 multiply with two's-complement wrap, as the twin's int32 tensors do
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__global__ void tail_emit(TailArgs a, const Carry *carry_in) {
  __shared__ Carry sh[kThreads];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  Carry c = identity();
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i < a.cap)
      c = combine(c, lane_carry(a, i));
  }
  Carry total;
  Carry ex = block_exclusive_scan<kThreads>(c, sh, &total);
  Carry run = combine(carry_in[blockIdx.x], ex);
  const int w_limit = 1 << a.w_bits;
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i >= a.cap)
      break;
    run = combine(run, lane_carry(a, i));
    const int hi = a.hi[i];
    const int lo = a.lo[i];
    const bool is_end =
        i == a.cap - 1 || a.hi[i + 1] != hi || a.lo[i + 1] != lo;
    const int cnt = i - run.start + 1;  // run length == |N(u) ∩ N(w)|
    int du, dw;
    if (a.deg1) {
      du = a.deg0[i];
      dw = a.deg1[i];
    } else {
      // unsigned unpack: a deg(u) >= 2^15 sets the int32 sign bit
      const uint32_t d = (uint32_t)a.deg0[i];
      du = (int)(d >> 16);
      dw = (int)(d & 0xFFFFu);
    }
    bool valid = is_end && hi < w_limit;
    if (a.maxf2)
      valid = valid && du <= mul_wrap(a.maxf2, du) &&
              dw <= mul_wrap(a.maxf2, du);
    const float nuv = __int2float_rn(cnt);
    const float fdu = __int2float_rn(du);
    const float fdw = __int2float_rn(dw);
    int wi = 0;
    for (int m = 0; m < a.n_metrics; ++m) {
      const int code = (int)((a.codes >> (4 * m)) & 0xFu);
      float acc = 0.f;
      if (code == kAdamicAdar || code == kResourceAllocation)
        acc = wi++ == 0 ? run.s0 : run.s1;
      float sc = metric_score(code, nuv, acc, fdu, fdw);
      if (!(valid && sc > a.min_score))
        sc = -INFINITY;
      const int b = __float_as_int(sc);
      // descending-score key, sign-flipped to int32 order
      int key = b < 0 ? (b & 0x7FFFFFFF) : ~b;
      if (sc == -INFINITY)
        key |= i & 0x7FFFFE;  // spread the invalid mass by lane
      a.skeys[(size_t)m * a.cap + i] = key;
    }
    a.ku[i] = min(lo, a.n - 1);
    a.kw[i] = min(hi, a.n - 1);
  }
}

}  // namespace

extern "C" {

// Scratch the launch needs, in bytes: two Carry arrays of one per block.
int64_t lp_fused_tail_scratch_bytes(int64_t cap) {
  const int64_t nblk = (cap + kTile - 1) / kTile;
  return 2 * nblk * (int64_t)sizeof(Carry);
}

// Launches the three phases on `stream` of CUDA device `device`; returns
// cudaGetLastError().
int lp_fused_tail(int device, const void *hi, const void *lo, const void *deg0,
                  const void *deg1, const void *w0, const void *w1,
                  int64_t cap, int n_metrics, uint64_t codes, int w_bits,
                  int n, int maxf2, float min_score, void *skeys, void *ku,
                  void *kw, void *scratch, void *stream) {
  TailArgs a;
  a.hi = static_cast<const int32_t *>(hi);
  a.lo = static_cast<const int32_t *>(lo);
  a.deg0 = static_cast<const int32_t *>(deg0);
  a.deg1 = static_cast<const int32_t *>(deg1);
  a.w0 = static_cast<const float *>(w0);
  a.w1 = static_cast<const float *>(w1);
  a.skeys = static_cast<int32_t *>(skeys);
  a.ku = static_cast<int32_t *>(ku);
  a.kw = static_cast<int32_t *>(kw);
  a.cap = (int)cap;
  a.n_metrics = n_metrics;
  a.codes = codes;
  a.w_bits = w_bits;
  a.n = n;
  a.maxf2 = maxf2;
  a.min_score = min_score;
  const int nblk = (int)((cap + kTile - 1) / kTile);
  if (nblk == 0)
    return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  Carry *agg = static_cast<Carry *>(scratch);
  Carry *carry_in = agg + nblk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tail_aggregate<<<nblk, kThreads, 0, s>>>(a, agg);
  tail_scan_blocks<<<1, kScanThreads, 0, s>>>(agg, carry_in, nblk);
  tail_emit<<<nblk, kThreads, 0, s>>>(a, carry_in);
  return (int)cudaGetLastError();
}

const char *lp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
