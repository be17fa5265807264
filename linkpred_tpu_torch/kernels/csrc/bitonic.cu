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
// Contract: the caller hands a stage table (k, j), in the network's order,
// a launch table that groups it (pallas_bitonic.py::plan_launches), and
// arrays it owns (the wrappers copy the caller's input first).  Stage (k, j)
// compare-exchanges every lane i with (i & j) == 0 against its partner
// i | j, ascending iff (i & k) == 0, with i the global lane index.  A pair
// swaps, key and payload together, only on a strict inequality:
// asc ? key[i] > key[i|j] : key[i] < key[i|j].  On equal keys both lanes
// keep their own payload, which is the TPU kernels' keep_own rule, so the
// payload equals theirs lane for lane, not just up to ties.
//
// What bounds it: memory.  The least traffic is each key (and payload) read
// once and written once, 8 n bytes (16 n with a payload); the network does
// n/2 compares in each of m(m+1)/2 stages, a few microseconds of integer
// work at 2^20 lanes.  So the design counts passes over the arrays, and
// inside a pass the shared-memory round trips.
//
// Design.  The TPU kernel runs every stage in one VMEM-resident block; a
// CTA here holds a block of 2^13 lanes (66 KB with the payload, three CTAs
// to an SM) in dynamic shared memory.  Each lane's direction comes from its
// global index, so stages may be grouped into launches freely as long as
// every partner is in the block.  One kernel, bitonic_block, two kinds of
// block:
//   * tile launches (kind 0): the block is 2^13 consecutive lanes and the
//     launch runs a run of consecutive stages with j < 2^13, of one or
//     more k;
//   * global launches (kind 1): the block gathers 2^b runs of 2^c
//     consecutive lanes (c = 13 - b >= 5: 128-byte runs), the runs at
//     stride 2^g; the launch runs the b stages (k, 2^(g+b-1)) ... (k, 2^g)
//     of one k, one pass over the arrays for up to 8 stages.
// A CTA moves its block between global and shared memory by 16-byte
// vectors.  Inside the block each thread takes 32 lanes that differ in
// five consecutive index bits into registers (a window), runs the stages
// of those bits there, and writes them back: one __syncthreads per five
// stages, none inside them.  Keys of descending lanes are bit-flipped in
// registers, so each compare-exchange is a min/max.  The window's
// position is a template argument, so every shared-memory address is a
// register plus a constant; one pad word after every 32 keeps each warp's
// 32 accesses in 32 banks for every position.  The merges with k <= 32 run
// in one window.  plan_launches puts all stages with k <= 2^13 in one tile
// launch, then for each larger k its global stages in ceil(s/8) launches
// and the rest in one tile launch: 15 launches at 2^20.  lp_bitonic_sort
// checks the launch table against the stage table and runs it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlockLog2 = 13;  // lanes a CTA holds
constexpr int kHold = 5;           // log2 of the lanes a thread holds
constexpr int kHoldLanes = 1 << kHold;
constexpr int kMaxThreads = 1 << (kMaxBlockLog2 - kHold);
constexpr int kTileLaunch = 0;
constexpr int kGlobalLaunch = 1;

// Shared-memory word of block lane i: a pad word after every 32 lanes.
// For i and o with no bit in common, padded(i | o) = padded(i) + padded(o).
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

// Lanes of a window whose index has bit b set.
__device__ constexpr unsigned bit_set_mask(int b) {
  return b == 0   ? 0xAAAAAAAAu
         : b == 1 ? 0xCCCCCCCCu
         : b == 2 ? 0xF0F0F0F0u
         : b == 3 ? 0xFF00FF00u
                  : 0xFFFF0000u;
}

// Lanes that sort descending carry their key bit-flipped (~x reverses the
// signed order), so every compare-exchange puts the smaller key first and
// swaps on a strict inequality: ka > kb is asc ? a > b : a < b of the
// unflipped keys, the network's rule.
template <bool kPayload>
__device__ __forceinline__ void order(int32_t &ka, int32_t &kb, int32_t &pa,
                                      int32_t &pb) {
  if (kPayload) {
    const bool swap = ka > kb;
    const int32_t k0 = swap ? kb : ka, k1 = swap ? ka : kb;
    const int32_t p0 = swap ? pb : pa, p1 = swap ? pa : pb;
    ka = k0;
    kb = k1;
    pa = p0;
    pb = p1;
  } else {
    const int32_t lo = min(ka, kb), hi = max(ka, kb);
    ka = lo;
    kb = hi;
  }
}

// One stage over the 32 lanes in registers: element o is the block lane
// own | o << g0, so the stage whose partner flips bit OB of o pairs o with
// o | 1 << OB, o the lower lane.
template <bool kPayload, int OB>
__device__ __forceinline__ void held_stage(int32_t (&k)[kHoldLanes],
                                           int32_t (&p)[kHoldLanes]) {
#pragma unroll
  for (int o = 0; o < kHoldLanes; ++o) {
    if (o & (1 << OB))
      continue;
    order<kPayload>(k[o], k[o | (1 << OB)], p[o], p[o | (1 << OB)]);
  }
}

// The stages of bits hi_o down to lo_o of the 32 lanes in registers.
template <bool kPayload>
__device__ __forceinline__ void held_stages(int32_t (&k)[kHoldLanes],
                                            int32_t (&p)[kHoldLanes],
                                            int hi_o, int lo_o) {
  static_assert(kHold == 5, "one case per bit");
  for (int ob = hi_o; ob >= lo_o; --ob) {
    switch (ob) {
    case 4: held_stage<kPayload, 4>(k, p); break;
    case 3: held_stage<kPayload, 3>(k, p); break;
    case 2: held_stage<kPayload, 2>(k, p); break;
    case 1: held_stage<kPayload, 1>(k, p); break;
    default: held_stage<kPayload, 0>(k, p); break;
    }
  }
}

// Where k's bit lies for the block: `ksb` is its bit in the block index,
// or -1 when it lies in the bits the CTA index gives, and then `kblk` is
// its value there.
struct Direction {
  int ksb;
  bool kblk;
};

// Bit o: lane own | o of the lowest window (own = t << 5) sorts
// descending.
__device__ __forceinline__ unsigned low_desc(Direction d, int own) {
  if (d.ksb < 0)
    return d.kblk ? ~0u : 0u;
  if (d.ksb < kHold)
    return bit_set_mask(d.ksb);
  return ((own >> d.ksb) & 1) ? ~0u : 0u;
}

// All ones where bit o of `desc` is set, else zero.
__device__ __forceinline__ int32_t flip_of(unsigned desc, int o) {
  return (int32_t)(desc << (31 - o)) >> 31;
}

// One window: the thread's 32 lanes differ in block bits G0 .. G0+4; runs
// the stages of block bits hi down to lo (all inside the window).  The
// window lies below k's bit (the merges with k <= 32 run in their own
// window), so the thread's lanes share one direction: `flip` is ~0 where
// they sort descending.
template <bool kPayload, int G0>
__device__ __forceinline__ void window(int32_t *sk, int32_t *sp, int t,
                                       Direction d, int hi, int lo) {
  const int own = (t & ((1 << G0) - 1)) | ((t >> G0) << (G0 + kHold));
  const int at = padded(own);
  const int32_t flip =
      (d.ksb < 0 ? d.kblk : ((own >> d.ksb) & 1) != 0) ? ~0 : 0;
  int32_t rk[kHoldLanes], rp[kHoldLanes];
#pragma unroll
  for (int o = 0; o < kHoldLanes; ++o) {
    rk[o] = sk[at + padded(o << G0)] ^ flip;
    if (kPayload)
      rp[o] = sp[at + padded(o << G0)];
  }
  held_stages<kPayload>(rk, rp, hi - G0, lo - G0);
#pragma unroll
  for (int o = 0; o < kHoldLanes; ++o) {
    sk[at + padded(o << G0)] = rk[o] ^ flip;
    if (kPayload)
      sp[at + padded(o << G0)] = rp[o];
  }
}

template <bool kPayload>
__device__ __forceinline__ void run_window(int32_t *sk, int32_t *sp, int t,
                                           Direction d, int g0, int hi,
                                           int lo) {
  static_assert(kMaxBlockLog2 - kHold == 8, "one case per window position");
  switch (g0) {
  case 0: window<kPayload, 0>(sk, sp, t, d, hi, lo); break;
  case 1: window<kPayload, 1>(sk, sp, t, d, hi, lo); break;
  case 2: window<kPayload, 2>(sk, sp, t, d, hi, lo); break;
  case 3: window<kPayload, 3>(sk, sp, t, d, hi, lo); break;
  case 4: window<kPayload, 4>(sk, sp, t, d, hi, lo); break;
  case 5: window<kPayload, 5>(sk, sp, t, d, hi, lo); break;
  case 6: window<kPayload, 6>(sk, sp, t, d, hi, lo); break;
  case 7: window<kPayload, 7>(sk, sp, t, d, hi, lo); break;
  default: window<kPayload, 8>(sk, sp, t, d, hi, lo); break;
  }
}

__device__ __forceinline__ int log2_of(int64_t x) {
  return 63 - __clzll((unsigned long long)x);
}

// `count` stages in the network's order from (k, j) over the CTA's block
// of 2^block_log2 lanes: block lane s is global lane
//   (s mod 2^c) | (s >> c) << g | the CTA's bits,
// the CTA index filling global bits c .. g-1, then g+b upwards
// (b = block_log2 - c).  Tile launches: c = g = block_log2.  Every stage's
// bit lies in the block: below c, or in g .. g+b-1 (block bit c + bit - g).
// Global memory moves by 16-byte vectors (c >= 5).
template <bool kPayload>
__global__ void __launch_bounds__(kMaxThreads, 2)
    bitonic_block(int32_t *key, int32_t *pay, int block_log2, int c, int g,
                  int64_t k, int64_t j, int count) {
  extern __shared__ int32_t smem[];
  const int size = 1 << block_log2;
  const int b = block_log2 - c;
  int32_t *sk = smem;
  int32_t *sp = smem + padded(size);
  const int64_t cta = blockIdx.x;
  const int64_t below = cta & (((int64_t)1 << (g - c)) - 1);
  const int64_t cta_bits = (below << c) | ((cta >> (g - c)) << (g + b));
  const int low_mask = (1 << c) - 1;
  auto global_lane = [&](int s) {
    return cta_bits | (s & low_mask) | ((int64_t)(s >> c) << g);
  };
  for (int s = 4 * threadIdx.x; s < size; s += 4 * blockDim.x) {
    const int64_t i = global_lane(s);
    const int4 v = *reinterpret_cast<const int4 *>(key + i);
    sk[padded(s)] = v.x;
    sk[padded(s) + 1] = v.y;
    sk[padded(s) + 2] = v.z;
    sk[padded(s) + 3] = v.w;
    if (kPayload) {
      const int4 w = *reinterpret_cast<const int4 *>(pay + i);
      sp[padded(s)] = w.x;
      sp[padded(s) + 1] = w.y;
      sp[padded(s) + 2] = w.z;
      sp[padded(s) + 3] = w.w;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  auto block_bit = [&](int bit) { return bit < c ? bit : c + bit - g; };
  auto direction = [&](int64_t kk) {
    const int kb = log2_of(kk);
    Direction d;
    d.ksb = kb < c ? kb : (kb >= g && kb < g + b ? c + kb - g : -1);
    d.kblk = ((cta_bits >> kb) & 1) != 0;
    return d;
  };
  if (j < kHoldLanes) {
    // the merges whose stages all lie in block bits 0..4, in one window
    // (tile launches only: a global stage's j is at least 2^13); between
    // merges each key is re-flipped for the next k's direction
    const int own = t << kHold;
    const int at = padded(own);
    int32_t rk[kHoldLanes], rp[kHoldLanes];
    unsigned desc = low_desc(direction(k), own);
#pragma unroll
    for (int o = 0; o < kHoldLanes; ++o) {
      rk[o] = sk[at + padded(o)] ^ flip_of(desc, o);
      if (kPayload)
        rp[o] = sp[at + padded(o)];
    }
    while (true) {
      const int jb = log2_of(j);
      const int nst = count < jb + 1 ? count : jb + 1;
      held_stages<kPayload>(rk, rp, jb, jb - nst + 1);
      count -= nst;
      k <<= 1;
      j = k >> 1;
      if (count == 0 || j >= kHoldLanes)
        break;
      const unsigned next = low_desc(direction(k), own);
#pragma unroll
      for (int o = 0; o < kHoldLanes; ++o)
        rk[o] ^= flip_of(desc ^ next, o);
      desc = next;
    }
#pragma unroll
    for (int o = 0; o < kHoldLanes; ++o) {
      sk[at + padded(o)] = rk[o] ^ flip_of(desc, o);
      if (kPayload)
        sp[at + padded(o)] = rp[o];
    }
    __syncthreads();
  }
  while (count > 0) {
    // this merge's stages: global bits log2(j) down to jb - nst + 1
    const int jb = log2_of(j);
    const int nst = count < jb + 1 ? count : jb + 1;
    const int s_lo = block_bit(jb - nst + 1);
    const Direction d = direction(k);
    for (int hi = block_bit(jb); hi >= s_lo;) {
      const int g0 = hi - kHold + 1 > 0 ? hi - kHold + 1 : 0;
      run_window<kPayload>(sk, sp, t, d, g0, hi, s_lo > g0 ? s_lo : g0);
      __syncthreads();
      hi = g0 - 1;
    }
    count -= nst;
    k <<= 1;
    j = k >> 1;
  }
  for (int s = 4 * threadIdx.x; s < size; s += 4 * blockDim.x) {
    const int64_t i = global_lane(s);
    *reinterpret_cast<int4 *>(key + i) =
        make_int4(sk[padded(s)], sk[padded(s) + 1], sk[padded(s) + 2],
                  sk[padded(s) + 3]);
    if (kPayload)
      *reinterpret_cast<int4 *>(pay + i) =
          make_int4(sp[padded(s)], sp[padded(s) + 1], sp[padded(s) + 2],
                    sp[padded(s) + 3]);
  }
}

bool pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

int host_log2(int64_t x) {
  int b = 0;
  while (((int64_t)1 << b) < x)
    ++b;
  return b;
}

template <bool kPayload>
int run(int32_t *key, int32_t *pay, int64_t n, const int32_t *ks,
        const int32_t *js, int64_t nstages, const int32_t *plan,
        int64_t nlaunch, int block_log2, cudaStream_t s, int64_t *launched) {
  const int64_t size = (int64_t)1 << block_log2;
  const size_t smem =
      (size_t)padded((int)size) * sizeof(int32_t) * (kPayload ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_block<kPayload>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess)
    return (int)err;
  int64_t next = 0;  // the launches cover the table in order
  for (int64_t l = 0; l < nlaunch; ++l) {
    const int kind = plan[3 * l];
    const int64_t first = plan[3 * l + 1];
    const int count = plan[3 * l + 2];
    if ((kind != kTileLaunch && kind != kGlobalLaunch) || first != next ||
        count < 1 || first + count > nstages)
      return (int)cudaErrorInvalidValue;
    next = first + count;
    const int64_t k = ks[first];
    const int64_t j = js[first];
    // the run must be the table's stages in the network's order, below the
    // block for a tile launch, at or above it and in one k for a global one
    int64_t kk = k, jj = j;
    for (int i = 0; i < count; ++i) {
      if (!pow2(kk) || !pow2(jj) || jj >= kk || kk > n ||
          ks[first + i] != kk || js[first + i] != jj ||
          (kind == kTileLaunch) != (jj < size) ||
          (kind == kGlobalLaunch && kk != k))
        return (int)cudaErrorInvalidValue;
      if (jj > 1) {
        jj >>= 1;
      } else {
        kk <<= 1;
        jj = kk >> 1;
      }
    }
    int c = block_log2, g = block_log2;
    if (kind == kGlobalLaunch) {
      c = block_log2 - count;
      g = host_log2(j) - count + 1;
      if (c < kHold)
        return (int)cudaErrorInvalidValue;
    }
    bitonic_block<kPayload>
        <<<(unsigned)(n >> block_log2), (unsigned)(size >> kHold), smem, s>>>(
            key, pay, block_log2, c, g, k, j, count);
    err = cudaGetLastError();
    if (err != cudaSuccess)
      return (int)err;
    ++*launched;
  }
  return next == nstages ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Runs the stage table (ks[s], js[s]), s < nstages, over the n int32 keys at
// `key` and, unless `pay` is null, the int32 payload at `pay`, in place, on
// `stream` of CUDA device `device` (both 16-byte aligned), grouped by the
// launch table `plan`:
// nlaunch rows (kind, first stage, stage count) over CTA blocks of
// 2^block_log2 lanes, kind 0 a tile launch, kind 1 a global launch of at
// most block_log2 - 5 stages.  n is a power of two; the tables are host
// arrays.  `*launched` (a host word) is set to the count of kernel launches
// made.  Returns a CUDA error code: cudaErrorInvalidValue for a bad n,
// block or table (checked before each launch, so a bad table may stop
// after some launches ran), else cudaGetLastError() after each launch.
int lp_bitonic_sort(int device, void *key, void *pay, int64_t n,
                    const int32_t *ks, const int32_t *js, int64_t nstages,
                    const int32_t *plan, int64_t nlaunch, int block_log2,
                    void *stream, int64_t *launched) {
  *launched = 0;
  if (!pow2(n) || block_log2 < kHold || block_log2 > kMaxBlockLog2 ||
      ((int64_t)1 << block_log2) > n ||
      (reinterpret_cast<uintptr_t>(key) | reinterpret_cast<uintptr_t>(pay)) &
          15)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t *k = static_cast<int32_t *>(key);
  int32_t *p = static_cast<int32_t *>(pay);
  return p ? run<true>(k, p, n, ks, js, nstages, plan, nlaunch, block_log2, s,
                       launched)
           : run<false>(k, p, n, ks, js, nstages, plan, nlaunch, block_log2,
                        s, launched);
}

// The limits the launch table is planned for, which the planner
// (pallas_bitonic.py: TILE, RUN_LOG2, TILE_LAUNCH, GLOBAL_LAUNCH) must
// share: log2 of the lanes a CTA holds, log2 of the shortest run a global
// launch gathers, and the two launch kinds.
void lp_bitonic_limits(int32_t *out) {
  out[0] = kMaxBlockLog2;
  out[1] = kHold;
  out[2] = kTileLaunch;
  out[3] = kGlobalLaunch;
}

}  // extern "C"
