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
// the full-sort arm).  total < 2^31.
//
// What bounds it: memory.  Each key read once (4 total bytes), each output
// lane written once (8 capacity bytes), the count; no arithmetic to speak
// of.  At 2^24 lanes and capacity 2^22 that is 67.1 MB + 33.6 MB.
//
// Design.  The TPU kernel moves survivors with LSB-first shift routing
// because the TPU has no vector scatter.  A GPU scatters freely, so this is
// a one-pass stream compaction:
//   * pack_onepass: a CTA takes the next tile of 4,096 lanes from an atomic
//     ticket (CTAs start in no order), reads its keys once with 16-byte
//     loads (four keys a thread a load, neighbouring threads on
//     neighbouring addresses, all of a thread's loads in flight), ranks
//     its survivors with warp ballots and a one-warp scan of the (load,
//     warp) counts, and learns the survivors before its tile by a
//     decoupled look-back: each tile publishes its own
//     count, then its inclusive prefix, as one 64-bit status word, and a
//     warp reads 32 predecessors at a time until it meets a prefix.  Then
//     it scatters its survivors to their places.  The last tile's prefix is
//     the count.
//   * pack_fill: the dead lanes [count, capacity), from the device count.
// The status words and the ticket are zeroed on the stream before every
// launch.  A key pointer that is not 16-byte aligned (a view such as
// buf[1:]) and a total that is not a multiple of 4 are read by scalar
// loads in the first and last vector of the range.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;                          // int4 loads per thread
constexpr int kTileLanes = kThreads * kLoads * 4;  // 4,096 lanes per tile
constexpr int kCounts = kLoads * kWarps;           // (load, warp) counts
constexpr int kPer = kCounts / 32;                 // counts a lane scans
constexpr int kFillThreads = 256;
constexpr int kFillMaxBlocks = 2048;
constexpr int32_t kDeadKey = 0x7FFFFFFF;  // sorts after every real key
// status word: flag in the high half, a survivor count in the low half
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own
constexpr unsigned long long kInclusive = 2ull << 32;  // up to its end
constexpr unsigned kFull = 0xffffffffu;
static_assert(kCounts % 32 == 0, "warp 0 scans kPer counts a lane");

// The flag and the count travel in one 64-bit word, stored atomically, and
// a reader reads nothing else the writer wrote, so no fence orders them.
__device__ __forceinline__ void publish(unsigned long long *word,
                                        unsigned long long value) {
  atomicExch(word, value);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long *word) {
  return *reinterpret_cast<const volatile unsigned long long *>(word);
}

// Bit e: element e of the vector is an input lane with key <= t.
__device__ __forceinline__ unsigned survivors(int4 x, unsigned live,
                                              int32_t t) {
  return live & ((unsigned)(x.x <= t) | (unsigned)(x.y <= t) << 1 |
                 (unsigned)(x.z <= t) << 2 | (unsigned)(x.w <= t) << 3);
}

// `key` is 16-byte aligned; the input is its lanes [head, head + total), so
// lane v of `key` is input lane v - head.
__global__ void __launch_bounds__(kThreads)
    pack_onepass(const int32_t *key, int head, int64_t total,
                 const int32_t *thr, int64_t capacity, int32_t *pk,
                 int32_t *pidx, int *count, unsigned *ticket,
                 unsigned long long *status, int64_t ntiles) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_off[kCounts];  // (load, warp) offsets in the tile
  __shared__ unsigned s_prefix;        // survivors before the tile
  if (threadIdx.x == 0)
    s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int32_t t = *thr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t end = total + head;
  const int4 *vec = reinterpret_cast<const int4 *>(key);
  const int64_t v_first = tile * kLoads * kThreads + threadIdx.x;

  // every load in flight at once; whole vectors by 16-byte loads, the
  // first and last vector of the range by scalar ones
  int4 x[kLoads];
  unsigned live = 0;  // bit r: vector r is whole
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int64_t v0 = (v_first + (int64_t)r * kThreads) * 4;
    if (v0 >= head && v0 + 4 <= end) {
      x[r] = __ldg(vec + v0 / 4);
      live |= 1u << r;
    } else {
      int e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        e[q] = v0 + q >= head && v0 + q < end ? key[v0 + q] : 0;
      x[r] = make_int4(e[0], e[1], e[2], e[3]);
    }
  }
  auto lanes_in = [&](int r) -> unsigned {
    if ((live >> r) & 1u)
      return 0xFu;
    const int64_t v0 = (v_first + (int64_t)r * kThreads) * 4;
    unsigned m = 0;
    for (int q = 0; q < 4; ++q)
      m |= (unsigned)(v0 + q >= head && v0 + q < end) << q;
    return m;
  };

#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const unsigned surv = survivors(x[r], lanes_in(r), t);
    unsigned all = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      all += __popc(__ballot_sync(kFull, (surv >> q) & 1u));
    if (lane == 0)
      s_off[r * kWarps + warp] = all;
  }
  __syncthreads();

  if (warp == 0) {
    unsigned c[kPer], mine = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      c[i] = s_off[kPer * lane + i];
      mine += c[i];
    }
    unsigned inc = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o)
        inc += y;
    }
    unsigned run = inc - mine;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      s_off[kPer * lane + i] = run;
      run += c[i];
    }
    const unsigned agg = __shfl_sync(kFull, inc, 31);
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0)
        publish(status, kInclusive | agg);
    } else {
      if (lane == 0)
        publish(status + tile, kAggregate | agg);
      // look back over 32 predecessors at a time, nearest in lane 0
      for (int64_t last = tile - 1;; last -= 32) {
        const int64_t p = last - lane;
        unsigned long long w;
        do {
          w = p >= 0 ? peek(status + p) : kInclusive;
        } while (__any_sync(kFull, (w >> 32) == 0));
        const unsigned done = __ballot_sync(kFull, (w & kInclusive) != 0);
        const int stop = done ? __ffs(done) - 1 : 31;
        unsigned v = lane <= stop ? (unsigned)w : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(kFull, v, o);
        excl += v;
        if (done)
          break;
      }
      if (lane == 0)
        publish(status + tile, kInclusive | (excl + agg));
    }
    if (lane == 0) {
      s_prefix = excl;
      if (tile == ntiles - 1)
        *count = (int)(excl + agg);
    }
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const unsigned surv = survivors(x[r], lanes_in(r), t);
    int64_t pos = (int64_t)s_prefix + s_off[r * kWarps + warp];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pos += __popc(__ballot_sync(kFull, (surv >> q) & 1u) & below);
    const int64_t v0 = (v_first + (int64_t)r * kThreads) * 4;
    const int e[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((surv >> q) & 1u) {
        if (pos < capacity) {
          pk[pos] = e[q];
          pidx[pos] = (int32_t)(v0 + q - head);
        }
        ++pos;
      }
    }
  }
}

// Dead lanes [count, capacity) of the 16-byte aligned outputs, by 16-byte
// stores where a whole vector is dead.
__global__ void pack_fill(const int *count, int64_t capacity, int32_t *pk,
                          int32_t *pidx) {
  const int64_t c = *count;
  const int64_t live = c < capacity ? c : capacity;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = live / 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v * 4 < capacity; v += stride) {
    if (v * 4 >= live && v * 4 + 4 <= capacity) {
      reinterpret_cast<int4 *>(pk)[v] =
          make_int4(kDeadKey, kDeadKey, kDeadKey, kDeadKey);
      reinterpret_cast<int4 *>(pidx)[v] = make_int4(0, 0, 0, 0);
    } else {
      for (int64_t p = v * 4; p < v * 4 + 4 && p < capacity; ++p) {
        if (p >= live) {
          pk[p] = kDeadKey;
          pidx[p] = 0;
        }
      }
    }
  }
}

int64_t tiles_for(int64_t lanes) {
  return (lanes + kTileLanes - 1) / kTileLanes;
}

}  // namespace

extern "C" {

// Scratch the launch needs, in bytes: the ticket and one status word per
// tile, for any alignment of the keys.
int64_t lp_pack_scratch_bytes(int64_t total) {
  return (1 + tiles_for(total + 3)) * (int64_t)sizeof(unsigned long long);
}

// Zeroes the scratch and launches the pack and the fill on `stream` of CUDA
// device `device`; `key` is int32[total] (4-byte aligned), `pk` and `pidx`
// int32[capacity] (16-byte aligned), `thr` and `count` device int32
// scalars.  Returns cudaErrorInvalidValue unless
// 0 <= capacity <= total < 2^31, else the first CUDA error.
int lp_pack_survivors(int device, const void *key, const void *thr,
                      int64_t total, int64_t capacity, void *pk, void *pidx,
                      void *count, void *scratch, void *stream) {
  if (total < 0 || total >= ((int64_t)1 << 31) || capacity < 0 ||
      capacity > total)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int head = (int)((reinterpret_cast<uintptr_t>(key) & 15) / 4);
  const int64_t ntiles = tiles_for(total + head);
  int *cnt = static_cast<int *>(count);
  int32_t *out_k = static_cast<int32_t *>(pk);
  int32_t *out_i = static_cast<int32_t *>(pidx);
  if (ntiles == 0) {
    err = cudaMemsetAsync(cnt, 0, sizeof(int), s);
  } else {
    err = cudaMemsetAsync(scratch, 0,
                          (1 + ntiles) * sizeof(unsigned long long), s);
    if (err != cudaSuccess)
      return (int)err;
    unsigned long long *words = static_cast<unsigned long long *>(scratch);
    pack_onepass<<<(unsigned)ntiles, kThreads, 0, s>>>(
        static_cast<const int32_t *>(key) - head, head, total,
        static_cast<const int32_t *>(thr), capacity, out_k, out_i, cnt,
        reinterpret_cast<unsigned *>(words), words + 1, ntiles);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || capacity == 0)
    return (int)err;
  const int64_t want = (capacity / 4 + kFillThreads) / kFillThreads;
  pack_fill<<<(unsigned)(want < kFillMaxBlocks ? want : kFillMaxBlocks),
              kFillThreads, 0, s>>>(cnt, capacity, out_k, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
