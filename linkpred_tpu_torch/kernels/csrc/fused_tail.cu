// Fused post-sort tail for one sorted tile: run reduction, scoring and the
// selection-key emit, in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel linkpred_tpu/ops/fused_tail.py::_tail_kernel
// (launched by fused_tail).  Its plain PyTorch twin, which defines the
// contract, is linkpred_tpu_torch/ops/fused_tail.py::fused_tail_reference.
//
// Input: one tile of `cap` lanes sorted by the pair (hi = candidate w,
// lo = source u, or u << 1 | real on the edge stream), the degree payload
// (deg16-packed pair, or two wide arrays) and up to two float weight arrays
// (AA/RA), all gathered through the sort permutation.  Output per lane: one
// int32 selection key per metric (the order-preserving sign-flipped form of
// the reference's u32 key), ku = min(u, n-1) and kw = min(w, n-1).
//
// Killer branch (`killers`, the edge stream).  lo carries u << 1 and a
// real/killer flag in its low bit; the sort on (w, lo) puts a run's killer
// slots (flag 0) first.  Runs are (w, u) pairs, so run boundaries compare
// lo >> 1, and a run is valid only if its first slot is real (no killer:
// w is neither u nor a neighbour of u).  Killer lanes carry weight 0, so
// the weight sums need no change.
//
// What bounds it: memory.  Per lane it reads 8 bytes of keys, 4 or 8 of
// degrees and 4 per weight array, and writes 4 per metric + 8: 24 bytes a
// lane for deg16 Jaccard (chip_smoke.tail_bytes), 25.2 MB at cap 2^20, a
// few microseconds of HBM time; the arithmetic is a handful of float ops.
//
// Design: one pass, one launch (plus a memset of the look-back words).
//   * A CTA takes the next tile of kTile = 1,024 lanes from an atomic
//     ticket; tickets, not blockIdx, order the tiles, so every tile a CTA
//     waits for belongs to a CTA that is already running.
//   * A thread owns 4 consecutive lanes and reads each array with one
//     16-byte load, neighbouring threads on neighbouring addresses; keys,
//     ku and kw are written the same way.  The lanes are grouped by the
//     misalignment of hi (`head`, as compact.cu does), so a view one lane
//     into its buffer still loads whole vectors; an array aligned otherwise,
//     the first and last vector of the range and a ragged end use scalar
//     accesses.  Every input byte is read once.
//   * The lane before a thread's first lane and the lane after its last come
//     from the neighbouring threads by warp shuffles; only a warp's edge
//     lanes read them from memory (the next tile's first lane included: the
//     input is read-only).
//   * The scan state (Carry) of a range of lanes is its last run start,
//     packed as start << 1 | alive (the twin's cummax form), and the weight
//     sums since that start.  combine(a, b) returns b whenever b holds a run
//     start.  A thread folds its 4 lanes in order, a warp scans by shuffles,
//     one shared-memory pass combines the 8 warp totals: two __syncthreads
//     a tile.
//   * Decoupled look-back.  A tile publishes its aggregate as soon as its
//     fold is done, and its inclusive carry after the look-back.  A warp
//     reads 32 predecessors at a time and stops at the nearest one that has
//     published its inclusive carry or whose aggregate holds a run start:
//     with runs of a few lanes that is the tile just before.  Only a run
//     longer than a tile walks further back.  The carry-in is then folded
//     forward from that predecessor over the aggregates after it, so the
//     weight sums are added in tile order whichever predecessor the walk
//     stopped at: two calls give the same bits.
//   * Publication.  A published carry is one 64-bit word per weight sum
//     (one word when unweighted): the high half holds start + 2 (0 = not
//     yet published), the low half the bits of the sum.  Each word is
//     stored atomically and carries the run start itself, so a reader that
//     sees every word of a carry non-zero has the whole carry; no fence
//     orders one store against another.  The words and the ticket are
//     zeroed on the stream before every launch.
// So no kernel runs as a single CTA, the inputs are read once, and the main
// paths make no strided scalar access.  The float formulas use the _rn
// intrinsics so no FMA contraction or fast-math approximation can change a
// bit: unweighted scores equal the twin's exactly.  Weighted sums are added
// in another order than the twin's log-step scan, so they agree to float32
// rounding.
// start << 1 must fit an int32: the launcher refuses cap >= 2^30.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * 4;  // lanes per tile, 4 a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxCap = int64_t(1) << 30;

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

// Arrays whose 4-lane groups are 16-byte aligned (bit set: vector accesses).
enum VecBit : unsigned {
  kVecHi = 1u,
  kVecLo = 2u,
  kVecDeg0 = 4u,
  kVecDeg1 = 8u,
  kVecW0 = 16u,
  kVecW1 = 32u,
  kVecKu = 64u,
  kVecKw = 128u,
};

// Scan state of a range of lanes: `ps` is start << 1 | alive of the last
// run start in the range (-1 if none; alive is the low bit of that lane's
// lo with killers, else 1), s0/s1 the weight sums since that start (over
// the whole range when it holds no start).
struct Carry {
  int ps;
  float s0;
  float s1;
};

__device__ __forceinline__ Carry identity() { return {-1, 0.f, 0.f}; }

// `a` covers the lanes before `b`; NW weight sums are live.
template <int NW>
__device__ __forceinline__ Carry combine(const Carry &a, const Carry &b) {
  if (b.ps >= 0)
    return b;
  Carry c = a;
  if (NW > 0)
    c.s0 = __fadd_rn(a.s0, b.s0);
  if (NW > 1)
    c.s1 = __fadd_rn(a.s1, b.s1);
  return c;
}

template <int NW>
__device__ __forceinline__ Carry shfl_up(const Carry &c, int d) {
  Carry r = identity();
  r.ps = __shfl_up_sync(kFull, c.ps, d);
  if (NW > 0)
    r.s0 = __shfl_up_sync(kFull, c.s0, d);
  if (NW > 1)
    r.s1 = __shfl_up_sync(kFull, c.s1, d);
  return r;
}

template <int NW>
__device__ __forceinline__ Carry shfl(const Carry &c, int src) {
  Carry r = identity();
  r.ps = __shfl_sync(kFull, c.ps, src);
  if (NW > 0)
    r.s0 = __shfl_sync(kFull, c.s0, src);
  if (NW > 1)
    r.s1 = __shfl_sync(kFull, c.s1, src);
  return r;
}

// ---------------------------------------------------- look-back words

__device__ __forceinline__ unsigned long long word_of(int ps, float s) {
  return (unsigned long long)((unsigned)ps + 2u) << 32 | __float_as_uint(s);
}

template <int NW>
__device__ __forceinline__ void publish(unsigned long long *w,
                                        const Carry &c) {
  atomicExch(w, word_of(c.ps, c.s0));
  if (NW > 1)
    atomicExch(w + 1, word_of(c.ps, c.s1));
}

// Reads a published carry; false while any of its words is unpublished.
template <int NW>
__device__ __forceinline__ bool peek(const unsigned long long *w, Carry *c) {
  const auto *v = reinterpret_cast<const volatile unsigned long long *>(w);
  const unsigned long long a = v[0];
  const unsigned long long b = NW > 1 ? v[1] : a;
  c->ps = (int)((unsigned)(a >> 32) - 2u);
  c->s0 = __uint_as_float((unsigned)a);
  c->s1 = NW > 1 ? __uint_as_float((unsigned)b) : 0.f;
  return (a >> 32) != 0 && (b >> 32) != 0;
}

// The carry of every lane before tile `tile` (> 0), by warp 0: the fold, in
// tile order, from the nearest stop (a predecessor with its inclusive carry
// published, or whose aggregate holds a run start; before tile 0, the
// identity) over the aggregates after it.  The stop's inclusive carry is
// the same fold up to it, and an aggregate that holds a start equals its
// tile's inclusive carry, so the result does not depend on the stop found.
template <int NW>
__device__ Carry look_back(const unsigned long long *agg,
                           const unsigned long long *incl, int tile,
                           int lane) {
  constexpr int kW = NW > 1 ? 2 : 1;  // words per published carry
  int top = tile - 1;  // the window's nearest tile, in lane 0
  Carry v;
  unsigned stops;
  for (;; top -= 32) {
    const int p = top - lane;
    bool stop = true, ready = true;
    do {
      if (p < 0) {
        v = identity();
      } else if (peek<NW>(incl + (int64_t)p * kW, &v)) {
        stop = true;
        ready = true;
      } else {
        ready = peek<NW>(agg + (int64_t)p * kW, &v);
        stop = v.ps >= 0;
      }
    } while (!__all_sync(kFull, ready));
    stops = __ballot_sync(kFull, stop);
    if (stops)
      break;
  }
  const int first = __ffs(stops) - 1;
  Carry excl = shfl<NW>(v, first);
  for (int j = first - 1; j >= 0; --j)
    excl = combine<NW>(excl, shfl<NW>(v, j));
  // the nearer windows: 32 published aggregates each, none with a start
  for (top += 32; top < tile; top += 32) {
    peek<NW>(agg + (int64_t)(top - lane) * kW, &v);
    for (int j = 31; j >= 0; --j)
      excl = combine<NW>(excl, shfl<NW>(v, j));
  }
  return excl;
}

// ------------------------------------------------------- lane accesses

// Lanes i0..i0+3 of `p`; lanes outside [0, cap) read as 0.
__device__ __forceinline__ int4 load4(const int32_t *p, int i0, int cap,
                                      bool vec) {
  if (vec && i0 >= 0 && i0 + 4 <= cap)
    return __ldg(reinterpret_cast<const int4 *>(p + i0));
  int e[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    e[q] = i0 + q >= 0 && i0 + q < cap ? __ldg(p + i0 + q) : 0;
  return make_int4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ void store4(int32_t *p, int i0, int cap, bool vec,
                                       const int (&x)[4]) {
  if (vec && i0 >= 0 && i0 + 4 <= cap) {
    *reinterpret_cast<int4 *>(p + i0) = make_int4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (i0 + q >= 0 && i0 + q < cap)
      p[i0 + q] = x[q];
}

__device__ __forceinline__ void unpack4(int4 v, int (&x)[4]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// ---------------------------------------------------------------- scoring

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

struct TailArgs {
  const int32_t *hi;
  const int32_t *lo;
  const int32_t *deg0;  // deg16 pair, or deg(u) when wide
  const int32_t *deg1;  // deg(w) when wide, else null
  const int32_t *w0;    // first weighted metric's float weights, or null
  const int32_t *w1;    // second weighted metric's float weights, or null
  int32_t *skeys;       // [n_metrics, cap]
  int32_t *ku;
  int32_t *kw;
  int cap;
  int head;      // lane 0 sits `head` lanes past a 16-byte boundary of hi
  unsigned vec;  // VecBit set
  int n_metrics;
  uint64_t codes;  // 4 bits per metric, metric 0 in the low bits
  int w_bits;
  int n;
  int maxf2;
  float min_score;
};

// KILLERS: lo is u << 1 | real (edge stream).  WIDE: deg0/deg1 hold
// deg(u)/deg(w), else deg0 the deg16 pair.  NW: weight arrays (0-2).
template <bool KILLERS, bool WIDE, int NW>
__global__ void __launch_bounds__(kThreads)
    tail_onepass(TailArgs a, unsigned *ticket, unsigned long long *agg,
                 unsigned long long *incl) {
  constexpr int kW = NW > 1 ? 2 : 1;  // words per published carry
  __shared__ unsigned s_tile;
  __shared__ Carry s_warp[kWarps];
  __shared__ Carry s_in;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = (int)s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = a.cap;
  const int i0 = tile * kTile - a.head + 4 * (int)threadIdx.x;

  // every load in flight at once
  int hi[4], lo[4], d0[4], d1[4], w0[4], w1[4];
  unpack4(load4(a.hi, i0, cap, a.vec & kVecHi), hi);
  unpack4(load4(a.lo, i0, cap, a.vec & kVecLo), lo);
  unpack4(load4(a.deg0, i0, cap, a.vec & kVecDeg0), d0);
  if (WIDE)
    unpack4(load4(a.deg1, i0, cap, a.vec & kVecDeg1), d1);
  if (NW > 0)
    unpack4(load4(a.w0, i0, cap, a.vec & kVecW0), w0);
  if (NW > 1)
    unpack4(load4(a.w1, i0, cap, a.vec & kVecW1), w1);
  int src[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    src[k] = KILLERS ? lo[k] >> 1 : lo[k];

  // the lanes on either side of the thread's four
  int prev_hi = __shfl_up_sync(kFull, hi[3], 1);
  int prev_src = __shfl_up_sync(kFull, src[3], 1);
  int next_hi = __shfl_down_sync(kFull, hi[0], 1);
  int next_src = __shfl_down_sync(kFull, src[0], 1);
  if (lane == 0 && i0 >= 1 && i0 - 1 < cap) {
    prev_hi = __ldg(a.hi + i0 - 1);
    const int l = __ldg(a.lo + i0 - 1);
    prev_src = KILLERS ? l >> 1 : l;
  }
  if (lane == 31 && i0 + 4 >= 0 && i0 + 4 < cap) {
    next_hi = __ldg(a.hi + i0 + 4);
    const int l = __ldg(a.lo + i0 + 4);
    next_src = KILLERS ? l >> 1 : l;
  }

  // run boundaries and the in-thread inclusive scan
  bool is_end[4];
  Carry c[4];
  Carry run = identity();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + k;
    const int ph = k ? hi[k - 1] : prev_hi;
    const int psrc = k ? src[k - 1] : prev_src;
    const int nh = k < 3 ? hi[k + 1] : next_hi;
    const int nsrc = k < 3 ? src[k + 1] : next_src;
    const bool in = i >= 0 && i < cap;
    const bool start = i == 0 || hi[k] != ph || src[k] != psrc;
    is_end[k] = i == cap - 1 || hi[k] != nh || src[k] != nsrc;
    Carry l = identity();
    l.ps = in && start ? i << 1 | (KILLERS ? lo[k] & 1 : 1) : -1;
    if (NW > 0)
      l.s0 = __int_as_float(w0[k]);
    if (NW > 1)
      l.s1 = __int_as_float(w1[k]);
    run = combine<NW>(run, l);
    c[k] = run;
  }

  // warp scan of the threads' folds, then the warps' totals
  Carry inc = c[3];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Carry o = shfl_up<NW>(inc, d);
    if (lane >= d)
      inc = combine<NW>(o, inc);
  }
  Carry texcl = shfl_up<NW>(inc, 1);
  if (lane == 0)
    texcl = identity();
  if (lane == 31)
    s_warp[warp] = inc;
  __syncthreads();

  if (warp == 0) {
    Carry total = identity();
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      total = combine<NW>(total, s_warp[v]);
    Carry excl = identity();
    if (tile > 0) {
      if (lane == 0)
        publish<NW>(agg + (int64_t)tile * kW, total);
      excl = look_back<NW>(agg, incl, tile, lane);
    }
    if (lane == 0) {
      publish<NW>(incl + (int64_t)tile * kW, combine<NW>(excl, total));
      s_in = excl;
    }
  }
  __syncthreads();

  Carry pre = s_in;
  for (int v = 0; v < warp; ++v)
    pre = combine<NW>(pre, s_warp[v]);
  pre = combine<NW>(pre, texcl);

  // score the four lanes
  const int w_limit = 1 << a.w_bits;
  bool valid[4];
  float nuv[4], fdu[4], fdw[4], acc0[4], acc1[4];
  int ku[4], kw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Carry r = combine<NW>(pre, c[k]);
    int du, dw;
    if (WIDE) {
      du = d0[k];
      dw = d1[k];
    } else {
      // unsigned unpack: a deg(u) >= 2^15 sets the int32 sign bit
      du = (int)((unsigned)d0[k] >> 16);
      dw = d0[k] & 0xFFFF;
    }
    bool ok = is_end[k] && hi[k] < w_limit && (r.ps & 1);
    if (a.maxf2)
      ok = ok && du <= mul_wrap(a.maxf2, du) && dw <= mul_wrap(a.maxf2, du);
    valid[k] = ok;
    nuv[k] = __int2float_rn(i0 + k - (r.ps >> 1) + 1);  // the run's length
    fdu[k] = __int2float_rn(du);
    fdw[k] = __int2float_rn(dw);
    acc0[k] = r.s0;
    acc1[k] = r.s1;
    ku[k] = min(src[k], a.n - 1);
    kw[k] = min(hi[k], a.n - 1);
  }
  int wi = 0;
  for (int m = 0; m < a.n_metrics; ++m) {
    const int code = (int)((a.codes >> (4 * m)) & 0xFu);
    const bool weighted = code == kAdamicAdar || code == kResourceAllocation;
    int key[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float acc = weighted ? (wi == 0 ? acc0[k] : acc1[k]) : 0.f;
      float sc = metric_score(code, nuv[k], acc, fdu[k], fdw[k]);
      if (!(valid[k] && sc > a.min_score))
        sc = -INFINITY;
      const int b = __float_as_int(sc);
      // descending-score key, sign-flipped to int32 order
      key[k] = b < 0 ? (b & 0x7FFFFFFF) : ~b;
      if (sc == -INFINITY)
        key[k] |= (i0 + k) & 0x7FFFFE;  // spread the invalid mass by lane
    }
    wi += weighted;
    int32_t *row = a.skeys + (size_t)m * cap;
    const bool vec = ((reinterpret_cast<uintptr_t>(row) >> 2) & 3u) ==
                     (unsigned)a.head;
    store4(row, i0, cap, vec, key);
  }
  store4(a.ku, i0, cap, a.vec & kVecKu, ku);
  store4(a.kw, i0, cap, a.vec & kVecKw, kw);
}

int64_t tiles_for(int64_t lanes) { return (lanes + kTile - 1) / kTile; }

template <bool KILLERS, bool WIDE>
void launch(int nw, int64_t ntiles, cudaStream_t s, const TailArgs &a,
            unsigned *ticket, unsigned long long *agg,
            unsigned long long *incl) {
  const unsigned grid = (unsigned)ntiles;
  if (nw == 0)
    tail_onepass<KILLERS, WIDE, 0><<<grid, kThreads, 0, s>>>(a, ticket, agg,
                                                              incl);
  else if (nw == 1)
    tail_onepass<KILLERS, WIDE, 1><<<grid, kThreads, 0, s>>>(a, ticket, agg,
                                                              incl);
  else
    tail_onepass<KILLERS, WIDE, 2><<<grid, kThreads, 0, s>>>(a, ticket, agg,
                                                              incl);
}

// Whether `p` is an array whose 4-lane groups line up with hi's (`head`).
bool lines_up(const void *p, int head) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  return p != nullptr && (u & 3) == 0 && (int)((u >> 2) & 3) == head;
}

}  // namespace

extern "C" {

// Lanes per tile (one CTA's share).
int lp_fused_tail_tile_lanes() { return kTile; }

// Scratch the launch needs, in bytes: the ticket, then an aggregate and an
// inclusive carry of up to two words per tile, for any alignment of hi.
int64_t lp_fused_tail_scratch_bytes(int64_t cap) {
  return (1 + 2 * 2 * tiles_for(cap + 3)) *
         (int64_t)sizeof(unsigned long long);
}

// Zeroes the look-back words and launches the pass on `stream` of CUDA
// device `device`.  Returns cudaErrorInvalidValue unless 0 <= cap < 2^30,
// else the first CUDA error.
int lp_fused_tail(int device, const void *hi, const void *lo, const void *deg0,
                  const void *deg1, const void *w0, const void *w1,
                  int64_t cap, int n_metrics, uint64_t codes, int w_bits,
                  int n, int maxf2, float min_score, int killers, void *skeys,
                  void *ku, void *kw, void *scratch, void *stream) {
  if (cap < 0 || cap >= kMaxCap)
    return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.hi = static_cast<const int32_t *>(hi);
  a.lo = static_cast<const int32_t *>(lo);
  a.deg0 = static_cast<const int32_t *>(deg0);
  a.deg1 = static_cast<const int32_t *>(deg1);
  a.w0 = static_cast<const int32_t *>(w0);
  a.w1 = static_cast<const int32_t *>(w1);
  a.skeys = static_cast<int32_t *>(skeys);
  a.ku = static_cast<int32_t *>(ku);
  a.kw = static_cast<int32_t *>(kw);
  a.cap = (int)cap;
  a.head = (int)((reinterpret_cast<uintptr_t>(hi) >> 2) & 3);
  const void *arrays[8] = {hi, lo, deg0, deg1, w0, w1, ku, kw};
  a.vec = 0;
  for (int b = 0; b < 8; ++b)
    a.vec |= (unsigned)lines_up(arrays[b], a.head) << b;
  a.n_metrics = n_metrics;
  a.codes = codes;
  a.w_bits = w_bits;
  a.n = n;
  a.maxf2 = maxf2;
  a.min_score = min_score;
  const int64_t ntiles = tiles_for(cap + a.head);
  if (cap == 0)
    return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess)
    return (int)err;
  const int nw = w1 ? 2 : w0 ? 1 : 0;
  const int64_t kw_words = nw > 1 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0,
                        (1 + 2 * kw_words * ntiles) *
                            sizeof(unsigned long long),
                        s);
  if (err != cudaSuccess)
    return (int)err;
  unsigned long long *words = static_cast<unsigned long long *>(scratch);
  unsigned *ticket = reinterpret_cast<unsigned *>(words);
  unsigned long long *agg = words + 1;
  unsigned long long *incl = agg + kw_words * ntiles;
  const bool wide = deg1 != nullptr;
  if (killers && wide)
    launch<true, true>(nw, ntiles, s, a, ticket, agg, incl);
  else if (killers)
    launch<true, false>(nw, ntiles, s, a, ticket, agg, incl);
  else if (wide)
    launch<false, true>(nw, ntiles, s, a, ticket, agg, incl);
  else
    launch<false, false>(nw, ntiles, s, a, ticket, agg, incl);
  return (int)cudaGetLastError();
}

const char *lp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
