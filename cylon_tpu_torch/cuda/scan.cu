// Inclusive scans of 1-D 32-bit arrays on Hopper (sm_90a): plain
// (cumsum / cummax / cummin, optionally right to left) and segmented
// (restart at reset flags).  Replaces the JAX package's Pallas TPU scans:
//   cylon_tpu/ops/pallas_scan.py:222  _scan_padded           (plain)
//   cylon_tpu/ops/pallas_scan.py:150  _segmented_scan_padded sweep 1
//   cylon_tpu/ops/pallas_scan.py:177  _segmented_scan_padded sweep 2
//
// Combine, as in the reference: (va,fa) o (vb,fb) = (fb ? vb : fn(va,vb),
// fa|fb), fn in {sum, min, max}; the plain scan is the case of no flags.
// Blocks on a GPU run in parallel and in no order, so the TPU kernels'
// sequential grid carry has no counterpart here.
//
// Bound: memory.  The plain scan must read 4 B and write 4 B per element
// (0.321 ms at 2^27 elements on an H100 at 3.35 TB/s), the segmented scan
// 4 B + 1 B flag in and 4 B out.
//
// Plain scan: one pass with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016): one launch after a memset, 8 B per element.  It replaces a tile
// scan, a recursive scan of the tile totals and a fix-up that re-read and
// re-wrote every element (16 B per element, five launches at 2^27).
//   - A block takes its tile from an atomic counter, not from blockIdx.x:
//     every tile it waits on then belongs to a block that is already
//     running, while blocks start in no guaranteed order.
//   - Its kLbWarps data warps load the tile's kLbTile elements into
//     registers with 16-byte vector loads (each warp instruction reads 512
//     contiguous bytes), scan them with warp shuffles, and publish the
//     tile's aggregate without waiting for anything else.
//   - Meanwhile warp 0 looks back over the predecessors' status words, 32
//     at a time (__ballot_sync over their flags), until it meets an
//     inclusive prefix, so the look-back's round trips overlap the loads
//     instead of following them; then it publishes the tile's own prefix,
//     and the data warps fold the exclusive prefix into their registers and
//     store with vector stores.
//   - A status word packs (flag, value bits) into 64 bits: one store, never
//     read torn, so relaxed GPU-scope loads and stores are enough (nothing
//     else is read on the strength of a flag; acquire / release cost more).
//     Each word has its own 128-byte line: packed 8 bytes apart, hundreds
//     of warps polling the newest tiles queue on a few lines of L2
//     (variants "acquire_release" and "stride1" of cuda/scan_variants.py).
//   - The status words and the tile counter are one scratch buffer from
//     the wrapper, zeroed by a memset on the same stream before the launch.
//   - `reverse` maps logical i to physical n-1-i.  A vector of 4 whose
//     span is not 16-byte aligned (n % 4 != 0 when reversed, a view at an
//     odd offset) or runs past the end is loaded and stored element by
//     element in the same kernel.
//   Integer scans and min/max are exact.  A float32 sum folds a varying
//   mix of predecessor aggregates and prefixes, so two calls may differ by
//   rounding: it is held to a tolerance, as the Pallas kernel's own
//   contract says (pallas_scan.py:26-31), never to reproducibility.
//
// Segmented scan: scan-then-propagate in three kinds of launch, about 9 B
// per element.
//   1. tile_scan: each block scans one tile of kTile elements.  Coalesced
//      loads into padded shared memory, a sequential scan of kItems
//      consecutive elements per thread in registers, a warp-shuffle scan
//      of the thread totals, a shared-memory scan of the warp totals, a
//      re-scan seeded with each thread's prefix, coalesced stores.  It
//      writes the tile's (total, any_reset) and the offset of its first
//      reset.
//   2. The tile totals are scanned by the same kernel, recursively (the
//      Python wrapper recurses until one tile is left).
//   3. fixup: tile t folds the scanned total of tiles [0, t) into its
//      elements before its first reset, so it stops at the first reset.
//   Padding is the op's neutral element, so ragged tails need no special
//   case.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// segmented scan tiles
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kPadded = kTile + kTile / 32;

// look-back scan tiles: each thread holds kVecs vectors of 4 elements; a
// slot is the 128 elements that one warp holds in one vector position
constexpr int kLbThreads = 256;  // data threads; warp 0 looks back
constexpr int kBlockThreads = kLbThreads + 32;
constexpr int kVecs = 4;
constexpr int kLbWarps = kLbThreads / 32;
constexpr int kLbTile = kLbThreads * kVecs * 4;
constexpr int kSlots = kVecs * kLbWarps;
constexpr int kSlotsPerLane = (kSlots + 31) / 32;  // one warp scans them
// tile t's status word is word t*kStatusStride of the scratch buffer: one
// 128-byte line each, so the warps polling recent tiles spread over L2
// slices instead of queueing on one line
constexpr int kStatusStride = 16;


enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum DType { kI32 = 0, kF32 = 1, kU32 = 2 };
// status word flags; the memset's zero is kNotReady
enum Flag : unsigned { kNotReady = 0, kAggregate = 1, kPrefix = 2 };

__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

template <typename T> struct Lim;
template <> struct Lim<int> {
  __device__ static int lowest() { return -2147483647 - 1; }
  __device__ static int highest() { return 2147483647; }
};
template <> struct Lim<unsigned> {
  __device__ static unsigned lowest() { return 0u; }
  __device__ static unsigned highest() { return 0xFFFFFFFFu; }
};
template <> struct Lim<float> {
  __device__ static float lowest() { return -__int_as_float(0x7f800000); }
  __device__ static float highest() { return __int_as_float(0x7f800000); }
};

template <typename T> __device__ __forceinline__ bool is_nan(T) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float a) { return a != a; }

template <typename T> __device__ __forceinline__ T add(T a, T b) { return a + b; }
// two's-complement wrap, like jnp's int32 add, without signed overflow
template <> __device__ __forceinline__ int add<int>(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <typename T, int OP> struct Fn;
template <typename T> struct Fn<T, kSum> {
  __device__ static T neutral() { return T(0); }
  __device__ static T apply(T a, T b) { return add<T>(a, b); }
};
// min/max propagate NaN, like jnp.minimum / torch.minimum
template <typename T> struct Fn<T, kMin> {
  __device__ static T neutral() { return Lim<T>::highest(); }
  __device__ static T apply(T a, T b) { return (is_nan(a) || a < b) ? a : b; }
};
template <typename T> struct Fn<T, kMax> {
  __device__ static T neutral() { return Lim<T>::lowest(); }
  __device__ static T apply(T a, T b) { return (is_nan(a) || a > b) ? a : b; }
};

template <typename T> __device__ __forceinline__ unsigned to_bits(T v);
template <> __device__ __forceinline__ unsigned to_bits<int>(int v) {
  return static_cast<unsigned>(v);
}
template <> __device__ __forceinline__ unsigned to_bits<unsigned>(unsigned v) {
  return v;
}
template <> __device__ __forceinline__ unsigned to_bits<float>(float v) {
  return __float_as_uint(v);
}
template <typename T> __device__ __forceinline__ T from_bits(unsigned b);
template <> __device__ __forceinline__ int from_bits<int>(unsigned b) {
  return static_cast<int>(b);
}
template <> __device__ __forceinline__ unsigned from_bits<unsigned>(unsigned b) {
  return b;
}
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

// -- plain scan: decoupled look-back ------------------------------------------

__device__ __forceinline__ unsigned long long pack(unsigned flag, unsigned bits) {
  return (static_cast<unsigned long long>(flag) << 32) | bits;
}
__device__ __forceinline__ unsigned flag_of(unsigned long long w) {
  return static_cast<unsigned>(w >> 32);
}

// relaxed, GPU scope: see the note at the top
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Logical elements l..l+3 (l % 4 == 0) lie at physical l..l+3, or at
// n-4-l..n-1-l reversed; they move as one 16-byte vector when `vec` (the
// array's span is 16-byte aligned) and they lie inside the array.
__device__ __forceinline__ bool whole(long long n, long long l, bool vec) {
  return vec && l + 3 < n;
}
__device__ __forceinline__ long long vec_pos(long long n, long long l,
                                             bool rev) {
  return rev ? n - 4 - l : l;
}

template <typename T>
__device__ __forceinline__ void unpack4(uint4 q, bool rev, T (&v)[4]) {
  if (rev) {
    v[0] = from_bits<T>(q.w); v[1] = from_bits<T>(q.z);
    v[2] = from_bits<T>(q.y); v[3] = from_bits<T>(q.x);
  } else {
    v[0] = from_bits<T>(q.x); v[1] = from_bits<T>(q.y);
    v[2] = from_bits<T>(q.z); v[3] = from_bits<T>(q.w);
  }
}

// element by element; past n reads `fill`
template <typename T>
__device__ __forceinline__ void load4_scalar(const T* __restrict__ x,
                                             long long n, long long l,
                                             bool rev, T fill, T (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = l + j;
    v[j] = i < n ? x[rev ? n - 1 - i : i] : fill;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ out, long long n,
                                       long long l, bool rev, bool vec,
                                       const T (&v)[4]) {
  if (whole(n, l, vec)) {
    uint4 q;
    if (rev)
      q = make_uint4(to_bits(v[3]), to_bits(v[2]), to_bits(v[1]), to_bits(v[0]));
    else
      q = make_uint4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]), to_bits(v[3]));
    *reinterpret_cast<uint4*>(out + vec_pos(n, l, rev)) = q;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = l + j;
    if (i < n) out[rev ? n - 1 - i : i] = v[j];
  }
}

template <typename T, int OP>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = Fn<T, OP>::apply(o, v);
  }
  return v;
}

// Exclusive prefix of `tile` (> 0) from its predecessors' status words,
// called by one whole warp.  Each round lane i reads tile end-i, the warp
// waits until all 32 are ready and folds their values up to the nearest
// inclusive prefix.  Tiles before 0 read as the neutral prefix; tile 0
// always publishes a prefix, so the loop ends there at the latest.  The
// ops commute, so the fold need not keep tile order.
template <typename T, int OP>
__device__ __forceinline__ T look_back(const unsigned long long* status,
                                       long long tile, int lane) {
  using F = Fn<T, OP>;
  T excl = F::neutral();
  for (long long end = tile - 1;; end -= 32) {
    const long long idx = end - lane;
    unsigned long long w = pack(kPrefix, to_bits(F::neutral()));
    if (idx >= 0) w = load_status(status + idx * kStatusStride);
    while (__any_sync(kFull, flag_of(w) == kNotReady))
      if (flag_of(w) == kNotReady) w = load_status(status + idx * kStatusStride);
    const unsigned prefixes = __ballot_sync(kFull, flag_of(w) == kPrefix);
    T v = from_bits<T>(static_cast<unsigned>(w));
    if (prefixes != 0 && lane > __ffs(prefixes) - 1) v = F::neutral();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = F::apply(v, __shfl_xor_sync(kFull, v, d));
    excl = F::apply(v, excl);
    if (prefixes != 0) return excl;
  }
}

// Data thread d holds elements l..l+3 of a tile at vector position k, with
// l = tile*kLbTile + 4*(k*kLbThreads + d): element e of the tile is v[k][j]
// of data thread (warp, lane), e = k*4*kLbThreads + warp*128 + lane*4 + j,
// so each vector position k of a data warp is one contiguous slot of 128
// elements, slot k*kLbWarps + warp.
__device__ __forceinline__ long long elem(long long tile, int k, int d) {
  return tile * kLbTile + 4LL * (k * kLbThreads + d);
}

// data thread d's elements of `tile`: whole vectors with one 16-byte load
// each, the rest element by element; past n reads the op's neutral element
template <typename T, int OP>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, long long n,
                                          long long tile, int d, bool rev,
                                          bool vec, T (&v)[kVecs][4]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long l = elem(tile, k, d);
    if (whole(n, l, vec))
      unpack4(__ldg(reinterpret_cast<const uint4*>(x + vec_pos(n, l, rev))),
              rev, v[k]);
    else
      load4_scalar(x, n, l, rev, Fn<T, OP>::neutral(), v[k]);
  }
}

__device__ __forceinline__ void sync_data_warps() {
  asm volatile("bar.sync 1, %0;" ::"n"(kLbThreads) : "memory");
}

// Warp 0 looks back while the kLbWarps data warps behind it load and scan
// the tile, so the look-back's round trips overlap the loads' latency; the
// data warps publish the tile's aggregate without waiting for it, so no
// block's aggregate depends on another block's look-back.
template <typename T, int OP>
__global__ void __launch_bounds__(kBlockThreads)
lookback_scan_kernel(const T* __restrict__ x, T* __restrict__ out,
                     unsigned long long* __restrict__ status,
                     unsigned long long* __restrict__ counter, long long n,
                     int reverse, int vec_in, int vec_out) {
  using F = Fn<T, OP>;
  __shared__ long long s_tile;
  __shared__ T s_slot[kSlots];  // slot totals, then their exclusive prefixes
  __shared__ T s_excl;          // the tile's exclusive prefix
  __shared__ T s_agg;           // the tile's aggregate

  const int lane = threadIdx.x & 31;
  const int d = static_cast<int>(threadIdx.x) - 32;  // data thread, or < 0
  const int warp = d >> 5;
  const bool rev = reverse != 0;
  if (threadIdx.x == 0)
    s_tile = static_cast<long long>(atomicAdd(counter, 1ull));
  __syncthreads();
  const long long tile = s_tile;

  T v[kVecs][4];
  T lane_excl[kVecs];
  if (d < 0) {
    const T excl = tile > 0 ? look_back<T, OP>(status, tile, lane)
                            : F::neutral();
    if (lane == 0) s_excl = excl;
  } else {
    load_tile<T, OP>(x, n, tile, d, rev, vec_in != 0, v);
    // scan each vector in registers, then each slot across its warp's lanes
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
#pragma unroll
      for (int j = 1; j < 4; ++j) v[k][j] = F::apply(v[k][j - 1], v[k][j]);
      const T inc = warp_inclusive<T, OP>(v[k][3], lane);
      const T up = __shfl_up_sync(kFull, inc, 1);
      lane_excl[k] = lane > 0 ? up : F::neutral();
      if (lane == 31) s_slot[k * kLbWarps + warp] = inc;
    }
    sync_data_warps();
    if (warp == 0) {
      // scan the slot totals, kSlotsPerLane consecutive slots a lane, and
      // publish the aggregate (tile 0's is its inclusive prefix)
      T loc[kSlotsPerLane];
#pragma unroll
      for (int i = 0; i < kSlotsPerLane; ++i) {
        const int sl = lane * kSlotsPerLane + i;
        loc[i] = sl < kSlots ? s_slot[sl] : F::neutral();
        if (i > 0) loc[i] = F::apply(loc[i - 1], loc[i]);
      }
      const T inc = warp_inclusive<T, OP>(loc[kSlotsPerLane - 1], lane);
      const T up = __shfl_up_sync(kFull, inc, 1);
      const T lane_pre = lane > 0 ? up : F::neutral();
      const T agg = __shfl_sync(kFull, inc, 31);
      T pre = lane_pre;
#pragma unroll
      for (int i = 0; i < kSlotsPerLane; ++i) {
        const int sl = lane * kSlotsPerLane + i;
        if (sl < kSlots) s_slot[sl] = pre;
        pre = F::apply(lane_pre, loc[i]);
      }
      if (lane == 0) {
        store_status(status + tile * kStatusStride,
                     pack(tile == 0 ? kPrefix : kAggregate, to_bits(agg)));
        s_agg = agg;
      }
    }
  }
  __syncthreads();

  const T tile_excl = s_excl;
  if (d < 0) {
    if (lane == 0 && tile > 0)
      store_status(status + tile * kStatusStride,
                   pack(kPrefix, to_bits(F::apply(tile_excl, s_agg))));
    return;
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const T pre = F::apply(F::apply(tile_excl, s_slot[k * kLbWarps + warp]),
                           lane_excl[k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[k][j] = F::apply(pre, v[k][j]);
    store4(out, n, elem(tile, k, d), rev, vec_out != 0, v[k]);
  }
}

// the status words, then the tile counter
long long scratch_words(long long n) {
  return (n + kLbTile - 1) / kLbTile * kStatusStride + 1;
}

template <typename T, int OP>
cudaError_t scan_1d_op(const void* x, void* out, void* scratch, long long n,
                       int reverse, cudaStream_t s) {
  const long long tiles = (n + kLbTile - 1) / kLbTile;
  if (n < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  const cudaError_t e = cudaMemsetAsync(
      status, 0, static_cast<size_t>(scratch_words(n)) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return e;
  // a vector of 4 starts at physical l, or n-4-l when reversed (l % 4 == 0)
  const uintptr_t shift = reverse ? static_cast<uintptr_t>(n) * 4u : 0u;
  const int vec_in = (reinterpret_cast<uintptr_t>(x) + shift) % 16 == 0;
  const int vec_out = (reinterpret_cast<uintptr_t>(out) + shift) % 16 == 0;
  lookback_scan_kernel<T, OP><<<static_cast<unsigned>(tiles), kBlockThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), status,
      status + tiles * kStatusStride, n, reverse, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scan_1d_t(int op, const void* x, void* out, void* scratch,
                      long long n, int reverse, cudaStream_t s) {
  switch (op) {
    case kSum: return scan_1d_op<T, kSum>(x, out, scratch, n, reverse, s);
    case kMin: return scan_1d_op<T, kMin>(x, out, scratch, n, reverse, s);
    case kMax: return scan_1d_op<T, kMax>(x, out, scratch, n, reverse, s);
  }
  return cudaErrorInvalidValue;
}

// -- segmented scan: tile scan, recursion, fix-up ----------------------------

template <typename T, int OP>
struct Pair {
  T v;
  int f;
  // this o b: b restarts the run where it carries a reset
  __device__ __forceinline__ Pair then(Pair b) const {
    return Pair{b.f ? b.v : Fn<T, OP>::apply(v, b.v), f | b.f};
  }
};

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ flags,
                 T* __restrict__ out, T* __restrict__ agg_v,
                 uint8_t* __restrict__ agg_f, int* __restrict__ first_reset,
                 long long n) {
  using F = Fn<T, OP>;
  using P = Pair<T, OP>;
  __shared__ T sv[kPadded];
  __shared__ uint8_t sf[kPadded];
  __shared__ T warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  __shared__ int s_first;

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_first = kTile;

  // coalesced load of the tile; the ragged tail reads as neutral, no reset
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    T v = F::neutral();
    uint8_t f = 0;
    if (i < n) {
      v = x[i];
      f = flags[i];
    }
    sv[pad(j)] = v;
    sf[pad(j)] = f;
  }
  __syncthreads();

  // each thread owns kItems consecutive elements
  T vals[kItems];
  int fl[kItems];
  P run{F::neutral(), 0};
  int my_first = kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid * kItems + k;
    vals[k] = sv[pad(j)];
    fl[k] = sf[pad(j)] != 0;
    if (fl[k] && my_first == kTile) my_first = j;
    run = run.then(P{vals[k], fl[k]});
  }
  if (my_first < kTile) atomicMin(&s_first, my_first);

  // inclusive warp scan of the thread totals
  P inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(kFull, inc.v, d);
    const int of = __shfl_up_sync(kFull, inc.f, d);
    if (lane >= d) inc = P{ov, of}.then(inc);
  }
  if (lane == 31) {
    warp_v[warp] = inc.v;
    warp_f[warp] = inc.f;
  }
  const T pv = __shfl_up_sync(kFull, inc.v, 1);
  const int pf = __shfl_up_sync(kFull, inc.f, 1);
  __syncthreads();

  // exclusive prefix of this thread: earlier warps, then earlier lanes
  P pre{F::neutral(), 0};
  for (int w = 0; w < warp; ++w) pre = pre.then(P{warp_v[w], warp_f[w]});
  if (lane > 0) pre = pre.then(P{pv, pf});

  T r = pre.v;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    r = fl[k] ? vals[k] : F::apply(r, vals[k]);
    vals[k] = r;
  }
  if (tid == kThreads - 1) {
    const P tot = pre.then(run);
    agg_v[blockIdx.x] = tot.v;
    agg_f[blockIdx.x] = static_cast<uint8_t>(tot.f);
  }
  if (tid == 0) first_reset[blockIdx.x] = s_first;

#pragma unroll
  for (int k = 0; k < kItems; ++k) sv[pad(tid * kItems + k)] = vals[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    if (i < n) out[i] = sv[pad(j)];
  }
}

// tile t = blockIdx.x + 1 folds carry[t-1] into its elements before its
// first reset
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
fixup_kernel(T* __restrict__ out, const T* __restrict__ carry,
             const int* __restrict__ first_reset, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) + 1;
  const long long base = t * kTile;
  const T c = carry[t - 1];
  const int limit = first_reset[t];
  for (int j = threadIdx.x; j < limit; j += kThreads) {
    const long long i = base + j;
    if (i >= n) break;
    out[i] = Fn<T, OP>::apply(c, out[i]);
  }
}

template <typename T>
cudaError_t tile_scan_t(int op, const void* x, const void* flags, void* out,
                        void* agg_v, void* agg_f, void* first, long long n,
                        cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + kTile - 1) / kTile);
  const T* xi = static_cast<const T*>(x);
  const uint8_t* fi = static_cast<const uint8_t*>(flags);
  T* o = static_cast<T*>(out);
  T* av = static_cast<T*>(agg_v);
  uint8_t* af = static_cast<uint8_t*>(agg_f);
  int* fr = static_cast<int*>(first);
  switch (op) {
    case kSum: tile_scan_kernel<T, kSum><<<grid, kThreads, 0, s>>>(xi, fi, o, av, af, fr, n); break;
    case kMin: tile_scan_kernel<T, kMin><<<grid, kThreads, 0, s>>>(xi, fi, o, av, af, fr, n); break;
    case kMax: tile_scan_kernel<T, kMax><<<grid, kThreads, 0, s>>>(xi, fi, o, av, af, fr, n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fixup_t(int op, void* out, const void* carry, const void* first,
                    long long n, cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles < 2) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(tiles - 1);
  T* o = static_cast<T*>(out);
  const T* c = static_cast<const T*>(carry);
  const int* f = static_cast<const int*>(first);
  switch (op) {
    case kSum: fixup_kernel<T, kSum><<<grid, kThreads, 0, s>>>(o, c, f, n); break;
    case kMin: fixup_kernel<T, kMin><<<grid, kThreads, 0, s>>>(o, c, f, n); break;
    case kMax: fixup_kernel<T, kMax><<<grid, kThreads, 0, s>>>(o, c, f, n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cts_scan_1d_tile() { return kLbTile; }

// 64-bit words of scratch that cts_scan_1d needs for n elements.
long long cts_scan_1d_scratch_words(long long n) { return scratch_words(n); }

// Plain inclusive scan of n >= 1 elements of x into out, right to left if
// `reverse`.  scratch holds cts_scan_1d_scratch_words(n) 64-bit words (the
// status words, then the tile counter); this zeroes them on `stream`, then
// launches once.  Returns cudaGetLastError().
int cts_scan_1d(int dtype, int op, const void* x, void* out, void* scratch,
                long long n, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32: return scan_1d_t<int>(op, x, out, scratch, n, reverse, s);
    case kF32: return scan_1d_t<float>(op, x, out, scratch, n, reverse, s);
    case kU32: return scan_1d_t<unsigned>(op, x, out, scratch, n, reverse, s);
  }
  return cudaErrorInvalidValue;
}

int cts_tile_size() { return kTile; }

// One segmented tile_scan launch over n elements: out, and per tile agg_v,
// agg_f and first_reset.  Returns cudaGetLastError().
int cts_tile_scan(int dtype, int op, const void* x, const void* flags,
                  void* out, void* agg_v, void* agg_f, void* first_reset,
                  long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32: return tile_scan_t<int>(op, x, flags, out, agg_v, agg_f, first_reset, n, s);
    case kF32: return tile_scan_t<float>(op, x, flags, out, agg_v, agg_f, first_reset, n, s);
    case kU32: return tile_scan_t<unsigned>(op, x, flags, out, agg_v, agg_f, first_reset, n, s);
  }
  return cudaErrorInvalidValue;
}

// One fixup launch: carry[t-1] into tile t's elements before first_reset[t].
int cts_fixup(int dtype, int op, void* out, const void* carry,
              const void* first_reset, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32: return fixup_t<int>(op, out, carry, first_reset, n, s);
    case kF32: return fixup_t<float>(op, out, carry, first_reset, n, s);
    case kU32: return fixup_t<unsigned>(op, out, carry, first_reset, n, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
