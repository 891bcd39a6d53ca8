// Inclusive scans of 1-D 32-bit arrays on Hopper (sm_90a): plain
// (cumsum / cummax / cummin, optionally right to left) and segmented
// (restart at reset flags).  Replaces the JAX package's Pallas TPU scans:
//   cylon_tpu/ops/pallas_scan.py:222  _scan_padded           (plain)
//   cylon_tpu/ops/pallas_scan.py:150  _segmented_scan_padded sweep 1
//   cylon_tpu/ops/pallas_scan.py:177  _segmented_scan_padded sweep 2
//
// Combine, as in the reference: (va,fa) o (vb,fb) = (fb ? vb : fn(va,vb),
// fa|fb), fn in {sum, min, max}; the plain scan is the case of no flags.
//
// Design: scan-then-propagate in three launches, since blocks on a GPU run
// in parallel and in no order (the TPU kernel's sequential grid carry has
// no counterpart here).
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
//      elements before its first reset.  For the plain scan that is every
//      element of the tile; for the segmented scan only the prefix.
// Bound: memory.  The plain scan must read 4 B and write 4 B per element,
// the segmented scan 4 B + 1 B flag and 4 B; this design moves 16 B and
// about 9 B.  Padding is the op's neutral element, so ragged tails need no
// special case.  `reverse` maps logical index i to physical n-1-i on every
// load and store instead of flipping copies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kPadded = kTile + kTile / 32;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum DType { kI32 = 0, kF32 = 1, kU32 = 2 };

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

template <typename T, int OP>
struct Pair {
  T v;
  int f;
  // this o b: b restarts the run where it carries a reset
  __device__ __forceinline__ Pair then(Pair b) const {
    return Pair{b.f ? b.v : Fn<T, OP>::apply(v, b.v), f | b.f};
  }
};

template <typename T, int OP, bool SEG>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const T* __restrict__ x, const uint8_t* __restrict__ flags,
                 T* __restrict__ out, T* __restrict__ agg_v,
                 uint8_t* __restrict__ agg_f, int* __restrict__ first_reset,
                 long long n, int reverse) {
  using F = Fn<T, OP>;
  using P = Pair<T, OP>;
  __shared__ T sv[kPadded];
  __shared__ uint8_t sf[SEG ? kPadded : 1];
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
      const long long p = reverse ? n - 1 - i : i;
      v = x[p];
      if (SEG) f = flags[p];
    }
    sv[pad(j)] = v;
    if (SEG) sf[pad(j)] = f;
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
    fl[k] = SEG ? (sf[pad(j)] != 0) : 0;
    if (fl[k] && my_first == kTile) my_first = j;
    run = run.then(P{vals[k], fl[k]});
  }
  if (SEG && my_first < kTile) atomicMin(&s_first, my_first);

  // inclusive warp scan of the thread totals
  P inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(0xffffffffu, inc.v, d);
    const int of = __shfl_up_sync(0xffffffffu, inc.f, d);
    if (lane >= d) inc = P{ov, of}.then(inc);
  }
  if (lane == 31) {
    warp_v[warp] = inc.v;
    warp_f[warp] = inc.f;
  }
  const T pv = __shfl_up_sync(0xffffffffu, inc.v, 1);
  const int pf = __shfl_up_sync(0xffffffffu, inc.f, 1);
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
    if (SEG) agg_f[blockIdx.x] = static_cast<uint8_t>(tot.f);
  }
  if (tid == 0) first_reset[blockIdx.x] = s_first;

#pragma unroll
  for (int k = 0; k < kItems; ++k) sv[pad(tid * kItems + k)] = vals[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long i = base + j;
    if (i < n) out[reverse ? n - 1 - i : i] = sv[pad(j)];
  }
}

// tile t = blockIdx.x + 1 folds carry[t-1] into its elements before its
// first reset
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
fixup_kernel(T* __restrict__ out, const T* __restrict__ carry,
             const int* __restrict__ first_reset, long long n, int reverse) {
  const long long t = static_cast<long long>(blockIdx.x) + 1;
  const long long base = t * kTile;
  const T c = carry[t - 1];
  const int limit = first_reset[t];
  for (int j = threadIdx.x; j < limit; j += kThreads) {
    const long long i = base + j;
    if (i >= n) break;
    const long long p = reverse ? n - 1 - i : i;
    out[p] = Fn<T, OP>::apply(c, out[p]);
  }
}

template <typename T, int OP>
cudaError_t tile_scan_op(int seg, const void* x, const void* flags, void* out,
                         void* agg_v, void* agg_f, void* first_reset,
                         long long n, int reverse, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + kTile - 1) / kTile);
  if (seg)
    tile_scan_kernel<T, OP, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(flags),
        static_cast<T*>(out), static_cast<T*>(agg_v),
        static_cast<uint8_t*>(agg_f), static_cast<int*>(first_reset), n,
        reverse);
  else
    tile_scan_kernel<T, OP, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(out),
        static_cast<T*>(agg_v), nullptr, static_cast<int*>(first_reset), n,
        reverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tile_scan_t(int op, int seg, const void* x, const void* flags,
                        void* out, void* agg_v, void* agg_f, void* first,
                        long long n, int reverse, cudaStream_t s) {
  switch (op) {
    case kSum: return tile_scan_op<T, kSum>(seg, x, flags, out, agg_v, agg_f, first, n, reverse, s);
    case kMin: return tile_scan_op<T, kMin>(seg, x, flags, out, agg_v, agg_f, first, n, reverse, s);
    case kMax: return tile_scan_op<T, kMax>(seg, x, flags, out, agg_v, agg_f, first, n, reverse, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t fixup_t(int op, void* out, const void* carry, const void* first,
                    long long n, int reverse, cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles < 2) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>(tiles - 1);
  T* o = static_cast<T*>(out);
  const T* c = static_cast<const T*>(carry);
  const int* f = static_cast<const int*>(first);
  switch (op) {
    case kSum: fixup_kernel<T, kSum><<<grid, kThreads, 0, s>>>(o, c, f, n, reverse); break;
    case kMin: fixup_kernel<T, kMin><<<grid, kThreads, 0, s>>>(o, c, f, n, reverse); break;
    case kMax: fixup_kernel<T, kMax><<<grid, kThreads, 0, s>>>(o, c, f, n, reverse); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cts_tile_size() { return kTile; }

// One tile_scan launch over n elements: out, and per tile agg_v / agg_f
// (segmented only) / first_reset.  Returns cudaGetLastError().
int cts_tile_scan(int dtype, int op, int seg, const void* x, const void* flags,
                  void* out, void* agg_v, void* agg_f, void* first_reset,
                  long long n, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32: return tile_scan_t<int>(op, seg, x, flags, out, agg_v, agg_f, first_reset, n, reverse, s);
    case kF32: return tile_scan_t<float>(op, seg, x, flags, out, agg_v, agg_f, first_reset, n, reverse, s);
    case kU32: return tile_scan_t<unsigned>(op, seg, x, flags, out, agg_v, agg_f, first_reset, n, reverse, s);
  }
  return cudaErrorInvalidValue;
}

// One fixup launch: carry[t-1] into tile t's elements before first_reset[t].
int cts_fixup(int dtype, int op, void* out, const void* carry,
              const void* first_reset, long long n, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI32: return fixup_t<int>(op, out, carry, first_reset, n, reverse, s);
    case kF32: return fixup_t<float>(op, out, carry, first_reset, n, reverse, s);
    case kU32: return fixup_t<unsigned>(op, out, carry, first_reset, n, reverse, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
