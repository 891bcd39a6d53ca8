// Row hash and hash-partition target of fixed-width key columns on Hopper
// (sm_90a).  Replaces the JAX package's Pallas TPU kernel
//   cylon_tpu/ops/pallas_kernels.py:84   _hash_kernel (launched at :113)
// bit for bit: murmur3_x86_32 with seed 0 over each key column's
// little-endian 32-bit words (an 8-byte value is its lo word then its hi
// word; 1- and 2-byte values are zero-extended; bool is 0/1; a null row's
// words are 0), columns combined as h = 31*h + column_hash from h = 1, and
// the target h & (world-1) for a power-of-two world, else h % world.
// Float keys are folded in registers first, as the plain version folds
// them (ops/keys.py canonical_float): -0.0 hashes as +0.0 and every NaN
// as the one NaN torch makes of float("nan"), so keys that compare equal
// land on one shard.  No extra pass, no copy of the key.
//
// Bound: memory.  The work is a few dozen integer operations per word,
// far below what the card can do per byte, so the least time is the bytes:
// each key byte and validity byte read once, the uint32 hash and int32
// target written once (13 B per row for one int32 key with validity:
// 0.26 ms at 2^26 rows on an H100 at 3.35 TB/s).
//
// Design: one thread per row in a grid-stride loop; the TPU kernel's
// (rows/128, 128) view, 256-row blocks and host-side pad to whole blocks
// are TPU tiling and are gone.  Each column's data and validity pointer,
// element width and bool flag come in by value, and a thread reads its
// row's bytes where they lie, so neighbouring threads read neighbouring
// addresses, every input byte is read once, every output written once, and
// no intermediate touches device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define CMH_MAX_COLS 8

extern "C" {
// Key columns as the kernel receives them (by value).  Mirrored by
// ctypes in ops/hash_kernels.py; keep the two in step.
struct CmhColumns {
  const void* data[CMH_MAX_COLS];
  const uint8_t* valid[CMH_MAX_COLS];
  int width[CMH_MAX_COLS];    // element bytes: 1, 2, 4 or 8
  int is_bool[CMH_MAX_COLS];  // 1 for bool data (any nonzero byte is 1)
  int is_float[CMH_MAX_COLS];  // 0 none, 1 IEEE binary16/32/64, 2 bfloat16
  int ncols;
};
}

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_block(uint32_t h, uint32_t w) {
  uint32_t k = w * kC1;
  k = rotl(k, 15);
  k *= kC2;
  h ^= k;
  h = rotl(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h, uint32_t len_bytes) {
  h ^= len_bytes;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// One bit pattern per float value: +-0 -> +0, any NaN -> torch's NaN.
__device__ __forceinline__ uint32_t canon16(uint32_t w, int kind) {
  const uint32_t exp = kind == 2 ? 0x7F80u : 0x7C00u;  // bfloat16 : half
  const uint32_t man = kind == 2 ? 0x007Fu : 0x03FFu;
  if ((w & 0x7FFFu) == 0u) return 0u;
  if ((w & exp) == exp && (w & man) != 0u) return kind == 2 ? 0x7FC0u : 0x7E00u;
  return w;
}

__device__ __forceinline__ uint32_t canon32(uint32_t w) {
  if ((w & 0x7FFFFFFFu) == 0u) return 0u;
  if ((w & 0x7F800000u) == 0x7F800000u && (w & 0x007FFFFFu) != 0u)
    return 0x7FC00000u;
  return w;
}

__device__ __forceinline__ uint64_t canon64(uint64_t w) {
  if ((w & 0x7FFFFFFFFFFFFFFFull) == 0ull) return 0ull;
  if ((w & 0x7FF0000000000000ull) == 0x7FF0000000000000ull &&
      (w & 0x000FFFFFFFFFFFFFull) != 0ull)
    return 0x7FF8000000000000ull;
  return w;
}

// murmur3_x86_32, seed 0, of one column's value at row i
__device__ __forceinline__ uint32_t column_hash(const CmhColumns& c, int j,
                                                long long i) {
  const bool valid = c.valid[j][i] != 0;
  switch (c.width[j]) {
    case 1: {
      uint32_t w = valid ? static_cast<const uint8_t*>(c.data[j])[i] : 0u;
      if (c.is_bool[j]) w = w != 0u;
      return fmix(mix_block(0u, w), 4u);
    }
    case 2: {
      uint32_t w = valid ? static_cast<const uint16_t*>(c.data[j])[i] : 0u;
      if (c.is_float[j]) w = canon16(w, c.is_float[j]);
      return fmix(mix_block(0u, w), 4u);
    }
    case 4: {
      uint32_t w = valid ? static_cast<const uint32_t*>(c.data[j])[i] : 0u;
      if (c.is_float[j]) w = canon32(w);
      return fmix(mix_block(0u, w), 4u);
    }
    default: {  // 8 bytes: lo word, then hi word
      uint64_t v = valid ? static_cast<const uint64_t*>(c.data[j])[i] : 0ull;
      if (c.is_float[j]) v = canon64(v);
      uint32_t h = mix_block(0u, static_cast<uint32_t>(v));
      h = mix_block(h, static_cast<uint32_t>(v >> 32));
      return fmix(h, 8u);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hash_partition_kernel(CmhColumns cols, long long n, uint32_t world,
                      uint32_t* __restrict__ hash_out,
                      int32_t* __restrict__ target_out) {
  const bool pow2 = (world & (world - 1u)) == 0u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    uint32_t h = 1u;
    for (int j = 0; j < cols.ncols; ++j) h = h * 31u + column_hash(cols, j, i);
    hash_out[i] = h;
    target_out[i] = static_cast<int32_t>(pow2 ? (h & (world - 1u)) : (h % world));
  }
}

}  // namespace

extern "C" {

int cmh_max_cols() { return CMH_MAX_COLS; }

// One launch over n rows: hash_out (uint32[n]) and target_out (int32[n]).
// Returns cudaGetLastError().
int cmh_hash_partition(const CmhColumns* cols, long long n, int world,
                       void* hash_out, void* target_out, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (world < 1 || cols->ncols < 1 || cols->ncols > CMH_MAX_COLS)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * 16;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  hash_partition_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *cols, n, static_cast<uint32_t>(world), static_cast<uint32_t*>(hash_out),
      static_cast<int32_t*>(target_out));
  return cudaGetLastError();
}

}  // extern "C"
