// Host-side multi-column row hashing + partition-target kernels, threaded
// over row ranges.  Native analog of the reference's partition kernels
// (cpp/src/cylon/arrow/arrow_partition_kernels.hpp:93-362): the composite
// row hash is murmur3 of each value combined across columns as 31*h + x,
// and targets are hash % world (mask when world is a power of two).
//
// The device path does this on the card (cylon_tpu_torch/ops/hashing.py,
// cuda/murmur3.cu); this native path serves host-resident data (CSV
// ingest, registry tables) without a device round-trip.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "murmur3.hpp"
#include "parallel.hpp"

namespace cylon_tpu {
namespace {

constexpr uint32_t kSeed = 0;
constexpr int64_t kRowsPerThread = 1 << 16;  // >=64K rows per thread

}  // namespace
}  // namespace cylon_tpu

extern "C" {

// dtype codes shared with cylon_tpu_torch/native/__init__.py
enum CtDType : int32_t {
  CT_INT64 = 0,
  CT_FLOAT64 = 1,
  CT_BOOL = 2,
  CT_STRING = 3,  // fixed-width byte matrix [rows, width] + int32 lengths
  CT_INT32 = 4,
  CT_FLOAT32 = 5,
};

// One column's buffers for hashing: fixed-width data, or byte matrix +
// lengths for strings (width = bytes per row).
struct CtHashCol {
  const void* data;
  const int32_t* lengths;  // strings only, else null
  int32_t dtype;
  int32_t width;  // bytes per row
};

// hashes[i] = combine over columns of murmur3(value_i) as 31*h + x
// (reference: HashPartitionKernel::UpdateHash,
// arrow_partition_kernels.hpp:199-233).
void ct_row_hash(const CtHashCol* cols, int32_t ncols, int64_t rows,
                 uint32_t* hashes) {
  cylon_tpu::parallel_rows(rows, cylon_tpu::kRowsPerThread, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) hashes[i] = 1;
    for (int32_t c = 0; c < ncols; c++) {
      const CtHashCol& col = cols[c];
      const uint8_t* base = static_cast<const uint8_t*>(col.data);
      for (int64_t i = lo; i < hi; i++) {
        int len = col.width;
        const uint8_t* p = base + i * static_cast<int64_t>(col.width);
        if (col.dtype == CT_STRING && col.lengths) len = col.lengths[i];
        uint32_t h = cylon_tpu::murmur3_x86_32(p, len, cylon_tpu::kSeed);
        hashes[i] = 31U * hashes[i] + h;
      }
    }
  });
}

// targets[i] = hashes[i] % world (mask when world is 2^k — reference:
// arrow_partition_kernels.hpp:60-70); also fills the per-target histogram.
void ct_partition_targets(const uint32_t* hashes, int64_t rows, int32_t world,
                          uint32_t* targets, int64_t* histogram) {
  std::memset(histogram, 0, sizeof(int64_t) * world);
  bool pow2 = (world & (world - 1)) == 0;
  uint32_t mask = static_cast<uint32_t>(world - 1);
  std::vector<std::vector<int64_t>> partials;
  std::mutex m;
  cylon_tpu::parallel_rows(rows, cylon_tpu::kRowsPerThread, [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> hist(world, 0);
    if (pow2) {
      for (int64_t i = lo; i < hi; i++) {
        uint32_t t = hashes[i] & mask;
        targets[i] = t;
        hist[t]++;
      }
    } else {
      for (int64_t i = lo; i < hi; i++) {
        uint32_t t = hashes[i] % static_cast<uint32_t>(world);
        targets[i] = t;
        hist[t]++;
      }
    }
    std::lock_guard<std::mutex> g(m);
    partials.push_back(std::move(hist));
  });
  for (const auto& hist : partials)
    for (int32_t w = 0; w < world; w++) histogram[w] += hist[w];
}

uint32_t ct_murmur3_x86_32(const void* data, int32_t len, uint32_t seed) {
  return cylon_tpu::murmur3_x86_32(data, len, seed);
}

}  // extern "C"
