// Tracking host memory pool — native analog of the reference's
// MemoryPool/ProxyMemoryPool abstraction (cpp/src/cylon/ctx/memory_pool.hpp:
// 25-66, ctx/arrow_memory_pool_utils.hpp): an allocator handle with
// bytes-allocated / max-memory accounting that the CSV reader and registry
// allocate through.  Device memory is owned by torch's allocator; this pool covers
// host staging buffers.
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <map>
#include <mutex>
#include <new>

extern "C" {

struct CtPool {
  std::atomic<int64_t> bytes{0};
  std::atomic<int64_t> peak{0};
  std::atomic<int64_t> allocations{0};
};

CtPool* ct_pool_create() { return new CtPool(); }

void ct_pool_destroy(CtPool* pool) { delete pool; }

void* ct_pool_alloc(CtPool* pool, int64_t size) {
  // size prefix so frees can be accounted without a side table
  void* raw = std::malloc(static_cast<size_t>(size) + 16);
  if (!raw) return nullptr;
  *static_cast<int64_t*>(raw) = size;
  if (pool) {
    int64_t now = pool->bytes.fetch_add(size) + size;
    pool->allocations.fetch_add(1);
    int64_t prev = pool->peak.load();
    while (now > prev && !pool->peak.compare_exchange_weak(prev, now)) {
    }
  }
  return static_cast<char*>(raw) + 16;
}

void ct_pool_free(CtPool* pool, void* ptr) {
  if (!ptr) return;
  void* raw = static_cast<char*>(ptr) - 16;
  int64_t size = *static_cast<int64_t*>(raw);
  if (pool) pool->bytes.fetch_sub(size);
  std::free(raw);
}

int64_t ct_pool_bytes_allocated(CtPool* pool) { return pool->bytes.load(); }
int64_t ct_pool_max_memory(CtPool* pool) { return pool->peak.load(); }
int64_t ct_pool_num_allocations(CtPool* pool) {
  return pool->allocations.load();
}

}  // extern "C"
