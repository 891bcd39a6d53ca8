// Shared thread fan-out over row ranges (used by csv.cpp and hashing.cpp).
#ifndef CYLON_TPU_PARALLEL_HPP
#define CYLON_TPU_PARALLEL_HPP

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace cylon_tpu {

inline int pick_threads(int64_t rows, int64_t rows_per_thread) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t by_work = rows / rows_per_thread;
  if (by_work < 1) by_work = 1;
  return static_cast<int>(by_work < hw ? by_work : hw);
}

template <typename F>
void parallel_rows(int64_t rows, int64_t rows_per_thread, F&& body) {
  int nthreads = pick_threads(rows, rows_per_thread);
  if (nthreads <= 1) {
    body(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  int64_t chunk = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, rows);
    if (lo >= hi) break;
    ts.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace cylon_tpu

#endif  // CYLON_TPU_PARALLEL_HPP
