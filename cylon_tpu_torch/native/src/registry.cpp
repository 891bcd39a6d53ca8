// String-id table registry + raw-buffer column builder.
//
// Native analog of two reference components:
//  - table_api: the mutex-guarded global map<string, Table> that backs the
//    foreign-language (JNI) binding surface (cpp/src/cylon/table_api.cpp:
//    33-62, table_api.hpp:38-195);
//  - arrow_builder: building columns from raw (address, size) buffers
//    registered by id — the zero-copy ingest path used by the Java binding
//    (cpp/src/cylon/arrow/arrow_builder.hpp:23-35).
//
// A foreign host (or Python) registers column buffers by table id; the
// registry owns host copies; readers get zero-copy pointers back out.  The
// relational ops themselves run on the card in torch — this is the
// host-side hand-off surface.
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

// the published foreign-binding contract; including it here makes the
// compiler enforce header<->implementation prototype agreement
#include "../include/cylon_tpu_c.h"

namespace {

struct CtColumn {
  std::string name;
  int32_t dtype = 0;
  int32_t width = 0;  // bytes per row (strings: matrix row width)
  int64_t rows = 0;
  std::vector<uint8_t> data;
  std::vector<uint8_t> validity;  // 1 byte per row; empty = all valid
  std::vector<int32_t> lengths;   // strings only
};

struct CtTable {
  std::vector<CtColumn> cols;
  int64_t rows = 0;
};

std::mutex g_mutex;
std::map<std::string, std::shared_ptr<CtTable>> g_tables;
std::map<std::string, std::shared_ptr<CtTable>> g_building;

std::shared_ptr<CtTable> find_table(const char* id) {
  std::lock_guard<std::mutex> g(g_mutex);
  auto it = g_tables.find(id);
  return it == g_tables.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int32_t ct_builder_begin(const char* id) {
  std::lock_guard<std::mutex> g(g_mutex);
  if (g_building.count(id)) return -1;
  g_building[id] = std::make_shared<CtTable>();
  return 0;
}

int32_t ct_builder_add_column(const char* id, const char* name, int32_t dtype,
                              int32_t width, int64_t rows, const void* data,
                              const uint8_t* validity,
                              const int32_t* lengths) {
  std::shared_ptr<CtTable> t;
  {
    std::lock_guard<std::mutex> g(g_mutex);
    auto it = g_building.find(id);
    if (it == g_building.end()) return -1;
    t = it->second;
  }
  if (!t->cols.empty() && t->rows != rows) return -2;
  CtColumn col;
  col.name = name;
  col.dtype = dtype;
  col.width = width;
  col.rows = rows;
  int64_t nbytes = rows * static_cast<int64_t>(width);
  col.data.resize(nbytes);
  if (nbytes) std::memcpy(col.data.data(), data, nbytes);
  if (validity) {
    col.validity.resize(rows);
    std::memcpy(col.validity.data(), validity, rows);
  }
  if (lengths) {
    col.lengths.resize(rows);
    std::memcpy(col.lengths.data(), lengths, rows * sizeof(int32_t));
  }
  t->rows = rows;
  t->cols.push_back(std::move(col));
  return 0;
}

int32_t ct_builder_finish(const char* id) {
  std::lock_guard<std::mutex> g(g_mutex);
  auto it = g_building.find(id);
  if (it == g_building.end()) return -1;
  g_tables[id] = it->second;
  g_building.erase(it);
  return 0;
}

int32_t ct_registry_contains(const char* id) {
  std::lock_guard<std::mutex> g(g_mutex);
  return g_tables.count(id) ? 1 : 0;
}

int32_t ct_registry_remove(const char* id) {
  std::lock_guard<std::mutex> g(g_mutex);
  return g_tables.erase(id) ? 0 : -1;
}

int64_t ct_registry_size() {
  std::lock_guard<std::mutex> g(g_mutex);
  return static_cast<int64_t>(g_tables.size());
}

void ct_registry_clear() {
  std::lock_guard<std::mutex> g(g_mutex);
  g_tables.clear();
  g_building.clear();
}

// ids joined by '\n' into caller buffer; returns needed length.
int64_t ct_registry_ids(char* out, int64_t cap) {
  std::lock_guard<std::mutex> g(g_mutex);
  std::string joined;
  for (const auto& kv : g_tables) {
    if (!joined.empty()) joined += '\n';
    joined += kv.first;
  }
  if (out && cap > 0) {
    int64_t n = static_cast<int64_t>(joined.size()) < cap - 1
                    ? static_cast<int64_t>(joined.size())
                    : cap - 1;
    std::memcpy(out, joined.data(), n);
    out[n] = '\0';
  }
  return static_cast<int64_t>(joined.size());
}

int64_t ct_table_rows(const char* id) {
  auto t = find_table(id);
  return t ? t->rows : -1;
}

int32_t ct_table_ncols(const char* id) {
  auto t = find_table(id);
  return t ? static_cast<int32_t>(t->cols.size()) : -1;
}

int32_t ct_table_col_name(const char* id, int32_t i, char* out, int32_t cap) {
  auto t = find_table(id);
  if (!t || i < 0 || i >= static_cast<int32_t>(t->cols.size())) return -1;
  const std::string& name = t->cols[i].name;
  int32_t n = static_cast<int32_t>(name.size()) < cap - 1
                  ? static_cast<int32_t>(name.size())
                  : cap - 1;
  std::memcpy(out, name.data(), n);
  out[n] = '\0';
  return static_cast<int32_t>(name.size());
}

int32_t ct_table_col_info(const char* id, int32_t i, int32_t* dtype,
                          int32_t* width, int64_t* rows, int32_t* has_validity,
                          int32_t* has_lengths) {
  auto t = find_table(id);
  if (!t || i < 0 || i >= static_cast<int32_t>(t->cols.size())) return -1;
  const CtColumn& c = t->cols[i];
  *dtype = c.dtype;
  *width = c.width;
  *rows = c.rows;
  *has_validity = c.validity.empty() ? 0 : 1;
  *has_lengths = c.lengths.empty() ? 0 : 1;
  return 0;
}

const void* ct_table_col_data(const char* id, int32_t i) {
  auto t = find_table(id);
  if (!t || i < 0 || i >= static_cast<int32_t>(t->cols.size())) return nullptr;
  return t->cols[i].data.data();
}

const uint8_t* ct_table_col_validity(const char* id, int32_t i) {
  auto t = find_table(id);
  if (!t || i < 0 || i >= static_cast<int32_t>(t->cols.size())) return nullptr;
  return t->cols[i].validity.empty() ? nullptr : t->cols[i].validity.data();
}

const int32_t* ct_table_col_lengths(const char* id, int32_t i) {
  auto t = find_table(id);
  if (!t || i < 0 || i >= static_cast<int32_t>(t->cols.size())) return nullptr;
  return t->cols[i].lengths.empty() ? nullptr : t->cols[i].lengths.data();
}

}  // extern "C"
