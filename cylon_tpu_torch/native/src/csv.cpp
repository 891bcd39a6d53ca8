// Native CSV reader/writer — the framework's data loader.
//
// Fills the role of the reference's IO layer (cpp/src/cylon/io/arrow_io.cpp:
// 33-61 read_csv over Arrow's memory-mapped multi-threaded CSV reader, with
// CSVReadOptions io/csv_read_config.hpp:27-130), built device-first: the
// output is flat fixed-width column buffers (data + validity byte-vector +
// string byte-matrix/lengths) shaped exactly like cylon_tpu_torch.Column device
// buffers, so ingest is one memcpy and one upload per column with no
// offsets→padding conversion on the Python side.
//
// Three phases:
//   1. single scan for row boundaries (quote-aware) → row offsets
//   2. threaded field slicing  → (offset, len) per cell + per-column max len
//   3. type inference then threaded materialization into typed buffers
#include <algorithm>
#include <atomic>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <strings.h>
#include <string>
#include <thread>
#include <vector>

#include "parallel.hpp"

namespace {

constexpr int64_t kRowsPerThread = 1 << 14;

enum CtDType : int32_t {
  CT_INT64 = 0,
  CT_FLOAT64 = 1,
  CT_BOOL = 2,
  CT_STRING = 3,
};

struct Options {
  char delimiter = ',';
  bool has_header = true;
  int32_t skip_rows = 0;
  int32_t string_width = 0;  // 0 = auto
  std::vector<std::string> null_values = {"",    "NULL", "null", "NaN",
                                          "nan", "N/A",  "n/a",  "NA"};
  bool use_quoting = true;
  char quote_char = '"';
  bool strings_can_be_null = false;  // pyarrow ConvertOptions semantics
};

bool is_null_token(const Options& o, const char* p, int32_t n) {
  for (const std::string& s : o.null_values)
    if (static_cast<int32_t>(s.size()) == n &&
        std::memcmp(s.data(), p, n) == 0)
      return true;
  return false;
}

struct Cell {
  uint32_t off;
  int32_t len;  // unescaped length may differ; quoted cells re-scanned
  bool quoted;
};

struct OutCol {
  std::string name;
  int32_t dtype = CT_STRING;
  int32_t width = 0;
  std::vector<uint8_t> data;
  std::vector<uint8_t> validity;
  std::vector<int32_t> lengths;
};

struct CsvResult {
  int64_t rows = 0;
  std::vector<OutCol> cols;
};

using cylon_tpu::parallel_rows;

// Split one line [lo, hi) into cells.  Returns number of fields.
int split_line(const char* buf, uint32_t lo, uint32_t hi, const Options& o,
               std::vector<Cell>& out) {
  int n = 0;
  uint32_t i = lo;
  while (true) {
    Cell c{i, 0, false};
    if (o.use_quoting && i < hi && buf[i] == o.quote_char) {
      c.quoted = true;
      c.off = ++i;
      while (i < hi) {
        if (buf[i] == o.quote_char) {
          if (i + 1 < hi && buf[i + 1] == o.quote_char) {
            i += 2;  // escaped quote
            continue;
          }
          break;
        }
        i++;
      }
      c.len = static_cast<int32_t>(i - c.off);
      if (i < hi) i++;  // closing quote
    } else {
      while (i < hi && buf[i] != o.delimiter) i++;
      c.len = static_cast<int32_t>(i - c.off);
    }
    out.push_back(c);
    n++;
    if (i >= hi) break;
    if (buf[i] == o.delimiter) i++;
    if (i >= hi && buf[hi - 1] == o.delimiter) {  // trailing empty field
      out.push_back(Cell{hi, 0, false});
      n++;
      break;
    }
  }
  return n;
}

// A cell's bytes: a direct view into the file buffer for unquoted cells;
// quoted cells are unescaped (doubled quotes collapsed) into `scratch`.
// No length cap — scratch grows to the cell size.
struct CellView {
  const char* p;
  int32_t n;
};

CellView cell_view(const char* buf, const Cell& c, char q,
                   std::vector<char>& scratch) {
  if (!c.quoted) return {buf + c.off, c.len};
  if (static_cast<int32_t>(scratch.size()) < c.len) scratch.resize(c.len);
  int32_t n = 0;
  for (int32_t i = 0; i < c.len; i++) {
    char ch = buf[c.off + i];
    scratch[n++] = ch;
    if (ch == q && i + 1 < c.len && buf[c.off + i + 1] == q) i++;
  }
  return {scratch.data(), n};
}

bool parse_i64(const char* p, int32_t len, int64_t* out) {
  while (len > 0 && (*p == ' ' || *p == '\t')) p++, len--;
  while (len > 0 && (p[len - 1] == ' ' || p[len - 1] == '\t')) len--;
  if (len == 0) return false;
  auto [end, ec] = std::from_chars(p, p + len, *out);
  return ec == std::errc() && end == p + len;
}

bool parse_f64(const char* p, int32_t len, double* out) {
  while (len > 0 && (*p == ' ' || *p == '\t')) p++, len--;
  while (len > 0 && (p[len - 1] == ' ' || p[len - 1] == '\t')) len--;
  if (len == 0 || len > 63) return false;
  char tmp[64];
  std::memcpy(tmp, p, len);
  tmp[len] = '\0';
  char* end = nullptr;
  *out = std::strtod(tmp, &end);
  return end == tmp + len;
}

bool parse_bool(const char* p, int32_t len, bool* out) {
  if (len == 4 && strncasecmp(p, "true", 4) == 0) return *out = true, true;
  if (len == 5 && strncasecmp(p, "false", 5) == 0) return *out = false, true;
  return false;
}

struct Handle {
  CsvResult result;
  std::string error;
};

}  // namespace

extern "C" {

struct CtCsvOptions {
  char delimiter;
  int32_t has_header;
  int32_t skip_rows;
  int32_t string_width;
  const char* null_values;  // '\n'-joined; NULL = defaults
  int32_t use_quoting;
  char quote_char;
  int32_t strings_can_be_null;
};

void* ct_csv_read(const char* path, const CtCsvOptions* copts, char* err,
                  int32_t errcap) {
  auto fail = [&](const std::string& msg) -> void* {
    if (err && errcap > 0) {
      int32_t n = std::min<int32_t>(msg.size(), errcap - 1);
      std::memcpy(err, msg.data(), n);
      err[n] = '\0';
    }
    return nullptr;
  };

  Options o;
  if (copts) {
    o.delimiter = copts->delimiter ? copts->delimiter : ',';
    o.has_header = copts->has_header != 0;
    o.skip_rows = copts->skip_rows;
    o.string_width = copts->string_width;
    o.use_quoting = copts->use_quoting != 0;
    o.quote_char = copts->quote_char ? copts->quote_char : '"';
    o.strings_can_be_null = copts->strings_can_be_null != 0;
    if (copts->null_values) {
      o.null_values.clear();
      const char* p = copts->null_values;
      while (true) {
        const char* nl = std::strchr(p, '\n');
        o.null_values.emplace_back(p, nl ? nl - p : std::strlen(p));
        if (!nl) break;
        p = nl + 1;
      }
    }
  }

  FILE* f = std::fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  // cell/line offsets are uint32 — reject files they cannot address (the
  // Python layer falls back to the pyarrow reader)
  if (static_cast<uint64_t>(fsize) > UINT32_MAX - 1) {
    std::fclose(f);
    return fail("file exceeds native reader's 4GiB limit");
  }
  std::vector<char> buf(fsize);
  if (fsize && std::fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return fail("short read");
  }
  std::fclose(f);

  // phase 1: quote-aware line boundaries
  std::vector<uint32_t> starts, ends;
  {
    bool in_quote = false;
    uint32_t line_start = 0;
    for (uint32_t i = 0; i < (uint32_t)fsize; i++) {
      char c = buf[i];
      if (o.use_quoting && c == o.quote_char) {
        in_quote = !in_quote;  // doubled quotes toggle twice: net zero
      } else if (c == '\n' && !in_quote) {
        uint32_t e = i;
        if (e > line_start && buf[e - 1] == '\r') e--;
        if (e > line_start) {
          starts.push_back(line_start);
          ends.push_back(e);
        }
        line_start = i + 1;
      }
    }
    if (line_start < (uint32_t)fsize) {
      uint32_t e = fsize;
      if (e > line_start && buf[e - 1] == '\r') e--;
      if (e > line_start) {
        starts.push_back(line_start);
        ends.push_back(e);
      }
    }
  }

  size_t first = o.skip_rows;
  auto h = std::make_unique<Handle>();
  CsvResult& res = h->result;

  std::vector<std::string> names;
  int ncols = 0;
  if (first < starts.size()) {
    std::vector<Cell> cells;
    ncols = split_line(buf.data(), starts[first], ends[first], o, cells);
    if (o.has_header) {
      std::vector<char> scratch;
      for (const Cell& c : cells) {
        CellView v = cell_view(buf.data(), c, o.quote_char, scratch);
        names.emplace_back(v.p, v.n);
      }
      first++;
    } else {
      for (int i = 0; i < ncols; i++) names.push_back("f" + std::to_string(i));
    }
  }
  int64_t rows = static_cast<int64_t>(starts.size()) - first;
  if (rows < 0) rows = 0;
  res.rows = rows;
  res.cols.resize(ncols);
  for (int c = 0; c < ncols; c++) res.cols[c].name = names[c];
  if (rows == 0 || ncols == 0) return h.release();

  // phase 2: threaded field slicing
  std::vector<Cell> cells(static_cast<size_t>(rows) * ncols);
  std::vector<int32_t> maxlen(ncols, 0);
  std::string bad_row;
  std::mutex m;
  parallel_rows(rows, kRowsPerThread, [&](int64_t lo, int64_t hi) {
    std::vector<Cell> line;
    std::vector<int32_t> local_max(ncols, 0);
    for (int64_t r = lo; r < hi; r++) {
      line.clear();
      int n = split_line(buf.data(), starts[first + r], ends[first + r], o,
                         line);
      if (n != ncols) {
        std::lock_guard<std::mutex> g(m);
        if (bad_row.empty())
          bad_row = "row " + std::to_string(r) + " has " + std::to_string(n) +
                    " fields, expected " + std::to_string(ncols);
        continue;
      }
      for (int c = 0; c < ncols; c++) {
        cells[r * ncols + c] = line[c];
        local_max[c] = std::max(local_max[c], line[c].len);
      }
    }
    std::lock_guard<std::mutex> g(m);
    for (int c = 0; c < ncols; c++) maxlen[c] = std::max(maxlen[c], local_max[c]);
  });
  if (!bad_row.empty()) return fail(bad_row);

  // phase 3a: threaded type inference (whole column; nulls don't break a
  // type).  Each thread scans a row range with local flags and stops once
  // every candidate type is ruled out for its range.
  for (int c = 0; c < ncols; c++) {
    std::atomic<bool> ok_i64{true}, ok_f64{true}, ok_bool{true}, any{false};
    parallel_rows(rows, kRowsPerThread, [&](int64_t lo, int64_t hi) {
      std::vector<char> scratch;
      bool li = true, lf = true, lb = true, la = false;
      for (int64_t r = lo; r < hi && (li || lf || lb); r++) {
        const Cell& cell = cells[r * ncols + c];
        CellView v = cell_view(buf.data(), cell, o.quote_char, scratch);
        if (!cell.quoted && is_null_token(o, v.p, v.n)) continue;
        la = true;
        int64_t iv;
        double dv;
        bool bv;
        if (li && !parse_i64(v.p, v.n, &iv)) li = false;
        if (lf && !parse_f64(v.p, v.n, &dv)) lf = false;
        if (lb && !parse_bool(v.p, v.n, &bv)) lb = false;
      }
      if (!li) ok_i64 = false;
      if (!lf) ok_f64 = false;
      if (!lb) ok_bool = false;
      if (la) any = true;
    });
    OutCol& col = res.cols[c];
    if (!any) col.dtype = CT_STRING;          // all-null → string
    else if (ok_i64) col.dtype = CT_INT64;
    else if (ok_f64) col.dtype = CT_FLOAT64;
    else if (ok_bool) col.dtype = CT_BOOL;
    else col.dtype = CT_STRING;
  }

  // phase 3b: threaded materialization
  for (int c = 0; c < ncols; c++) {
    OutCol& col = res.cols[c];
    switch (col.dtype) {
      case CT_INT64:
      case CT_FLOAT64: col.width = 8; break;
      case CT_BOOL: col.width = 1; break;
      case CT_STRING: {
        int32_t w = o.string_width > 0 ? o.string_width
                                       : std::max(1, maxlen[c]);
        col.width = (w + 7) & ~7;  // round to 8 for alignment
        col.lengths.assign(rows, 0);
        break;
      }
    }
    col.data.assign(static_cast<size_t>(rows) * col.width, 0);
    col.validity.assign(rows, 1);
  }
  parallel_rows(rows, kRowsPerThread, [&](int64_t lo, int64_t hi) {
    std::vector<char> scratch;
    for (int64_t r = lo; r < hi; r++) {
      for (int c = 0; c < ncols; c++) {
        OutCol& col = res.cols[c];
        const Cell& cell = cells[r * ncols + c];
        CellView v = cell_view(buf.data(), cell, o.quote_char, scratch);
        bool is_null = !cell.quoted && is_null_token(o, v.p, v.n) &&
                       (col.dtype != CT_STRING || o.strings_can_be_null);
        if (is_null) {
          col.validity[r] = 0;
          continue;
        }
        switch (col.dtype) {
          case CT_INT64: {
            int64_t val = 0;
            parse_i64(v.p, v.n, &val);
            std::memcpy(col.data.data() + r * 8, &val, 8);
            break;
          }
          case CT_FLOAT64: {
            double val = 0;
            parse_f64(v.p, v.n, &val);
            std::memcpy(col.data.data() + r * 8, &val, 8);
            break;
          }
          case CT_BOOL: {
            bool val = false;
            parse_bool(v.p, v.n, &val);
            col.data[r] = val ? 1 : 0;
            break;
          }
          case CT_STRING: {
            // truncation only when an explicit string_width option narrows
            // the column below the observed max length
            int32_t w = std::min(v.n, col.width);
            std::memcpy(col.data.data() + (int64_t)r * col.width, v.p, w);
            col.lengths[r] = w;
            break;
          }
        }
      }
    }
  });
  return h.release();
}

void ct_csv_free(void* handle) { delete static_cast<Handle*>(handle); }

int64_t ct_csv_rows(void* handle) {
  return static_cast<Handle*>(handle)->result.rows;
}

int32_t ct_csv_ncols(void* handle) {
  return static_cast<int32_t>(static_cast<Handle*>(handle)->result.cols.size());
}

int32_t ct_csv_col_name(void* handle, int32_t i, char* out, int32_t cap) {
  auto& cols = static_cast<Handle*>(handle)->result.cols;
  if (i < 0 || i >= (int32_t)cols.size()) return -1;
  const std::string& name = cols[i].name;
  int32_t n = std::min<int32_t>(name.size(), cap - 1);
  std::memcpy(out, name.data(), n);
  out[n] = '\0';
  return static_cast<int32_t>(name.size());
}

int32_t ct_csv_col_info(void* handle, int32_t i, int32_t* dtype,
                        int32_t* width) {
  auto& cols = static_cast<Handle*>(handle)->result.cols;
  if (i < 0 || i >= (int32_t)cols.size()) return -1;
  *dtype = cols[i].dtype;
  *width = cols[i].width;
  return 0;
}

const void* ct_csv_col_data(void* handle, int32_t i) {
  auto& cols = static_cast<Handle*>(handle)->result.cols;
  if (i < 0 || i >= (int32_t)cols.size()) return nullptr;
  return cols[i].data.data();
}

const uint8_t* ct_csv_col_validity(void* handle, int32_t i) {
  auto& cols = static_cast<Handle*>(handle)->result.cols;
  if (i < 0 || i >= (int32_t)cols.size()) return nullptr;
  return cols[i].validity.data();
}

const int32_t* ct_csv_col_lengths(void* handle, int32_t i) {
  auto& cols = static_cast<Handle*>(handle)->result.cols;
  if (i < 0 || i >= (int32_t)cols.size()) return nullptr;
  return cols[i].lengths.empty() ? nullptr : cols[i].lengths.data();
}

// --- writer ------------------------------------------------------------

struct CtWriteCol {
  const char* name;
  int32_t dtype;
  int32_t width;
  const void* data;
  const uint8_t* validity;  // may be NULL (all valid)
  const int32_t* lengths;   // strings only
};

int32_t ct_csv_write(const char* path, const CtWriteCol* cols, int32_t ncols,
                     int64_t rows, char delimiter) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::string out;
  out.reserve(1 << 20);
  for (int32_t c = 0; c < ncols; c++) {
    if (c) out += delimiter;
    out += cols[c].name;
  }
  out += '\n';
  char tmp[64];
  for (int64_t r = 0; r < rows; r++) {
    for (int32_t c = 0; c < ncols; c++) {
      if (c) out += delimiter;
      const CtWriteCol& col = cols[c];
      if (col.validity && !col.validity[r]) continue;  // empty = null
      const uint8_t* base = static_cast<const uint8_t*>(col.data);
      switch (col.dtype) {
        case CT_INT64: {
          int64_t v;
          std::memcpy(&v, base + r * 8, 8);
          out += std::to_string(v);
          break;
        }
        case CT_FLOAT64: {
          double v;
          std::memcpy(&v, base + r * 8, 8);
          std::snprintf(tmp, sizeof(tmp), "%.17g", v);
          out += tmp;
          break;
        }
        case CT_BOOL: out += base[r] ? "True" : "False"; break;  // pandas-style, round-trips both readers
        case CT_STRING: {
          int32_t n = col.lengths ? col.lengths[r] : col.width;
          const char* p =
              reinterpret_cast<const char*>(base + (int64_t)r * col.width);
          bool need_quote =
              std::memchr(p, delimiter, n) || std::memchr(p, '"', n) ||
              std::memchr(p, '\n', n);
          if (need_quote) {
            out += '"';
            for (int32_t i = 0; i < n; i++) {
              if (p[i] == '"') out += '"';
              out += p[i];
            }
            out += '"';
          } else {
            out.append(p, n);
          }
          break;
        }
      }
    }
    out += '\n';
    if (out.size() > (1 << 20)) {
      std::fwrite(out.data(), 1, out.size(), f);
      out.clear();
    }
  }
  std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
