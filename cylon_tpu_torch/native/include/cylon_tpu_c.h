/* cylon_tpu C ABI — the foreign-language binding surface.
 *
 * This is the contract the reference exposes to Java over JNI
 * (java/src/main/native/src/Table.cpp calling table_api.hpp:38-195 and
 * arrow/arrow_builder.hpp:23-35): a string-id table registry plus a
 * raw-buffer column builder.  Any language with a C FFI (C, Java via
 * Panama/JNI, Go cgo, C#, ...) can host cylon_tpu tables through these
 * fifteen functions; the Python package itself consumes them via ctypes
 * (cylon_tpu_torch/native/__init__.py), so this header IS the tested surface,
 * not a parallel one.
 *
 * Conventions: unless noted otherwise, int32_t returns are 0 on success
 * and negative on error (-1 unknown id / out-of-range, -2 row-count
 * mismatch).  Exceptions: ct_registry_contains returns 1 present /
 * 0 absent; ct_table_col_name and ct_registry_ids return the FULL
 * length of the requested string (like snprintf) — the caller's buffer
 * must hold length+1 bytes or the copy is NUL-truncated to cap-1.
 * Pointer returns are borrowed views owned by the registry — valid
 * until the table is removed or the registry cleared; never free()
 * them.  All functions are thread-safe (one internal mutex).
 *
 * dtype codes match cylon_tpu_torch.dtypes.Type (dtypes.py): the builder
 * stores them opaquely, so a foreign host only needs agreement with the
 * reader on the other side.  width is bytes per row (strings: the padded
 * matrix row width); lengths[] carries per-row byte lengths for strings.
 */
#ifndef CYLON_TPU_C_H_
#define CYLON_TPU_C_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- builder: stage columns, then publish atomically ---- */
int32_t ct_builder_begin(const char* id);
int32_t ct_builder_add_column(const char* id, const char* name, int32_t dtype,
                              int32_t width, int64_t rows, const void* data,
                              const uint8_t* validity, const int32_t* lengths);
int32_t ct_builder_finish(const char* id);

/* ---- registry: string-id -> table, mirrors table_api.hpp ---- */
int32_t ct_registry_contains(const char* id);
int32_t ct_registry_remove(const char* id);
int64_t ct_registry_size(void);
void ct_registry_clear(void);
/* ids joined by '\n' into caller buffer (NUL-terminated, truncated to
 * cap-1 bytes); returns the full joined length — size the buffer as
 * ct_registry_ids(NULL, 0) + 1. */
int64_t ct_registry_ids(char* out, int64_t cap);

/* ---- readers: zero-copy borrowed views ---- */
int64_t ct_table_rows(const char* id);
int32_t ct_table_ncols(const char* id);
int32_t ct_table_col_name(const char* id, int32_t i, char* out, int32_t cap);
int32_t ct_table_col_info(const char* id, int32_t i, int32_t* dtype,
                          int32_t* width, int64_t* rows, int32_t* has_validity,
                          int32_t* has_lengths);
const void* ct_table_col_data(const char* id, int32_t i);
const uint8_t* ct_table_col_validity(const char* id, int32_t i);
const int32_t* ct_table_col_lengths(const char* id, int32_t i);

#ifdef __cplusplus
}
#endif

#endif /* CYLON_TPU_C_H_ */
