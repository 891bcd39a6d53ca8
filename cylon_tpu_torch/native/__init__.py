"""The port's host C++ library, loaded over ctypes.

A copy of ``cylon_tpu/native/__init__.py`` over the port's own copy of the
sources (``src/``), built by ``build.py`` into
``build/cylon_tpu_torch/native/`` at first use; it never loads the JAX
package's library.  Host-side equivalents of the reference's C++ runtime
components:

- murmur3 + threaded multi-column row hashing / partition targets
  (reference: cpp/src/cylon/util/murmur3.cpp and
  arrow/arrow_partition_kernels.hpp:93-362)
- threaded CSV reader/writer producing Column-shaped flat buffers
  (reference: cpp/src/cylon/io/arrow_io.cpp:33-61, io/csv_read_config.hpp)
- tracking host memory pool (reference: ctx/memory_pool.hpp:25-66)
- raw-buffer column builder + string-id table registry — the foreign-binding
  surface (reference: arrow/arrow_builder.hpp:23-35, table_api.cpp:33-62)

``available()`` is False when the library cannot be built (no C++
toolchain) or ``CYLON_TPU_NO_NATIVE`` is set, and the I/O layer then
falls back to pyarrow, as the reference does.  The fallback is loud: a
failed build prints the compiler's error to stderr, and ``io.reader_counts``
says which reader served each file.  The device path never depends on
this module.
"""
from __future__ import annotations

import ctypes as ct
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config

# dtype codes shared with src/hashing.cpp / src/csv.cpp
CT_INT64 = 0
CT_FLOAT64 = 1
CT_BOOL = 2
CT_STRING = 3

_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None
_load_error: Optional[str] = None


class _CtHashCol(ct.Structure):
    _fields_ = [("data", ct.c_void_p), ("lengths", ct.c_void_p),
                ("dtype", ct.c_int32), ("width", ct.c_int32)]


class _CtCsvOptions(ct.Structure):
    _fields_ = [("delimiter", ct.c_char), ("has_header", ct.c_int32),
                ("skip_rows", ct.c_int32), ("string_width", ct.c_int32),
                ("null_values", ct.c_char_p), ("use_quoting", ct.c_int32),
                ("quote_char", ct.c_char),
                ("strings_can_be_null", ct.c_int32)]


class _CtWriteCol(ct.Structure):
    _fields_ = [("name", ct.c_char_p), ("dtype", ct.c_int32),
                ("width", ct.c_int32), ("data", ct.c_void_p),
                ("validity", ct.c_void_p), ("lengths", ct.c_void_p)]


def _bind(lib: ct.CDLL) -> None:
    lib.ct_row_hash.argtypes = [ct.POINTER(_CtHashCol), ct.c_int32,
                                ct.c_int64, ct.POINTER(ct.c_uint32)]
    lib.ct_partition_targets.argtypes = [
        ct.POINTER(ct.c_uint32), ct.c_int64, ct.c_int32,
        ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64)]
    lib.ct_murmur3_x86_32.restype = ct.c_uint32
    lib.ct_murmur3_x86_32.argtypes = [ct.c_void_p, ct.c_int32, ct.c_uint32]

    lib.ct_pool_create.restype = ct.c_void_p
    lib.ct_pool_destroy.argtypes = [ct.c_void_p]
    lib.ct_pool_alloc.restype = ct.c_void_p
    lib.ct_pool_alloc.argtypes = [ct.c_void_p, ct.c_int64]
    lib.ct_pool_free.argtypes = [ct.c_void_p, ct.c_void_p]
    for fn in ("ct_pool_bytes_allocated", "ct_pool_max_memory",
               "ct_pool_num_allocations"):
        f = getattr(lib, fn)
        f.restype = ct.c_int64
        f.argtypes = [ct.c_void_p]

    lib.ct_csv_read.restype = ct.c_void_p
    lib.ct_csv_read.argtypes = [ct.c_char_p, ct.POINTER(_CtCsvOptions),
                                ct.c_char_p, ct.c_int32]
    lib.ct_csv_free.argtypes = [ct.c_void_p]
    lib.ct_csv_rows.restype = ct.c_int64
    lib.ct_csv_rows.argtypes = [ct.c_void_p]
    lib.ct_csv_ncols.restype = ct.c_int32
    lib.ct_csv_ncols.argtypes = [ct.c_void_p]
    lib.ct_csv_col_name.restype = ct.c_int32
    lib.ct_csv_col_name.argtypes = [ct.c_void_p, ct.c_int32, ct.c_char_p,
                                    ct.c_int32]
    lib.ct_csv_col_info.restype = ct.c_int32
    lib.ct_csv_col_info.argtypes = [ct.c_void_p, ct.c_int32,
                                    ct.POINTER(ct.c_int32),
                                    ct.POINTER(ct.c_int32)]
    for fn in ("ct_csv_col_data", "ct_csv_col_validity",
               "ct_csv_col_lengths"):
        f = getattr(lib, fn)
        f.restype = ct.c_void_p
        f.argtypes = [ct.c_void_p, ct.c_int32]
    lib.ct_csv_write.restype = ct.c_int32
    lib.ct_csv_write.argtypes = [ct.c_char_p, ct.POINTER(_CtWriteCol),
                                 ct.c_int32, ct.c_int64, ct.c_char]

    lib.ct_builder_begin.restype = ct.c_int32
    lib.ct_builder_begin.argtypes = [ct.c_char_p]
    lib.ct_builder_add_column.restype = ct.c_int32
    lib.ct_builder_add_column.argtypes = [
        ct.c_char_p, ct.c_char_p, ct.c_int32, ct.c_int32, ct.c_int64,
        ct.c_void_p, ct.c_void_p, ct.c_void_p]
    lib.ct_builder_finish.restype = ct.c_int32
    lib.ct_builder_finish.argtypes = [ct.c_char_p]
    lib.ct_registry_contains.restype = ct.c_int32
    lib.ct_registry_contains.argtypes = [ct.c_char_p]
    lib.ct_registry_remove.restype = ct.c_int32
    lib.ct_registry_remove.argtypes = [ct.c_char_p]
    lib.ct_registry_size.restype = ct.c_int64
    lib.ct_registry_ids.restype = ct.c_int64
    lib.ct_registry_ids.argtypes = [ct.c_char_p, ct.c_int64]
    lib.ct_table_rows.restype = ct.c_int64
    lib.ct_table_rows.argtypes = [ct.c_char_p]
    lib.ct_table_ncols.restype = ct.c_int32
    lib.ct_table_ncols.argtypes = [ct.c_char_p]
    lib.ct_table_col_name.restype = ct.c_int32
    lib.ct_table_col_name.argtypes = [ct.c_char_p, ct.c_int32, ct.c_char_p,
                                      ct.c_int32]
    lib.ct_table_col_info.restype = ct.c_int32
    lib.ct_table_col_info.argtypes = [
        ct.c_char_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32)]
    for fn in ("ct_table_col_data", "ct_table_col_validity",
               "ct_table_col_lengths"):
        f = getattr(lib, fn)
        f.restype = ct.c_void_p
        f.argtypes = [ct.c_char_p, ct.c_int32]


def _load() -> Optional[ct.CDLL]:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        if config.knob("CYLON_TPU_NO_NATIVE"):
            _load_error = "disabled by CYLON_TPU_NO_NATIVE"
            return None
        try:
            from . import build
            lib_file = build.build()
            lib = ct.CDLL(str(lib_file))
            _bind(lib)
            _lib = lib
        except Exception as e:  # toolchain missing / build failure
            _load_error = str(e)
            print(f"[cylon_tpu_torch.native] unavailable, the I/O layer "
                  f"falls back to pyarrow: {e}", file=sys.stderr)
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _load_error


def _require() -> ct.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native unavailable: {_load_error}")
    return lib


def _read_buf(ptr, ctype, shape, np_dtype) -> np.ndarray:
    """Copy a C buffer into numpy; empty tables have no buffer to read."""
    if shape[0] == 0 or not ptr:
        return np.zeros(shape, dtype=np_dtype)
    return np.ctypeslib.as_array(ct.cast(ptr, ct.POINTER(ctype)), shape).copy()


def murmur3_32(data: bytes, seed: int = 0) -> int:
    lib = _require()
    buf = ct.create_string_buffer(data, len(data))
    return int(lib.ct_murmur3_x86_32(ct.cast(buf, ct.c_void_p), len(data),
                                     seed))


def _hash_cols_from_numpy(arrays, lengths_list) -> Tuple[List[_CtHashCol], list]:
    cols = []
    keepalive = []
    for arr, lengths in zip(arrays, lengths_list):
        arr = np.ascontiguousarray(arr)
        keepalive.append(arr)
        if arr.dtype == np.uint8 and arr.ndim == 2:
            dtype, width = CT_STRING, arr.shape[1]
            if lengths is not None:
                lengths = np.ascontiguousarray(lengths, dtype=np.int32)
                keepalive.append(lengths)
        else:
            if arr.ndim != 1:
                raise ValueError("fixed-width hash input must be 1-D")
            width = arr.dtype.itemsize
            dtype = CT_INT64 if arr.dtype.kind in "iub" else CT_FLOAT64
            lengths = None
        cols.append(_CtHashCol(
            arr.ctypes.data_as(ct.c_void_p),
            None if lengths is None else lengths.ctypes.data_as(ct.c_void_p),
            dtype, width))
    return cols, keepalive


def row_hash(arrays: Sequence[np.ndarray],
             lengths: Optional[Sequence[Optional[np.ndarray]]] = None
             ) -> np.ndarray:
    """Threaded composite row hash (reference:
    HashPartitionKernel::UpdateHash, arrow_partition_kernels.hpp:199-233)."""
    lib = _require()
    if lengths is None:
        lengths = [None] * len(arrays)
    rows = len(arrays[0])
    cols, keepalive = _hash_cols_from_numpy(arrays, lengths)
    out = np.empty(rows, dtype=np.uint32)
    arr_t = (_CtHashCol * len(cols))(*cols)
    lib.ct_row_hash(arr_t, len(cols), rows,
                    out.ctypes.data_as(ct.POINTER(ct.c_uint32)))
    return out


def partition_targets(hashes: np.ndarray, world: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """targets + histogram from row hashes (reference:
    arrow_partition_kernels.hpp:60-70 modulo/mask partitioner)."""
    lib = _require()
    hashes = np.ascontiguousarray(hashes, dtype=np.uint32)
    targets = np.empty(len(hashes), dtype=np.uint32)
    hist = np.zeros(world, dtype=np.int64)
    lib.ct_partition_targets(
        hashes.ctypes.data_as(ct.POINTER(ct.c_uint32)), len(hashes), world,
        targets.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        hist.ctypes.data_as(ct.POINTER(ct.c_int64)))
    return targets, hist


class MemoryPool:
    """Tracking host allocator (reference: ctx/memory_pool.hpp:25-66)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native unavailable: {_load_error}")
        self._lib = lib
        self._pool = lib.ct_pool_create()
        self._live = set()

    def allocate(self, size: int) -> int:
        ptr = self._lib.ct_pool_alloc(self._pool, size)
        if not ptr:
            raise MemoryError(f"pool allocation of {size} bytes failed")
        self._live.add(ptr)
        return ptr

    def free(self, ptr: int) -> None:
        self._live.discard(ptr)
        self._lib.ct_pool_free(self._pool, ptr)

    @property
    def bytes_allocated(self) -> int:
        return self._lib.ct_pool_bytes_allocated(self._pool)

    @property
    def max_memory(self) -> int:
        return self._lib.ct_pool_max_memory(self._pool)

    @property
    def num_allocations(self) -> int:
        return self._lib.ct_pool_num_allocations(self._pool)

    def close(self) -> None:
        if self._pool:
            for ptr in list(self._live):
                self.free(ptr)
            self._lib.ct_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # cylint: disable=CY105 -- __del__ runs during interpreter teardown; raising here aborts GC and no Status consumer exists
            pass


def csv_read(path, delimiter: str = ",", has_header: bool = True,
             skip_rows: int = 0, string_width: int = 0,
             null_values: Optional[Sequence[str]] = None,
             use_quoting: bool = True, quote_char: str = '"',
             strings_can_be_null: bool = False
             ) -> Tuple[List[str], List[Dict[str, np.ndarray]]]:
    """Read a CSV into Column-shaped numpy buffers.

    Returns (names, cols) where each col dict has ``data`` (1-D for
    fixed-width, 2-D uint8 for strings), ``validity`` (bool), and
    optionally ``lengths`` (int32).
    """
    lib = _require()
    opts = _CtCsvOptions(
        delimiter.encode()[:1], 1 if has_header else 0, skip_rows,
        string_width,
        None if null_values is None
        else "\n".join(null_values).encode("utf-8"),
        1 if use_quoting else 0, quote_char.encode()[:1],
        1 if strings_can_be_null else 0)
    err = ct.create_string_buffer(512)
    h = lib.ct_csv_read(str(path).encode("utf-8"), ct.byref(opts), err, 512)
    if not h:
        raise RuntimeError(f"native csv read failed: {err.value.decode()}")
    try:
        rows = lib.ct_csv_rows(h)
        ncols = lib.ct_csv_ncols(h)
        names, cols = [], []
        namebuf = ct.create_string_buffer(4096)
        for i in range(ncols):
            lib.ct_csv_col_name(h, i, namebuf, 4096)
            names.append(namebuf.value.decode("utf-8"))
            dtype = ct.c_int32()
            width = ct.c_int32()
            lib.ct_csv_col_info(h, i, ct.byref(dtype), ct.byref(width))
            dptr = lib.ct_csv_col_data(h, i)
            vptr = lib.ct_csv_col_validity(h, i)
            col: Dict[str, np.ndarray] = {}
            if dtype.value == CT_STRING:
                col["data"] = _read_buf(dptr, ct.c_uint8,
                                        (rows, width.value), np.uint8)
                lptr = lib.ct_csv_col_lengths(h, i)
                col["lengths"] = _read_buf(lptr, ct.c_int32, (rows,),
                                           np.int32)
            elif dtype.value == CT_INT64:
                col["data"] = _read_buf(dptr, ct.c_int64, (rows,), np.int64)
            elif dtype.value == CT_FLOAT64:
                col["data"] = _read_buf(dptr, ct.c_double, (rows,),
                                        np.float64)
            else:  # CT_BOOL
                col["data"] = _read_buf(dptr, ct.c_uint8, (rows,),
                                        np.uint8).astype(bool)
            col["validity"] = _read_buf(vptr, ct.c_uint8, (rows,),
                                        np.uint8).astype(bool)
            cols.append(col)
        return names, cols
    finally:
        lib.ct_csv_free(h)


def csv_write(path, names: Sequence[str], arrays: Sequence[np.ndarray],
              validities: Sequence[Optional[np.ndarray]],
              lengths_list: Sequence[Optional[np.ndarray]],
              delimiter: str = ",") -> None:
    lib = _require()
    rows = len(arrays[0]) if arrays else 0
    cols = []
    keepalive = []
    for name, arr, valid, lengths in zip(names, arrays, validities,
                                         lengths_list):
        arr = np.ascontiguousarray(arr)
        keepalive.append(arr)
        if arr.dtype == np.uint8 and arr.ndim == 2:
            dtype, width = CT_STRING, arr.shape[1]
        elif arr.dtype.kind == "b":
            arr = arr.astype(np.uint8)
            keepalive.append(arr)
            dtype, width = CT_BOOL, 1
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
            keepalive.append(arr)
            dtype, width = CT_INT64, 8
        else:
            arr = arr.astype(np.float64)
            keepalive.append(arr)
            dtype, width = CT_FLOAT64, 8
        vptr = None
        if valid is not None:
            valid = np.ascontiguousarray(valid, dtype=np.uint8)
            keepalive.append(valid)
            vptr = valid.ctypes.data_as(ct.c_void_p)
        lptr = None
        if lengths is not None:
            lengths = np.ascontiguousarray(lengths, dtype=np.int32)
            keepalive.append(lengths)
            lptr = lengths.ctypes.data_as(ct.c_void_p)
        nm = name.encode("utf-8")
        keepalive.append(nm)
        cols.append(_CtWriteCol(nm, dtype, width,
                                arr.ctypes.data_as(ct.c_void_p), vptr, lptr))
    arr_t = (_CtWriteCol * len(cols))(*cols)
    rc = lib.ct_csv_write(str(path).encode("utf-8"), arr_t, len(cols), rows,
                          delimiter.encode()[:1])
    if rc != 0:
        raise RuntimeError(f"native csv write failed: rc={rc}")


# --- registry / builder (foreign-binding surface) -----------------------

def builder_begin(table_id: str) -> None:
    lib = _require()
    if lib.ct_builder_begin(table_id.encode("utf-8")) != 0:
        raise RuntimeError(f"builder already open for id {table_id!r}")


def builder_add_column(table_id: str, name: str, data: np.ndarray,
                       validity: Optional[np.ndarray] = None,
                       lengths: Optional[np.ndarray] = None) -> None:
    lib = _require()
    data = np.ascontiguousarray(data)
    if data.dtype == np.uint8 and data.ndim == 2:
        dtype, width, rows = CT_STRING, data.shape[1], data.shape[0]
    elif data.dtype.kind == "b":
        data = data.astype(np.uint8)
        dtype, width, rows = CT_BOOL, 1, len(data)
    elif data.dtype.kind in "iu":
        data = data.astype(np.int64)
        dtype, width, rows = CT_INT64, 8, len(data)
    else:
        data = data.astype(np.float64)
        dtype, width, rows = CT_FLOAT64, 8, len(data)
    vptr = None
    if validity is not None:
        validity = np.ascontiguousarray(validity, dtype=np.uint8)
        vptr = validity.ctypes.data_as(ct.c_void_p)
    lptr = None
    if lengths is not None:
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        lptr = lengths.ctypes.data_as(ct.c_void_p)
    rc = lib.ct_builder_add_column(
        table_id.encode("utf-8"), name.encode("utf-8"), dtype, width, rows,
        data.ctypes.data_as(ct.c_void_p), vptr, lptr)
    if rc != 0:
        raise RuntimeError(f"builder_add_column failed: rc={rc}")


def builder_finish(table_id: str) -> None:
    lib = _require()
    if lib.ct_builder_finish(table_id.encode("utf-8")) != 0:
        raise RuntimeError(f"no open builder for id {table_id!r}")


def registry_contains(table_id: str) -> bool:
    lib = _load()
    if lib is None:
        return False
    return bool(lib.ct_registry_contains(table_id.encode("utf-8")))


def registry_remove(table_id: str) -> bool:
    lib = _require()
    return lib.ct_registry_remove(table_id.encode("utf-8")) == 0


def registry_size() -> int:
    lib = _require()
    return int(lib.ct_registry_size())


def registry_ids() -> List[str]:
    lib = _require()
    n = lib.ct_registry_ids(None, 0)
    buf = ct.create_string_buffer(int(n) + 1)
    lib.ct_registry_ids(buf, n + 1)
    s = buf.value.decode("utf-8")
    return s.split("\n") if s else []


def registry_get(table_id: str
                 ) -> Tuple[List[str], List[Dict[str, np.ndarray]]]:
    """Zero-copy read-out of a registered table (copies into numpy on
    return so the registry entry can be dropped safely)."""
    lib = _require()
    tid = table_id.encode("utf-8")
    rows = lib.ct_table_rows(tid)
    if rows < 0:
        raise KeyError(table_id)
    ncols = lib.ct_table_ncols(tid)
    names, cols = [], []
    namebuf = ct.create_string_buffer(4096)
    for i in range(ncols):
        lib.ct_table_col_name(tid, i, namebuf, 4096)
        names.append(namebuf.value.decode("utf-8"))
        dtype = ct.c_int32()
        width = ct.c_int32()
        crows = ct.c_int64()
        has_v = ct.c_int32()
        has_l = ct.c_int32()
        lib.ct_table_col_info(tid, i, ct.byref(dtype), ct.byref(width),
                              ct.byref(crows), ct.byref(has_v),
                              ct.byref(has_l))
        dptr = lib.ct_table_col_data(tid, i)
        col: Dict[str, np.ndarray] = {}
        if dtype.value == CT_STRING:
            col["data"] = _read_buf(dptr, ct.c_uint8, (rows, width.value),
                                    np.uint8)
        elif dtype.value == CT_INT64:
            col["data"] = _read_buf(dptr, ct.c_int64, (rows,), np.int64)
        elif dtype.value == CT_FLOAT64:
            col["data"] = _read_buf(dptr, ct.c_double, (rows,), np.float64)
        else:
            col["data"] = _read_buf(dptr, ct.c_uint8, (rows,),
                                    np.uint8).astype(bool)
        if has_v.value:
            vptr = lib.ct_table_col_validity(tid, i)
            col["validity"] = _read_buf(vptr, ct.c_uint8, (rows,),
                                        np.uint8).astype(bool)
        if has_l.value:
            lptr = lib.ct_table_col_lengths(tid, i)
            col["lengths"] = _read_buf(lptr, ct.c_int32, (rows,), np.int32)
        cols.append(col)
    return names, cols
