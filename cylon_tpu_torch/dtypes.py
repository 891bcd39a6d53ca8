"""Logical column types.

A copy of the JAX package's ``cylon_tpu/dtypes.py`` type system (reference:
cpp/src/cylon/data_types.hpp:25-120) and its Arrow interop.  A logical
type's buffer has the numpy dtype ``numpy_dtype()`` names, and its torch
tensor the matching torch dtype.  Temporal types travel as their Arrow
physical integer widths; STRING / BINARY / FIXED_SIZE_BINARY are uint8
byte matrices ``[capacity, width]`` with int32 lengths (``column.py``).
pyarrow is imported inside the functions that need it, never at module
level: the package runs without it.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np


class Type(enum.IntEnum):
    """Logical types (reference: cpp/src/cylon/data_types.hpp:25-86); the
    numbering equals the JAX package's so types convert by value."""

    BOOL = 0
    UINT8 = 1
    INT8 = 2
    UINT16 = 3
    INT16 = 4
    UINT32 = 5
    INT32 = 6
    UINT64 = 7
    INT64 = 8
    HALF_FLOAT = 9
    FLOAT = 10
    DOUBLE = 11
    STRING = 12
    BINARY = 13
    FIXED_SIZE_BINARY = 14
    DATE32 = 15
    DATE64 = 16
    TIMESTAMP = 17
    TIME32 = 18
    TIME64 = 19
    DECIMAL = 20
    DURATION = 21
    INTERVAL = 22
    LIST = 23
    FIXED_SIZE_LIST = 24
    EXTENSION = 25
    MAX_ID = 26


_NUMPY_OF = {
    Type.BOOL: np.bool_,
    Type.UINT8: np.uint8,
    Type.INT8: np.int8,
    Type.UINT16: np.uint16,
    Type.INT16: np.int16,
    Type.UINT32: np.uint32,
    Type.INT32: np.int32,
    Type.UINT64: np.uint64,
    Type.INT64: np.int64,
    Type.HALF_FLOAT: np.float16,
    Type.FLOAT: np.float32,
    Type.DOUBLE: np.float64,
    # the device representation of byte strings is a uint8 matrix
    Type.STRING: np.uint8,
    Type.BINARY: np.uint8,
    Type.FIXED_SIZE_BINARY: np.uint8,
    Type.DATE32: np.int32,
    Type.DATE64: np.int64,
    Type.TIMESTAMP: np.int64,
    Type.TIME32: np.int32,
    Type.TIME64: np.int64,
    Type.DURATION: np.int64,
}

_TYPE_OF_NUMPY = {np.dtype(v): k for k, v in _NUMPY_OF.items()
                  if k <= Type.DOUBLE}


@dataclass(frozen=True)
class DataType:
    """A logical column type (reference: data_types.hpp DataType)."""

    type: Type
    byte_width: int = -1
    unit: Optional[str] = None

    def numpy_dtype(self) -> np.dtype:
        try:
            return np.dtype(_NUMPY_OF[self.type])
        except KeyError:
            raise TypeError(
                f"type {self.type.name} has no device representation")

    def __repr__(self) -> str:
        if self.type == Type.FIXED_SIZE_BINARY:
            return f"fixed_size_binary[{self.byte_width}]"
        if self.unit:
            return f"{self.type.name.lower()}[{self.unit}]"
        return self.type.name.lower()


bool_ = DataType(Type.BOOL)
uint8 = DataType(Type.UINT8)
int8 = DataType(Type.INT8)
uint16 = DataType(Type.UINT16)
int16 = DataType(Type.INT16)
uint32 = DataType(Type.UINT32)
int32 = DataType(Type.INT32)
uint64 = DataType(Type.UINT64)
int64 = DataType(Type.INT64)
half_float = DataType(Type.HALF_FLOAT)
float_ = DataType(Type.FLOAT)
double = DataType(Type.DOUBLE)
string = DataType(Type.STRING)
binary = DataType(Type.BINARY)
date32 = DataType(Type.DATE32)
date64 = DataType(Type.DATE64)


def fixed_size_binary(width: int) -> DataType:
    return DataType(Type.FIXED_SIZE_BINARY, byte_width=width)


def timestamp(unit: str = "us") -> DataType:
    return DataType(Type.TIMESTAMP, unit=unit)


def time32(unit: str = "ms") -> DataType:
    return DataType(Type.TIME32, unit=unit)


def time64(unit: str = "us") -> DataType:
    return DataType(Type.TIME64, unit=unit)


def join_key_mismatch(a_is_string: bool, b_is_string: bool, same_type: bool,
                      either_empty: bool):
    """The join-key compatibility policy of ``cylon_tpu/dtypes.py:187``:
    "structural" (a string key against a fixed-width one), "mismatch"
    (differing fixed-width types on non-empty sides, whose concatenation
    would mis-order the packed sort operands), or None (compatible; string
    keys of any widths are padded to one)."""
    if a_is_string != b_is_string:
        return "structural"
    if not a_is_string and not same_type and not either_empty:
        return "mismatch"
    return None


def is_string_like(dt: DataType) -> bool:
    return dt.type in (Type.STRING, Type.BINARY, Type.FIXED_SIZE_BINARY)


def is_floating(dt: DataType) -> bool:
    return dt.type in (Type.HALF_FLOAT, Type.FLOAT, Type.DOUBLE)


def from_numpy_dtype(dtype) -> DataType:
    dtype = np.dtype(dtype)
    if dtype.kind in ("U", "S", "O"):
        return string
    if dtype.kind == "M":
        return timestamp("us")
    try:
        return DataType(_TYPE_OF_NUMPY[dtype])
    except KeyError:
        raise TypeError(f"unsupported numpy dtype {dtype}")



# -- Arrow interop (reference: cpp/src/cylon/arrow/arrow_types.cpp) ----------

def from_arrow_type(at) -> DataType:
    """This package's type of a pyarrow type (``cylon_tpu/dtypes.py:242``)."""
    import pyarrow as pa

    simple = ((pa.types.is_boolean, bool_), (pa.types.is_uint8, uint8),
              (pa.types.is_int8, int8), (pa.types.is_uint16, uint16),
              (pa.types.is_int16, int16), (pa.types.is_uint32, uint32),
              (pa.types.is_int32, int32), (pa.types.is_uint64, uint64),
              (pa.types.is_int64, int64), (pa.types.is_float16, half_float),
              (pa.types.is_float32, float_), (pa.types.is_float64, double),
              (pa.types.is_string, string), (pa.types.is_large_string, string),
              (pa.types.is_binary, binary), (pa.types.is_large_binary, binary),
              (pa.types.is_date32, date32), (pa.types.is_date64, date64))
    for test, dt in simple:
        if test(at):
            return dt
    if pa.types.is_fixed_size_binary(at):
        return fixed_size_binary(at.byte_width)
    if pa.types.is_timestamp(at):
        return timestamp(at.unit)
    if pa.types.is_time32(at):
        return time32(at.unit)
    if pa.types.is_time64(at):
        return time64(at.unit)
    raise TypeError(f"unsupported arrow type {at}")


def to_arrow_type(dt: DataType):
    """The pyarrow type of one of this package's types
    (``cylon_tpu/dtypes.py:288``)."""
    import pyarrow as pa

    m = {Type.BOOL: pa.bool_(), Type.UINT8: pa.uint8(), Type.INT8: pa.int8(),
         Type.UINT16: pa.uint16(), Type.INT16: pa.int16(),
         Type.UINT32: pa.uint32(), Type.INT32: pa.int32(),
         Type.UINT64: pa.uint64(), Type.INT64: pa.int64(),
         Type.HALF_FLOAT: pa.float16(), Type.FLOAT: pa.float32(),
         Type.DOUBLE: pa.float64(), Type.STRING: pa.string(),
         Type.BINARY: pa.binary(), Type.DATE32: pa.date32(),
         Type.DATE64: pa.date64()}
    if dt.type in m:
        return m[dt.type]
    if dt.type == Type.FIXED_SIZE_BINARY:
        return pa.binary(dt.byte_width)
    if dt.type == Type.TIMESTAMP:
        return pa.timestamp(dt.unit or "us")
    if dt.type == Type.TIME32:
        return pa.time32(dt.unit or "ms")
    if dt.type == Type.TIME64:
        return pa.time64(dt.unit or "us")
    raise TypeError(f"unsupported type {dt}")
