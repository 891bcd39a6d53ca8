"""Logical column types.

A copy of the JAX package's ``cylon_tpu/dtypes.py`` type system (reference:
cpp/src/cylon/data_types.hpp:25-120), without its Arrow interop.  A logical
type's buffer has the numpy dtype ``numpy_dtype()`` names, and its torch
tensor the matching torch dtype.  Temporal types travel as their Arrow
physical integer widths; STRING/BINARY have no device representation in
this package yet.
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


def timestamp(unit: str = "us") -> DataType:
    return DataType(Type.TIMESTAMP, unit=unit)


def is_string_like(dt: DataType) -> bool:
    return dt.type in (Type.STRING, Type.BINARY, Type.FIXED_SIZE_BINARY)


def is_floating(dt: DataType) -> bool:
    return dt.type in (Type.HALF_FLOAT, Type.FLOAT, Type.DOUBLE)


def from_numpy_dtype(dtype) -> DataType:
    dtype = np.dtype(dtype)
    if dtype.kind == "M":
        return timestamp("us")
    try:
        return DataType(_TYPE_OF_NUMPY[dtype])
    except KeyError:
        raise TypeError(f"unsupported numpy dtype {dtype}")

