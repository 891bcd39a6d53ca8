"""Device-resident fixed-width column.

The port of ``cylon_tpu/column.py:64 Column`` (reference:
cpp/src/cylon/column.hpp:31-113) over torch tensors:

- every column has a static **capacity** (``data.shape[0]``); the number
  of live rows is carried beside it, and padding rows are zeroed;
- nulls are a ``bool[capacity]`` validity tensor (True = present).

Only fixed-width types are ported; string byte matrices come later.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import dtypes
from .dtypes import DataType
from .status import Code, CylonError


def default_device() -> torch.device:
    """The device entry points run on when the caller names none: the
    first CUDA card.  Without one this raises; it never falls back to the
    CPU (pass ``device="cpu"`` to run there)."""
    if not torch.cuda.is_available():
        raise CylonError(Code.Invalid,
                         "no CUDA device available; pass device='cpu' to "
                         "run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


@dataclass
class Column:
    """One typed column of device buffers.

    data:      [capacity] fixed-width values
    validity:  bool[capacity]; True = value present
    lengths:   byte lengths of string columns (always None here)
    dtype:     logical type
    """

    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    dtype: DataType = dtypes.int64

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_string(self) -> bool:
        return dtypes.is_string_like(self.dtype)

    def take(self, indices: torch.Tensor,
             valid_mask: Optional[torch.Tensor] = None) -> "Column":
        """Gather rows by index, clamping out-of-range indices into
        [0, capacity) like ``jnp.take(..., mode="clip")``; optionally AND
        validity with ``valid_mask`` and zero the rows it clears (the
        outer joins' null fill, reference join.cpp:179-235)."""
        idx = indices.clamp(0, self.capacity - 1)
        data = self.data[idx]
        validity = self.validity[idx]
        if valid_mask is not None:
            validity = validity & valid_mask
            zero = torch.zeros((), dtype=data.dtype, device=data.device)
            data = torch.where(validity, data, zero)
        return Column(data, validity, None, self.dtype)


def _next_capacity(n: int, capacity: Optional[int]) -> int:
    if capacity is not None:
        if capacity < n:
            raise ValueError(f"capacity {capacity} < row count {n}")
        return capacity
    return max(8, n)


def from_numpy(values: np.ndarray, *, validity: Optional[np.ndarray] = None,
               capacity: Optional[int] = None,
               dtype: Optional[DataType] = None, device=None) -> Column:
    """Build a Column from a host numpy array, with the same capacity and
    null rules as ``cylon_tpu/column.py:193 from_numpy``: float NaN is a
    null, and null and padding rows hold zero."""
    device = resolve_device(device)
    values = np.asarray(values)
    if values.dtype.kind in ("U", "S", "O"):
        raise CylonError(Code.NotImplemented,
                         "string columns are not ported yet")
    n = len(values)
    cap = _next_capacity(n, capacity)
    if values.dtype.kind == "M":
        if validity is None:
            validity = ~np.isnat(values)
        values = values.astype("datetime64[us]").astype(np.int64)
        dt = dtype or dtypes.timestamp("us")
    else:
        dt = dtype or dtypes.from_numpy_dtype(values.dtype)
    if validity is None and values.dtype.kind == "f":
        validity = ~np.isnan(values)
    buf = np.zeros((cap,), values.dtype)
    valid = np.zeros((cap,), bool)
    valid[:n] = True if validity is None else validity[:n]
    buf[:n] = np.where(valid[:n], values, np.zeros((), values.dtype))
    return Column(torch.from_numpy(buf).to(device),
                  torch.from_numpy(valid).to(device), None, dt)


def to_numpy(col: Column, row_count) -> np.ndarray:
    """Export the live rows to the host; nulls become None in an object
    array, as in ``cylon_tpu/column.py:395 to_numpy``."""
    n = int(row_count)
    valid = col.validity[:n].cpu().numpy()
    vals = col.data[:n].cpu().numpy()
    ndt = col.dtype.numpy_dtype()
    if vals.dtype != ndt and vals.dtype.kind in "iu" \
            and np.dtype(ndt).kind in "iu":
        vals = vals.astype(ndt)  # narrow-mode count buffers widen at export
    if valid.all():
        return vals
    out = vals.astype(object)
    out[~valid] = None
    return out
