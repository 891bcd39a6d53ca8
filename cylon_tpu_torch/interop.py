"""Carry column state across the two packages as plain numpy arrays.

``column_from_arrays`` turns the fields of a JAX-package ``Column`` (taken
out with ``np.asarray``) into this package's Column, bit for bit;
``column_to_arrays`` goes back.  Types convert by their ``Type`` number,
which both packages share, so this module needs nothing of the other
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dtypes
from .column import Column, resolve_device
from .status import Code, CylonError


def _as_datatype(dtype) -> dtypes.DataType:
    if isinstance(dtype, dtypes.DataType):
        return dtype
    return dtypes.DataType(dtypes.Type(int(dtype.type)),
                           getattr(dtype, "byte_width", -1),
                           getattr(dtype, "unit", None))


def column_from_arrays(data: np.ndarray, validity: np.ndarray,
                       lengths: Optional[np.ndarray], dtype,
                       device=None) -> Column:
    """A Column holding exactly ``data`` and ``validity`` (capacity, padding
    and null fill included).  ``dtype`` is this package's DataType or any
    object with the same ``type`` field, such as the JAX package's."""
    if lengths is not None or np.asarray(data).ndim != 1:
        raise CylonError(Code.NotImplemented,
                         "string columns are not ported yet")
    device = resolve_device(device)
    # copies: the source buffers may be read-only views of device arrays
    data = torch.from_numpy(np.array(data, copy=True)).to(device)
    valid = torch.from_numpy(np.array(validity, bool, copy=True)).to(device)
    return Column(data, valid, None, _as_datatype(dtype))


def column_to_arrays(col: Column) -> Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray],
                                           dtypes.DataType]:
    """(data, validity, lengths, dtype) of a Column, on the host."""
    lengths = None if col.lengths is None else col.lengths.cpu().numpy()
    return (col.data.cpu().numpy(), col.validity.cpu().numpy(), lengths,
            col.dtype)
