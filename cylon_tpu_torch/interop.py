"""Carry column state across the two packages as plain numpy arrays.

``column_from_arrays`` turns the fields of a JAX-package ``Column`` (taken
out with ``np.asarray``) into this package's Column, bit for bit, a string
column's 2-D byte matrix and lengths included;
``column_to_arrays`` goes back.  ``table_shards_to_arrays`` and
``table_from_shard_arrays`` do the same for a sharded ``Table``, shard by
shard, so shard contents compare with the reference's.  Types convert by
their ``Type`` number, which both packages share, so this module needs
nothing of the other package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    """A Column holding exactly ``data``, ``validity`` and ``lengths``
    (capacity, padding and null fill included).  ``dtype`` is this
    package's DataType or any object with the same ``type`` field, such as
    the JAX package's.  A string type takes a 2-D uint8 ``data`` and its
    int32 ``lengths``; a fixed-width one 1-D ``data`` and no lengths."""
    dt = _as_datatype(dtype)
    ndim = 2 if dtypes.is_string_like(dt) else 1
    if np.asarray(data).ndim != ndim or (lengths is None) != (ndim == 1):
        raise CylonError(Code.Invalid,
                         f"a {dt} column takes {ndim}-D data and "
                         f"{'lengths' if ndim == 2 else 'no lengths'}")
    device = resolve_device(device)

    def put(x, dtype=None):
        # copies: the source buffers may be read-only views of device arrays
        return torch.from_numpy(np.array(x, dtype, copy=True)).to(device)

    return Column(put(data), put(validity, bool),
                  None if lengths is None else put(lengths, np.int32), dt)


def column_to_arrays(col: Column) -> Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray],
                                           dtypes.DataType]:
    """(data, validity, lengths, dtype) of a Column, on the host."""
    lengths = None if col.lengths is None else col.lengths.cpu().numpy()
    return (col.data.cpu().numpy(), col.validity.cpu().numpy(), lengths,
            col.dtype)


ShardArrays = List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                         dtypes.DataType]]


def table_shards_to_arrays(t) -> Tuple[Tuple[str, ...], List[ShardArrays],
                                       np.ndarray]:
    """(names, per shard the ``column_to_arrays`` of every column, per-shard
    row counts) of a ``Table``, on the host, padding included."""
    return (t.names, [[column_to_arrays(c) for c in cols]
                      for cols in t.shards], t._local_row_counts())


def table_from_shard_arrays(names: Sequence[str],
                            shards: Sequence[ShardArrays], counts, ctx):
    """The inverse of ``table_shards_to_arrays``: shard ``i`` on
    ``ctx.devices[i]``, holding exactly the given buffers."""
    from .table import Table

    if len(shards) != len(ctx.devices):
        raise CylonError(Code.Invalid, f"{len(shards)} shards for a context "
                         f"of {len(ctx.devices)} shards per process")
    cols = tuple(tuple(column_from_arrays(*arrs, device=dev) for arrs in shard)
                 for shard, dev in zip(shards, ctx.devices))
    cnts = tuple(torch.tensor(int(n), dtype=torch.int32, device=dev)
                 for n, dev in zip(counts, ctx.devices))
    return Table(cols, cnts, tuple(names), ctx)
