"""The program's tables built from the benchmark's tensors, with no copy
through the host: a column is a ``cylon_tpu_torch.column.Column`` over
the tensor itself (every row valid), a table one shard on the tensors'
device."""
from __future__ import annotations

import torch

from cylon_tpu_torch import CylonContext, Table, dtypes
from cylon_tpu_torch.column import Column

_DTYPES = {torch.int32: dtypes.int32, torch.float32: dtypes.float_}


def column(col) -> Column:
    """A Column over a tensor, or over a ``(bytes, lengths)`` string
    pair."""
    if isinstance(col, tuple):
        data, lengths = col
        return Column(data, torch.ones(data.shape[0], dtype=torch.bool,
                                       device=data.device),
                      lengths, dtypes.string)
    return Column(col, torch.ones(col.shape[0], dtype=torch.bool,
                                  device=col.device), None,
                  _DTYPES[col.dtype])


def table(ctx: CylonContext, cols: dict, names=None) -> Table:
    """A one-shard Table of ``cols`` (all of them, or ``names``)."""
    names = tuple(names or cols)
    built = tuple(column(cols[n]) for n in names)
    n = built[0].capacity
    count = torch.tensor(n, dtype=torch.int32, device=built[0].device)
    return Table((built,), (count,), names, ctx)
