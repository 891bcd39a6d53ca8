"""Scalar column aggregates.

The port of ``cylon_tpu/ops/aggregates.py`` (reference: compute/
aggregates.cpp:30-156, a local reduction then an allreduce of the scalar).
The local reduction is a masked torch reduce; the distributed combine is
``parallel/ops.py::distributed_scalar_agg``.
"""
from __future__ import annotations

import enum

import torch

from .. import precision
from ..column import Column
from . import compact, keys


class ReduceOp(enum.IntEnum):
    """reference: net/comm_operations.hpp:26-30."""

    SUM = 0
    MIN = 1
    MAX = 2
    PROD = 3
    COUNT = 4


def scalar_agg(col: Column, count, op: ReduceOp):
    """(value, valid_count), 0-d tensors, over one column's live non-null
    rows.  The count is int32 in narrow mode and int64 in wide; an empty
    column gives SUM 0, PROD 1 and the dtype's extremes for MIN/MAX."""
    op = ReduceOp(op)
    if col.is_string and op != ReduceOp.COUNT:
        raise TypeError("scalar aggregation unsupported on string columns")
    dev = col.device
    mask = col.validity & compact.live_mask(col.capacity, count, dev)
    n = mask.sum(dtype=precision.count_acc())
    n = n if precision.narrow(dev) else n.to(torch.int64)
    if op == ReduceOp.COUNT:
        return n, n
    data = col.data
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    if op in (ReduceOp.SUM, ReduceOp.PROD):
        acc = data.to(precision.float_acc(dev) if data.is_floating_point()
                      else precision.int_acc())
        if op == ReduceOp.SUM:
            return torch.where(mask, acc, torch.zeros((), dtype=acc.dtype,
                                                      device=dev)).sum(), n
        return torch.where(mask, acc, torch.ones((), dtype=acc.dtype,
                                                 device=dev)).prod(), n
    data, restore = keys.signed_carrier(data)
    if data.is_floating_point():
        lo, hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(data.dtype)
        lo, hi = info.min, info.max
    if op == ReduceOp.MIN:
        fill = torch.full((), hi, dtype=data.dtype, device=dev)
        return restore(torch.where(mask, data, fill).min()), n
    fill = torch.full((), lo, dtype=data.dtype, device=dev)
    return restore(torch.where(mask, data, fill).max()), n
