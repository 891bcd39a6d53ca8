"""Element-wise compute over Tables: comparison, math and logical ops,
null handling, membership.

The port of ``cylon_tpu/compute.py`` for fixed-width columns (reference:
python/pycylon/data/compute.pyx:29-587, table.pyx:1170-2146).  Every op
is shard-local and element-wise: it runs on each shard's columns in turn,
with no exchange.  Padding rows stay zero and null so that downstream
kernels' invariants hold.

Scalar operands follow the JAX package's promotion (``jax_enable_x64``
weak types): a Python int keeps an integer column's dtype, a Python float
keeps a float column's dtype and turns an integer or bool column into
float64; a numpy scalar promotes as its dtype.  String columns, and the
reference's string compares (``_string_word_compare``), wait for the
strings slice and raise ``NotImplemented``.
"""
from __future__ import annotations

import operator
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import dtypes
from .column import Column
from .ops import compact
from .status import Code, CylonError

Scalar = Union[int, float, bool, np.generic]

_CMP_OPS = {
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
    "gt": operator.gt, "le": operator.le, "ge": operator.ge,
}
_MATH_OPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv,
}
_LOGICAL_OPS = {"or": operator.or_, "and": operator.and_, "xor": operator.xor}


def _no_strings(col: Column, what: str) -> None:
    if col.is_string:
        raise CylonError(Code.NotImplemented,
                         f"{what}: string columns are not ported yet")


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _dtype_of(t: torch.dtype) -> dtypes.DataType:
    return dtypes.from_numpy_dtype(torch.zeros(0, dtype=t).numpy().dtype)


def _scalar_dtype(data: torch.dtype, value) -> torch.dtype:
    """Result dtype of ``column op value`` under the reference's promotion
    rules (see the module docstring)."""
    if isinstance(value, np.generic):
        return torch.promote_types(data, _torch_dtype(np.asarray(value).dtype))
    if isinstance(value, bool):
        return data
    if isinstance(value, int):
        return torch.int64 if data == torch.bool else data
    if isinstance(value, float):
        return data if data.is_floating_point else torch.float64
    raise CylonError(Code.Invalid, f"unsupported scalar {value!r}")


def _result_col(data: torch.Tensor, validity: torch.Tensor,
                dt: dtypes.DataType) -> Column:
    if data.dtype == torch.bool:
        data = data & validity
    else:
        data = torch.where(validity, data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
    return Column(data, validity, None, dt)


def _col_compare(col: Column, other, op_name: str,
                 other_col: Optional[Column]) -> Column:
    op = _CMP_OPS[op_name]
    _no_strings(col, "compare")
    if other_col is not None:
        _no_strings(other_col, "compare")
        return _result_col(op(col.data, other_col.data),
                           col.validity & other_col.validity, dtypes.bool_)
    if isinstance(other, str):
        raise CylonError(Code.Invalid, f"cannot compare {col.dtype} to str")
    a = col.data.to(_scalar_dtype(col.data.dtype, other))
    return _result_col(op(a, other), col.validity, dtypes.bool_)


def _col_math(col: Column, other, op_name: str,
              other_col: Optional[Column]) -> Column:
    _no_strings(col, "arithmetic")
    op = _MATH_OPS[op_name]
    if other_col is not None:
        _no_strings(other_col, "arithmetic")
        validity = col.validity & other_col.validity
        a, b = col.data, other_col.data
        if op_name == "truediv":
            a = a.to(torch.promote_types(a.dtype, torch.float32))
            validity = validity & (b != 0)
            b = torch.where(b == 0, torch.ones((), dtype=b.dtype,
                                               device=b.device), b)
        data = op(a, b)
    else:
        # division guard (reference: compute.pyx:215-239 raises on a zero
        # divisor)
        if op_name == "truediv" and other == 0:
            raise CylonError(Code.Invalid, "division by zero")
        a = col.data
        if op_name == "truediv":
            a = a.to(torch.promote_types(a.dtype, torch.float32))
        data = op(a.to(_scalar_dtype(a.dtype, other)), other)
        validity = col.validity
    return _result_col(data, validity, _dtype_of(data.dtype))


def _live_masks(table):
    """Per shard, bool[capacity]: the rows below the shard's count."""
    return [compact.live_mask(cols[0].capacity, n, n.device)
            for cols, n in zip(table.shards, table.counts)]


def _with_shards(table, shards):
    return table._like(shards, table.counts)


def _broadcast_other(table, other):
    """Per shard, the other table's columns (None on the scalar path)."""
    from .table import Table

    if isinstance(other, Table):
        if len(other.names) != len(table.names):
            raise CylonError(Code.Invalid, "column count mismatch")
        if (other.num_shards != table.num_shards
                or other.shard_capacity != table.shard_capacity):
            raise CylonError(Code.Invalid, "row capacity mismatch")
        return other.shards
    return None


def _elementwise(table, other, op_name: str, kernel: Callable):
    others = _broadcast_other(table, other)
    shards = []
    for s, cols in enumerate(table.shards):
        shards.append([kernel(c, other, op_name,
                              None if others is None else others[s][i])
                       for i, c in enumerate(cols)])
    return _with_shards(table, shards)


# -- public op surface (reference: compute.pyx cpdef functions) -------------

def compare(table, other, op_name: str):
    return _elementwise(table, other, op_name, _col_compare)


def math_op(table, other, op_name: str):
    """reference: compute.pyx:240-274 math_op/add/subtract/multiply/divide."""
    return _elementwise(table, other, op_name, _col_math)


def add(table, value):
    return math_op(table, value, "add")


def subtract(table, value):
    return math_op(table, value, "sub")


def multiply(table, value):
    return math_op(table, value, "mul")


def divide(table, value):
    return math_op(table, value, "truediv")


def _check_bool(table, col: Column, i: int, what: str) -> None:
    if col.dtype.type != dtypes.Type.BOOL:
        raise CylonError(Code.Invalid,
                         f"{what} on non-bool column {table.names[i]}")


def logical_op(table, other, op_name: str):
    """reference: table.pyx:1375-1442 __or__/__and__ (bool tables only)."""
    others = _broadcast_other(table, other)
    op = _LOGICAL_OPS[op_name]
    shards = []
    for s, cols in enumerate(table.shards):
        out = []
        for i, c in enumerate(cols):
            _check_bool(table, c, i, "logical op")
            if others is not None:
                oc = others[s][i]
                if oc.dtype.type != dtypes.Type.BOOL:
                    raise CylonError(Code.Invalid,
                                     "logical op on non-bool column")
                data, validity = op(c.data, oc.data), c.validity & oc.validity
            else:
                data, validity = op(c.data, bool(other)), c.validity
            out.append(_result_col(data, validity, dtypes.bool_))
        shards.append(out)
    return _with_shards(table, shards)


def invert(table):
    """reference: compute.pyx:174-193 (bool tables only)."""
    shards = []
    for cols in table.shards:
        for i, c in enumerate(cols):
            _check_bool(table, c, i, "invert")
        shards.append([_result_col(~c.data, c.validity, dtypes.bool_)
                       for c in cols])
    return _with_shards(table, shards)


def neg(table):
    """reference: compute.pyx:194-214."""
    shards = []
    for cols in table.shards:
        for c in cols:
            _no_strings(c, "neg")
        shards.append([_result_col(-c.data, c.validity, c.dtype)
                       for c in cols])
    return _with_shards(table, shards)


def is_null(table):
    """bool table: True where a value is missing (reference:
    compute.pyx:158-173).  Padding rows read False."""
    shards = []
    for cols, live in zip(table.shards, _live_masks(table)):
        shards.append([Column((~c.validity) & live,
                              torch.ones_like(c.validity), None,
                              dtypes.bool_) for c in cols])
    return _with_shards(table, shards)


def fillna(table, fill_value: Scalar):
    """reference: table.pyx:1653-1684.  Only type-compatible (numeric)
    columns are filled; a string fill value leaves every column as it is."""
    shards = []
    for cols in table.shards:
        out = []
        for c in cols:
            if c.is_string or isinstance(fill_value, str):
                _no_strings(c, "fillna")
                out.append(c)
                continue
            fill = torch.full((), fill_value, dtype=c.data.dtype,
                              device=c.device)
            out.append(Column(torch.where(c.validity, c.data, fill),
                              torch.ones_like(c.validity), None, c.dtype))
        shards.append(out)
    # padding rows of filled columns must stay zero and null
    return _mask_padding(_with_shards(table, shards))


def where(table, condition, other: Optional[Scalar] = None):
    """Keep values where ``condition`` holds, else ``other`` (null when
    ``other`` is None); reference: table.pyx:1685-1735."""
    from .table import Table

    if not isinstance(condition, Table):
        raise CylonError(Code.Invalid, "where() condition must be a Table")
    if len(condition.names) != len(table.names):
        raise CylonError(Code.Invalid, "condition column count mismatch")
    shards = []
    for cols, masks in zip(table.shards, condition.shards):
        out = []
        for c, m in zip(cols, masks):
            if m.dtype.type != dtypes.Type.BOOL:
                raise CylonError(Code.Invalid, "condition must be boolean")
            _no_strings(c, "where")
            keep = m.data & m.validity
            if other is None:
                validity, data = c.validity & keep, c.data
            else:
                # mask-False rows take `other`, null rows included
                validity = c.validity | ~keep
                data = torch.where(keep, c.data,
                                   torch.full((), other, dtype=c.data.dtype,
                                              device=c.device))
            out.append(_result_col(data, validity, c.dtype))
        shards.append(out)
    return _mask_padding(_with_shards(table, shards))


def is_in(table, values: Sequence, skip_null: bool = True):
    """Membership test per element (reference: compute.pyx:489-511)."""
    vals = list(values)
    null_in_vals = any(v is None for v in vals)
    nums = [v for v in vals if not isinstance(v, str) and v is not None]
    shards = []
    for cols, live in zip(table.shards, _live_masks(table)):
        out = []
        for c in cols:
            _no_strings(c, "isin")
            if nums:
                # promoted as jnp.isin promotes, so 2.5 never matches int 2
                arr = np.asarray(nums)
                dt = torch.promote_types(c.data.dtype, _torch_dtype(arr.dtype))
                hit = torch.isin(c.data.to(dt),
                                 torch.from_numpy(arr).to(c.device, dt))
            else:
                hit = torch.zeros_like(c.validity)
            hit = hit & c.validity
            if not skip_null and null_in_vals:
                hit = hit | ~c.validity
            out.append(_result_col(hit & live, torch.ones_like(c.validity),
                                   dtypes.bool_))
        shards.append(out)
    return _with_shards(table, shards)


def drop_na(table, how: str = "any", axis: int = 0):
    """reference: compute.pyx:512-587 drop_na / table.pyx:2028-2099."""
    if how not in ("any", "all"):
        raise CylonError(Code.Invalid, f"bad how={how!r}")
    if axis == 1:
        lives = _live_masks(table)
        nulls = [sum(int((~cols[i].validity & live).sum())
                     for cols, live in zip(table.shards, lives))
                 for i in range(len(table.names))]
        if how == "any":
            keep = [i for i, n in enumerate(nulls) if n == 0]
        else:
            total = table.row_count
            # a zero-row table has no all-null column (pandas keeps all)
            keep = [i for i, n in enumerate(nulls) if total == 0 or n < total]
        return table.project(keep)
    names = table.names

    def predicate(env):
        acc = env.validity(names[0])
        for n in names[1:]:
            m = env.validity(n)
            acc = (acc & m) if how == "any" else (acc | m)
        return acc

    return table.select(predicate)


def _mask_padding(table):
    shards = []
    for cols, live in zip(table.shards, _live_masks(table)):
        out = []
        for c in cols:
            validity = c.validity & live
            if c.data.dtype == torch.bool:
                data = c.data & validity
            else:
                data = torch.where(validity, c.data,
                                   torch.zeros((), dtype=c.data.dtype,
                                               device=c.device))
            out.append(Column(data, validity, None, c.dtype))
        shards.append(out)
    return _with_shards(table, shards)


def unique(table):
    """Row-distinct table (reference: compute.pyx:276-284)."""
    return table.unique()


def nunique(table) -> int:
    """Distinct row count (reference: compute.pyx:285-287)."""
    return table.unique().row_count
