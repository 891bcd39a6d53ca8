"""Element-wise compute over Tables: comparison, math and logical ops,
null handling, membership.

The port of ``cylon_tpu/compute.py`` (reference:
python/pycylon/data/compute.pyx:29-587, table.pyx:1170-2146).  Every op
is shard-local and element-wise: it runs on each shard's columns in turn,
with no exchange.  Padding rows stay zero and null (a string's bytes and
length too) so that downstream kernels' invariants hold.

Scalar operands follow the JAX package's promotion (``jax_enable_x64``
weak types): a Python int keeps an integer column's dtype, a Python float
keeps a float column's dtype and turns an integer or bool column into
float64; a numpy scalar promotes as its dtype.  A string column compares
with a str scalar over its packed big-endian words
(``_string_word_compare``), takes a str in ``fillna`` and ``isin``, and
raises ``Invalid`` for arithmetic, ``neg`` and a compare with a number,
as the reference does.
"""
from __future__ import annotations

import operator
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import dtypes
from .column import Column
from .ops import compact, keys
from .status import Code, CylonError

Scalar = Union[int, float, bool, str, np.generic]

_CMP_OPS = {
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
    "gt": operator.gt, "le": operator.le, "ge": operator.ge,
}
_MATH_OPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv,
}
_LOGICAL_OPS = {"or": operator.or_, "and": operator.and_, "xor": operator.xor}


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


_INT64_MIN = -(1 << 63)


def _scalar_words(value: str, width: int):
    """The big-endian words of ``value``'s utf-8 bytes zero-padded to at
    least ``width``, each as ``word - 2^63``: the signed value whose order
    is the unsigned word's."""
    enc = value.encode("utf-8")
    buf = np.zeros(((max(width, len(enc)) + 7) // 8 * 8,), np.uint8)
    buf[:len(enc)] = np.frombuffer(enc, np.uint8)
    return [int.from_bytes(buf[i:i + 8].tobytes(), "big") + _INT64_MIN
            for i in range(0, len(buf), 8)]


def _string_word_compare(col: Column, value: str,
                         op_name: str) -> torch.Tensor:
    """bool[capacity]: a string column ``op`` a str scalar, compared
    lexicographically over the packed words (``cylon_tpu/compute.py:56``).
    A scalar longer than the column's width compares against zero words
    past it, so an equal prefix orders less-than."""
    words = keys.pack_string_words(col.data)
    swords = _scalar_words(value, col.string_width)
    lt = torch.zeros(col.capacity, dtype=torch.bool, device=col.device)
    gt = torch.zeros_like(lt)
    for i, s in enumerate(swords):
        # the sign flip turns the signed compare into the unsigned one
        w = (words[i] ^ _INT64_MIN if i < len(words)
             else torch.full_like(words[0], _INT64_MIN))
        undecided = ~(lt | gt)
        lt = lt | (undecided & (w < s))
        gt = gt | (undecided & (w > s))
    eq = ~(lt | gt)
    return {"eq": eq, "ne": ~eq, "lt": lt, "gt": gt,
            "le": lt | eq, "ge": gt | eq}[op_name]


def _col_compare(col: Column, other, op_name: str,
                 other_col: Optional[Column]) -> Column:
    op = _CMP_OPS[op_name]
    if other_col is not None:
        if col.is_string != other_col.is_string:
            raise CylonError(Code.Invalid, "cannot compare string and numeric")
        if col.is_string:
            raise CylonError(Code.Invalid,
                             "string column-vs-column compare not supported")
        return _result_col(op(col.data, other_col.data),
                           col.validity & other_col.validity, dtypes.bool_)
    if isinstance(other, str):
        if not col.is_string:
            raise CylonError(Code.Invalid,
                             f"cannot compare {col.dtype} to str")
        return _result_col(_string_word_compare(col, other, op_name),
                           col.validity, dtypes.bool_)
    if col.is_string:
        raise CylonError(Code.Invalid,
                         "cannot compare string column to number")
    a = col.data.to(_scalar_dtype(col.data.dtype, other))
    return _result_col(op(a, other), col.validity, dtypes.bool_)


def _col_math(col: Column, other, op_name: str,
              other_col: Optional[Column]) -> Column:
    if col.is_string or (other_col is not None and other_col.is_string):
        raise CylonError(Code.Invalid, "arithmetic on string columns")
    op = _MATH_OPS[op_name]
    if other_col is not None:
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
            if c.is_string:
                raise CylonError(Code.Invalid, "neg on string column")
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


def _zero_rows(c: Column, validity: torch.Tensor) -> Column:
    """``c`` with ``validity``, and the rows it clears zeroed: data, and a
    string's bytes and length."""
    zero = torch.zeros((), dtype=c.data.dtype, device=c.device)
    if c.is_string:
        return Column(torch.where(validity[:, None], c.data, zero), validity,
                      torch.where(validity, c.lengths,
                                  torch.zeros_like(c.lengths)), c.dtype)
    if c.data.dtype == torch.bool:
        return Column(c.data & validity, validity, None, c.dtype)
    return Column(torch.where(validity, c.data, zero), validity, None,
                  c.dtype)


def fillna(table, fill_value: Scalar):
    """reference: table.pyx:1653-1684.  Only type-compatible columns are
    filled: a str fills string columns, a number the others."""
    shards = []
    for cols in table.shards:
        out = []
        for c in cols:
            if c.is_string != isinstance(fill_value, str):
                out.append(c)
                continue
            if c.is_string:
                enc = np.frombuffer(fill_value.encode("utf-8"), np.uint8)
                width = c.string_width
                if len(enc) > width:
                    raise CylonError(Code.Invalid, "fill string longer than "
                                     f"column width {width}")
                row = np.zeros((width,), np.uint8)
                row[:len(enc)] = enc
                data = torch.where(c.validity[:, None], c.data,
                                   torch.from_numpy(row).to(c.device))
                lengths = torch.where(c.validity, c.lengths,
                                      torch.full((), len(enc),
                                                 dtype=c.lengths.dtype,
                                                 device=c.device))
                out.append(Column(data, torch.ones_like(c.validity), lengths,
                                  c.dtype))
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
            keep = m.data & m.validity
            if other is None:
                out.append(_zero_rows(c, c.validity & keep))
                continue
            if c.is_string:
                raise CylonError(Code.Invalid,
                                 "where(other=) on string column")
            # mask-False rows take `other`, null rows included
            data = torch.where(keep, c.data,
                               torch.full((), other, dtype=c.data.dtype,
                                          device=c.device))
            out.append(_result_col(data, c.validity | ~keep, c.dtype))
        shards.append(out)
    return _mask_padding(_with_shards(table, shards))


def is_in(table, values: Sequence, skip_null: bool = True):
    """Membership test per element (reference: compute.pyx:489-511)."""
    vals = list(values)
    null_in_vals = any(v is None for v in vals)
    nums = [v for v in vals if not isinstance(v, str) and v is not None]
    strs = [v for v in vals if isinstance(v, str)]
    shards = []
    for cols, live in zip(table.shards, _live_masks(table)):
        out = []
        for c in cols:
            if c.is_string:
                hit = torch.zeros_like(c.validity)
                for v in strs:
                    hit = hit | _string_word_compare(c, v, "eq")
            elif nums:
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
        shards.append([_zero_rows(c, c.validity & live) for c in cols])
    return _with_shards(table, shards)


def unique(table):
    """Row-distinct table (reference: compute.pyx:276-284)."""
    return table.unique()


def nunique(table) -> int:
    """Distinct row count (reference: compute.pyx:285-287)."""
    return table.unique().row_count
