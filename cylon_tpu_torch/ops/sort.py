"""Local multi-column sort.

The port of ``cylon_tpu/ops/sort.py`` (reference: arrow_kernels.hpp
index sorts, util/arrow_utils.cpp SortTable): one lexsort over the key
operands (``keys.lexsort_indices``), then a gather of every column.
Padding rows always sort last, so the live-row count is unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..column import Column
from . import keys


def sort_rows(cols: Tuple[Column, ...], count, by: Sequence[int],
              ascending: Optional[Sequence[bool]] = None,
              nulls_first: bool = True):
    """Sort all columns by the key columns ``by``; returns (columns,
    count)."""
    cap = cols[0].capacity
    if ascending is None:
        ascending = [True] * len(by)
    operands = keys.build_operands([cols[i] for i in by], count, cap,
                                   ascending=ascending,
                                   nulls_first=nulls_first)
    perm, _ = keys.lexsort_indices(operands, cap)
    return tuple(c.take(perm) for c in cols), count
