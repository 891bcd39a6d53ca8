"""Shared helpers for two-table kernels (port of
``cylon_tpu/ops/common.py``)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..column import Column
from . import keys


def pad_width(c: Column, width: int) -> Column:
    """A string column's byte matrix zero-padded on the right to
    ``width`` (zero padding keeps bytewise order); others as they are."""
    if not c.is_string or c.string_width >= width:
        return c
    extra = torch.zeros((c.capacity, width - c.string_width),
                        dtype=torch.uint8, device=c.device)
    return Column(torch.cat([c.data, extra], dim=1), c.validity, c.lengths,
                  c.dtype)


def widen_strings(a: Column, b: Column) -> Tuple[Column, Column]:
    """Two string columns padded to their common width, so they can be
    concatenated or compared (``cylon_tpu/ops/common.py:13``)."""
    if not a.is_string:
        return a, b
    w = max(a.string_width, b.string_width)
    return pad_width(a, w), pad_width(b, w)


def concat_columns(a: Column, b: Column) -> Column:
    """Stack two columns' buffers (padding and all) into one column of
    capacity cap_a + cap_b; string columns are widened first."""
    a, b = widen_strings(a, b)
    lengths = None
    if a.lengths is not None:
        lengths = torch.cat([a.lengths, b.lengths])
    return Column(torch.cat([a.data, b.data]),
                  torch.cat([a.validity, b.validity]), lengths, a.dtype)


def two_table_padding(cap_a: int, count_a, cap_b: int, count_b,
                      device) -> torch.Tensor:
    """Padding-flag operand for a concatenated pair of tables."""
    idx = torch.arange(cap_a + cap_b, dtype=torch.int32, device=device)
    return torch.where(idx < cap_a, idx >= count_a, (idx - cap_a) >= count_b)


def combined_sorted_runs(cols_a: Sequence[Column], count_a,
                         cols_b: Sequence[Column], count_b,
                         key_a: Sequence[int], key_b: Sequence[int]):
    """Lexsort the union of two tables' key rows and mark the key runs.

    Returns (perm, sorted_ops, new_group, is_run_end, live_sorted) over
    the cap_a + cap_b sorted positions; ``perm[p] < cap_a`` marks table-A
    rows, and padding rows of either table sort last, so ``live_sorted``
    is a prefix mask."""
    cap_a = cols_a[0].capacity
    cap_b = cols_b[0].capacity
    n = cap_a + cap_b
    dev = cols_a[0].device
    operands: List[torch.Tensor] = [
        two_table_padding(cap_a, count_a, cap_b, count_b, dev)]
    for ia, ib in zip(key_a, key_b):
        operands.extend(keys.column_operands(
            concat_columns(cols_a[ia], cols_b[ib])))
    perm, sorted_ops = keys.lexsort_indices(operands, n)
    new_group = ~keys.rows_equal_adjacent(sorted_ops)
    is_run_end = torch.cat([new_group[1:],
                            torch.ones(1, dtype=torch.bool, device=dev)])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    live_sorted = pos < (count_a + count_b)
    return perm, sorted_ops, new_group, is_run_end, live_sorted
