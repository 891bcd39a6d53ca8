"""Local set operations: union / intersect / subtract, distinct.

The port of ``cylon_tpu/ops/setops.py`` (reference: table.cpp:522-734,
hash sets of (table id, row) over all columns).  One lexsort of both
tables' rows (``common.combined_sorted_runs``); per-run membership
counts are prefix arithmetic (two ``segments.run_extents`` calls, each
three ``scan_1d`` launches in narrow mode); each run's first row is its
leader, and the kept leaders compact to the front in sorted key order.
Union keeps one row of every distinct row, intersect the rows in both
tables, subtract the rows of A absent from B.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..column import Column
from . import common, compact, segments

OPS = ("union", "intersect", "subtract")


def set_op(cols_a: Tuple[Column, ...], count_a,
           cols_b: Tuple[Column, ...], count_b, op: str, out_capacity: int):
    """``op`` in ``OPS``; the schemas must match.  Returns (columns,
    row_count) at capacity ``out_capacity``; rows past the count are zero
    and null."""
    if op not in OPS:
        raise ValueError(op)
    cap_a = cols_a[0].capacity
    n = cap_a + cols_b[0].capacity
    dev = cols_a[0].device
    key = tuple(range(len(cols_a)))
    perm, _, new_group, is_run_end, live_sorted = common.combined_sorted_runs(
        cols_a, count_a, cols_b, count_b, key, key)
    from_a = perm < cap_a

    _, a_in_run = segments.run_extents(live_sorted & from_a, new_group,
                                       is_run_end)
    _, b_in_run = segments.run_extents(live_sorted & ~from_a, new_group,
                                       is_run_end)

    keep = new_group & live_sorted
    if op == "intersect":
        keep = keep & (a_in_run > 0) & (b_in_run > 0)
    elif op == "subtract":
        keep = keep & (a_in_run > 0) & (b_in_run == 0)

    perm_keep, m = compact.compact_indices(keep)
    out_live = compact.live_mask(out_capacity, m, dev)
    slot = torch.arange(out_capacity, dtype=perm_keep.dtype, device=dev) % n
    sel = perm[perm_keep[slot]]
    out = []
    for a, b in zip(cols_a, cols_b):
        c = common.concat_columns(a, b).take(sel)
        # rows past the count are zeroed, bytes and lengths included (null
        # rows keep their bytes), as cylon_tpu/ops/setops.py:64-67
        rows = out_live[:, None] if c.data.ndim == 2 else out_live
        lengths = None if c.lengths is None else torch.where(
            out_live, c.lengths, torch.zeros((), dtype=c.lengths.dtype,
                                             device=dev))
        out.append(Column(torch.where(rows, c.data, torch.zeros(
            (), dtype=c.data.dtype, device=dev)), c.validity & out_live,
            lengths, c.dtype))
    return tuple(out), m
