"""Local unique / drop-duplicates.

The port of ``cylon_tpu/ops/unique.py`` (reference: table.cpp:966-1029,
a hash-set keep filter with 'first'/'last').  The key columns are
lexsorted; the sort embeds the row index (or is stable), so the rows of
one key run keep their original order and the run's first or last
position is the key's first or last occurrence.  The leader flags go
back to row order along the permutation, and a compaction keeps the
original row order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..column import Column
from . import compact, keys


def unique(cols: Tuple[Column, ...], count, key_idx: Tuple[int, ...],
           keep: str = "first"):
    """Returns (columns, new_count): rows with a duplicate key removed,
    keeping the first or last occurrence, original order preserved."""
    if keep not in ("first", "last"):
        raise ValueError(f"keep must be 'first' or 'last', got {keep!r}")
    cap = cols[0].capacity
    dev = cols[0].device
    operands = keys.build_operands([cols[i] for i in key_idx], count, cap)
    perm, sorted_ops = keys.lexsort_indices(operands, cap)
    live_sorted = compact.live_mask(cap, count, dev)

    new_group = ~keys.rows_equal_adjacent(sorted_ops)
    if keep == "first":
        rep_pos = new_group  # run start: the smallest row index in the run
    else:  # run end: the largest row index in the run
        rep_pos = torch.cat([new_group[1:],
                             torch.ones(1, dtype=torch.bool, device=dev)])
    leader = rep_pos & live_sorted  # padding sorts last and is excluded

    keep_mask = compact.inverse_permute(perm, leader)[0]
    perm_keep, m = compact.compact_indices(keep_mask)
    valid = compact.live_mask(cap, m, dev)
    return tuple(c.take(perm_keep, valid_mask=valid) for c in cols), m
