"""The single-chip main path: key-grouped inner join -> pipeline group-by.

The twin of the JAX package's benchmark program (``bench.py:134
make_bench_pipeline``): an inner sort-merge join with ``key_grouped=True``
and ``project=(0, 1, 3)`` feeding a boundary-scan group-by with SUM of the
left value and MEAN of the right value, on ``bench.py:118 _make_data``
tables, sized by the exact join count rounded by ``cap_round`` (the copy
of ``cylon_tpu/table.py:1238 _cap_round``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import column
from .column import Column
from .config import JoinType
from .ops import groupby, join

SEED = 12345


def make_data(rows: int, seed: int = SEED):
    """(lk, lv, rk, rv) numpy arrays: int32 keys drawn from [0, rows) and
    float32 values, ~1:1 join; identical to ``bench.py:118 _make_data``
    at the same seed."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, rows, rows).astype(np.int32)
    lv = rng.random(rows).astype(np.float32)
    rk = rng.integers(0, rows, rows).astype(np.int32)
    rv = rng.random(rows).astype(np.float32)
    return lk, lv, rk, rv


def cap_round(n: int) -> int:
    """Round a row count up to a 3-bit-mantissa capacity (at most 8 sizes
    per octave)."""
    if n <= 16:
        return 16
    g = 1 << ((n - 1).bit_length() - 3)
    return -(-n // g) * g


def tables(lk, lv, rk, rv, device=None):
    """(cols_l, count_l, cols_r, count_r) on ``device`` (default: the CUDA
    card); counts are 0-d int32 tensors on the same device."""
    device = column.resolve_device(device)
    cols_l = (column.from_numpy(lk, device=device),
              column.from_numpy(lv, device=device))
    cols_r = (column.from_numpy(rk, device=device),
              column.from_numpy(rv, device=device))
    cnt_l = torch.tensor(len(lk), dtype=torch.int32, device=device)
    cnt_r = torch.tensor(len(rk), dtype=torch.int32, device=device)
    return cols_l, cnt_l, cols_r, cnt_r


def join_count(cols_l, cnt_l, cols_r, cnt_r) -> int:
    """Exact inner-join row count (synchronises with the device)."""
    return int(join.join_row_count(cols_l, cnt_l, cols_r, cnt_r, (0,), (0,),
                                   JoinType.INNER))


def join_groupby(cols_l, cnt_l, cols_r, cnt_r, out_cap: int
                 ) -> Tuple[Tuple[Column, ...], torch.Tensor, torch.Tensor]:
    """(group columns (key, SUM(lv), MEAN(rv)), group count, join count);
    the counts are 0-d tensors."""
    joined, jm = join.join_gather(cols_l, cnt_l, cols_r, cnt_r, (0,), (0,),
                                  JoinType.INNER, out_cap, "sort",
                                  key_grouped=True, project=(0, 1, 3))
    gcols, g = groupby.pipeline_groupby(
        joined, jm, (0,), ((1, groupby.AggOp.SUM), (2, groupby.AggOp.MEAN)),
        0)
    return gcols, g, jm
