"""The main paths on ``bench.py:118 _make_data`` tables.

- Single chip (``tables``, ``join_count``, ``join_groupby``): the twin of
  the JAX package's benchmark program (``bench.py:134
  make_bench_pipeline``), an inner sort-merge join with
  ``key_grouped=True`` and ``project=(0, 1, 3)`` feeding a boundary-scan
  group-by with SUM of the left value and MEAN of the right value, sized by
  the exact join count rounded by ``cap_round`` (the copy of
  ``cylon_tpu/table.py:1238 _cap_round``).
- Distributed (``distributed_tables``, ``distributed_join_groupby``): the
  repo's end-to-end drive on a mesh of shards, ``Table.distributed_join``
  on the key then the two-phase ``groupby`` with the same SUM and MEAN.
- Relational operators (``operators`` on ``local_tables``,
  ``distributed_operators`` on ``distributed_tables``): sort, unique, the
  set ops, select / filter, scalar aggregates and the pipeline group-by on
  one shard; range-partitioned sort, hash-shuffled unique and set ops and
  allreduced aggregates on a mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import column
from .column import Column
from .config import JoinType
from .context import CylonContext
from .ops import groupby, join
from .table import Table, cap_round  # noqa: F401  (cap_round re-exported)

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


def distributed_tables(ctx, lk, lv, rk, rv) -> Tuple[Table, Table]:
    """The two tables ``(k, lv)`` and ``(k, rv)``, split over ``ctx``'s
    shards."""
    return (Table.from_numpy(["k", "lv"], [lk, lv], ctx=ctx),
            Table.from_numpy(["k", "rv"], [rk, rv], ctx=ctx))


def distributed_join_groupby(left: Table, right: Table
                             ) -> Tuple[Table, Table]:
    """(groups, joined): ``left.distributed_join(right, on="k")``, then
    its group-by on the left key with SUM(lv) and MEAN(rv); the groups'
    columns are ``l_k``, ``sum_lv``, ``mean_rv``."""
    joined = left.distributed_join(right, on="k")
    groups = joined.groupby("l_k", {"lv": "sum", "rv": "mean"})
    return groups, joined


def local_tables(cols_l, cnt_l, cols_r, cnt_r) -> Tuple[Table, Table]:
    """``tables``' columns wrapped as one-shard Tables ``(k, lv)`` and
    ``(k, rv)`` on their device, with no copy."""
    ctx = CylonContext.Init(cols_l[0].device)
    return (Table(((tuple(cols_l)),), (cnt_l,), ("k", "lv"), ctx),
            Table(((tuple(cols_r)),), (cnt_r,), ("k", "rv"), ctx))


def operator_calls(left: Table, right: Table) -> Dict[str, Callable]:
    """The single-chip relational operators on ``(k, lv)`` / ``(k, rv)``
    tables, one zero-argument call each, in the order ``operators`` runs
    them.  ``groupby_pipeline`` groups the left table sorted by ``k``
    (sorted once, here)."""
    keys_l, keys_r = left.project("k"), right.project("k")
    by_key = left.sort("k")
    return {
        "sort": lambda: left.sort("k"),
        "sort_k_desc_lv": lambda: left.sort(["k", "lv"],
                                            ascending=[False, True]),
        "unique_first": lambda: left.unique("k", keep="first"),
        "unique_last": lambda: left.unique("k", keep="last"),
        "union": lambda: keys_l.union(keys_r),
        "intersect": lambda: keys_l.intersect(keys_r),
        "subtract": lambda: keys_l.subtract(keys_r),
        "union_rows": lambda: left.union(right),
        "select": lambda: left.select(lambda e: e["lv"] > 0.5),
        "filter": lambda: left.filter(left["lv"] > 0.5),
        "sum": lambda: left.sum("lv"),
        "min": lambda: left.min("k"),
        "max": lambda: left.max("k"),
        "count": lambda: left.count("k"),
        "groupby_pipeline": lambda: by_key.groupby(
            "k", {"lv": "sum"}, groupby_type="pipeline"),
    }


def operators(left: Table, right: Table) -> Dict[str, object]:
    """Every operator of ``operator_calls``, run once: name -> its result
    (a Table, or a 0-d tensor for the scalar aggregates)."""
    return {name: fn() for name, fn in operator_calls(left, right).items()}


def distributed_operator_calls(left: Table, right: Table
                               ) -> Dict[str, Callable]:
    """The distributed operators on tables split over a mesh: a range-
    partitioned sort, a hash-shuffled unique and set ops, and scalar
    aggregates with an allreduce."""
    keys_l, keys_r = left.project("k"), right.project("k")
    return {
        "distributed_sort": lambda: left.distributed_sort("k"),
        "distributed_unique": lambda: left.distributed_unique("k"),
        "distributed_union": lambda: keys_l.distributed_union(keys_r),
        "distributed_intersect":
            lambda: keys_l.distributed_intersect(keys_r),
        "distributed_subtract": lambda: keys_l.distributed_subtract(keys_r),
        "sum": lambda: left.sum("lv"),
        "min": lambda: left.min("k"),
    }


def distributed_operators(left: Table, right: Table) -> Dict[str, object]:
    """Every operator of ``distributed_operator_calls``, run once."""
    return {name: fn() for name, fn in
            distributed_operator_calls(left, right).items()}
