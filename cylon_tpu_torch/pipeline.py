"""The main paths on ``bench.py:118 _make_data`` tables.

- Single chip (``tables``, ``join_count``, ``join_groupby``): the twin of
  the JAX package's benchmark program (``bench.py:134
  make_bench_pipeline(out_cap, algo)``), an inner join (sort-merge, or
  hash with ``algo="hash"``) with ``key_grouped=True`` and
  ``project=(0, 1, 3)`` feeding a boundary-scan group-by with SUM of the
  left value and MEAN of the right value, sized by the exact join count
  rounded by ``cap_round`` (the copy of ``cylon_tpu/table.py:1238
  _cap_round``).
- Out of core (``out_of_core_join_groupby``): the same join -> SUM/MEAN
  group-by through the key-domain passes of ``exec.chunked_join_groupby``,
  for inputs past the card's memory.
- The rest of the out-of-core rung on the same data
  (``out_of_core_groupby``, ``out_of_core_unique``, ``out_of_core_sort``,
  ``out_of_core_repartition``: the standalone ``exec`` operators on the
  ``(k, v)`` table; ``out_of_core_distributed_join_groupby``: the
  out-of-core main path with every pass sharded over a mesh ``ctx``).
- Distributed (``distributed_tables``, ``distributed_join_groupby``): the
  repo's end-to-end drive on a mesh of shards, ``Table.distributed_join``
  on the key then the two-phase ``groupby`` with the same SUM and MEAN.
- Relational operators (``operators`` on ``local_tables``,
  ``distributed_operators`` on ``distributed_tables``): sort, unique, the
  set ops, select / filter, scalar aggregates and the pipeline group-by on
  one shard; range-partitioned sort, hash-shuffled unique and set ops and
  allreduced aggregates on a mesh.
- String keys (``string_tables``, ``string_join_groupby``): the same data
  with each int key ``k`` rendered as TPC-H's ``c_name``,
  ``"Customer#%09d" % k`` (``customer_names``), joined on that string and
  grouped by it, on one shard or a mesh.  Zero-padded digits keep the int
  keys' order and groups.
- TPC-H Q1 (``lineitem``, ``lineitem_table``, ``tpch_q1``): the lineitem
  columns ``examples/tpch_data.py:41`` draws, with ``l_returnflag`` and
  ``l_linestatus`` as CHAR(1) byte columns, and the query as
  ``examples/tpch_q1.py:28-39`` writes it.
- TPC-H Q10 and Q5 through the query planner (``tpch_q10_plan``,
  ``tpch_q5_plan``): twins of ``examples/tpch_q10.py:33 build_plan`` and
  the plan of ``examples/tpch_q5.py:92 run_plan``, over tables of the
  columns ``examples/tpch_data.py`` draws (the caller builds them).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import column
from . import exec as exec_mod
from .column import DEFAULT_STRING_WIDTH, Column
from .config import JoinType
from .context import CylonContext
from .obs import spans as obs_spans
from .ops import groupby, join
from .table import Table, _shard_plan, cap_round  # noqa: F401

SEED = 12345
NAME_PREFIX = b"Customer#"  # TPC-H c_name: "Customer#" + 9 digits
NAME_DIGITS = 9
NAME_LENGTH = len(NAME_PREFIX) + NAME_DIGITS


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


def join_count(cols_l, cnt_l, cols_r, cnt_r, algo: str = "sort") -> int:
    """Exact inner-join row count (synchronises with the device)."""
    return int(obs_spans.host_read(join.join_row_count(
        cols_l, cnt_l, cols_r, cnt_r, (0,), (0,), JoinType.INNER, algo),
        "join_count"))


def join_groupby(cols_l, cnt_l, cols_r, cnt_r, out_cap: int,
                 algo: str = "sort"
                 ) -> Tuple[Tuple[Column, ...], torch.Tensor, torch.Tensor]:
    """(group columns (key, SUM(lv), MEAN(rv)), group count, join count);
    the counts are 0-d tensors.  ``algo`` is the join's algorithm."""
    joined, jm = join.join_gather(cols_l, cnt_l, cols_r, cnt_r, (0,), (0,),
                                  JoinType.INNER, out_cap, algo,
                                  key_grouped=True, project=(0, 1, 3))
    gcols, g = groupby.pipeline_groupby(
        joined, jm, (0,), ((1, groupby.AggOp.SUM), (2, groupby.AggOp.MEAN)),
        0)
    return gcols, g, jm


def out_of_core_join_groupby(data, passes: int, ctx=None):
    """The main path past the card's memory: ``exec.chunked_join_groupby``
    on ``make_data``'s host arrays ``data`` in ``passes`` key-domain
    passes, on ``ctx``'s device (default: the CUDA card).  Returns
    ({"key", "agg0": SUM(lv), "agg1": MEAN(rv)}, stats)."""
    return exec_mod.chunked_join_groupby(*data, passes, ctx=ctx)


def out_of_core_groupby(keys, values, passes: int, ctx=None):
    """``exec.chunked_groupby`` of the ``(k, v)`` table by ``k`` with
    SUM, MEAN and COUNT of ``v``, in ``passes`` key-domain passes on
    ``ctx`` (default: the CUDA card).  Returns ({"k", "sum_v", "mean_v",
    "count_v"}, stats)."""
    return exec_mod.chunked_groupby({"k": keys, "v": values}, "k",
                                    {"v": ["sum", "mean", "count"]},
                                    passes=passes, ctx=ctx)


def out_of_core_unique(keys, passes: int, ctx=None):
    """``exec.chunked_unique`` of the key column: ({"k"}, stats)."""
    return exec_mod.chunked_unique({"k": keys}, passes=passes, ctx=ctx)


def out_of_core_sort(keys, values, passes: int, ctx=None):
    """``exec.chunked_sort`` of the ``(k, v)`` table by ``k`` ascending:
    ({"k", "v"} in global key order, stats)."""
    return exec_mod.chunked_sort({"k": keys, "v": values}, "k",
                                 passes=passes, ctx=ctx)


def out_of_core_repartition(keys, values, world: int, passes: int,
                            ctx=None, out_dir=None):
    """``exec.chunked_repartition`` of the ``(k, v)`` table into
    ``world`` hash targets of ``k``: (per-target {"k", "v"} frames, or
    None with ``out_dir``; stats)."""
    return exec_mod.chunked_repartition({"k": keys, "v": values}, "k",
                                        world, passes=passes,
                                        out_dir=out_dir, ctx=ctx)


def out_of_core_distributed_join_groupby(data, passes: int, ctx):
    """The out-of-core main path with every pass sharded over the mesh
    ``ctx``: ``exec.chunked_distributed_join_groupby`` on ``make_data``'s
    arrays.  Returns ({"l_k", "sum_a": SUM(lv), "mean_b": MEAN(rv)},
    stats)."""
    return exec_mod.chunked_distributed_join_groupby(*data, passes, ctx)


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


# -- string keys --------------------------------------------------------------

def customer_names(keys: np.ndarray, width: int = DEFAULT_STRING_WIDTH
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8[n, width] byte matrix, int32[n] lengths) of
    ``"Customer#%09d" % k`` for every int key in [0, 10^9), zero-padded,
    built with digit arithmetic: no Python string per row."""
    n = len(keys)
    mat = np.zeros((n, width), np.uint8)
    mat[:, :len(NAME_PREFIX)] = np.frombuffer(NAME_PREFIX, np.uint8)
    k = keys.astype(np.int64)
    for i in range(NAME_DIGITS):  # most significant digit first
        mat[:, len(NAME_PREFIX) + i] = ord("0") + (
            k // 10 ** (NAME_DIGITS - 1 - i)) % 10
    return mat, np.full(n, NAME_LENGTH, np.int32)


def name_keys(col: Column, count) -> torch.Tensor:
    """The int keys of a ``customer_names`` column's first ``count`` rows,
    decoded on the column's device; raises if a row's prefix, length or
    padding is not what ``customer_names`` writes."""
    n = int(count)
    data, lengths = col.data[:n], col.lengths[:n]
    prefix = torch.frombuffer(bytearray(NAME_PREFIX), dtype=torch.uint8)
    if not bool((data[:, :len(NAME_PREFIX)] == prefix.to(data.device)).all()):
        raise AssertionError("a name lacks the 'Customer#' prefix")
    if not (bool((lengths == NAME_LENGTH).all())
            and not bool(data[:, NAME_LENGTH:].any())):
        raise AssertionError("a name is not 18 bytes and zero padding")
    digits = data[:, len(NAME_PREFIX):NAME_LENGTH].to(torch.int64) - ord("0")
    if bool(((digits < 0) | (digits > 9)).any()):
        raise AssertionError("a name holds a non-digit")
    k = torch.zeros(n, dtype=torch.int64, device=data.device)
    for i in range(NAME_DIGITS):
        k = k * 10 + digits[:, i]
    return k


def _sharded_table(ctx: CylonContext, names, arrays) -> Table:
    """A Table of ``ctx``'s shards from host arrays split into contiguous
    chunks (``_shard_plan``); an array is 1-D values, or a (byte matrix,
    lengths) pair for a string column (``column.from_native_buffers``)."""
    first = arrays[0][0] if isinstance(arrays[0], tuple) else arrays[0]
    chunk, counts, cap = _shard_plan(len(first), ctx.GetWorldSize())
    counts = [counts[s] for s in ctx.shard_ids]
    shards = []
    for s, n, dev in zip(ctx.shard_ids, counts, ctx.devices):
        lo = s * chunk
        cols = []
        for a in arrays:
            if isinstance(a, tuple):
                mat, lens = a
                cols.append(column.from_native_buffers(
                    mat[lo:lo + n], None, lens[lo:lo + n], capacity=cap,
                    device=dev))
            else:
                cols.append(column.from_native_buffers(
                    a[lo:lo + n], None, capacity=cap, device=dev))
        shards.append(tuple(cols))
    counts_t = tuple(torch.tensor(n, dtype=torch.int32, device=dev)
                     for n, dev in zip(counts, ctx.devices))
    return Table(tuple(shards), counts_t, tuple(names), ctx)


def string_tables(ctx: CylonContext, lk, lv, rk, rv) -> Tuple[Table, Table]:
    """``(k, lv)`` and ``(k, rv)`` over ``ctx``'s shards, ``k`` the string
    ``customer_names`` of the int keys."""
    return (_sharded_table(ctx, ["k", "lv"], [customer_names(lk), lv]),
            _sharded_table(ctx, ["k", "rv"], [customer_names(rk), rv]))


def string_join_groupby(left: Table, right: Table) -> Tuple[Table, Table]:
    """(groups, joined): the join on the string key (shuffled first when
    the tables have several shards), then its group-by on the left key
    with SUM(lv) and MEAN(rv); the groups' columns are ``l_k``, ``sum_lv``,
    ``mean_rv``, in key order on every shard."""
    joined = left.distributed_join(right, on="k")
    groups = joined.groupby("l_k", {"lv": "sum", "rv": "mean"})
    return groups, joined


# -- TPC-H Q1 -----------------------------------------------------------------

LINEITEM_ROWS_PER_SF = 6_000_000
DATE_LO, DATE_HI = 0, 2556  # day ordinals from 1992-01-01
Q1_CUTOFF = 2190  # 1998-12-01 minus 90 days
RETURNFLAGS = b"ANR"
LINESTATUSES = b"FO"


def lineitem(sf: float, seed: int = 0) -> Dict[str, object]:
    """Q1's lineitem columns at scale factor ``sf``, drawn as
    ``examples/tpch_data.py:41 lineitem`` draws them from
    ``np.random.default_rng(seed)``: the same values, with
    ``l_returnflag`` and ``l_linestatus`` as CHAR(1) ``(byte matrix,
    lengths)`` pairs instead of object arrays."""
    rng = np.random.default_rng(seed)
    n = int(LINEITEM_ROWS_PER_SF * sf)

    def char1(alphabet: bytes, codes):
        mat = np.frombuffer(alphabet, np.uint8)[codes].reshape(n, 1)
        return mat, np.ones(n, np.int32)

    return {
        "l_quantity": rng.integers(1, 51, n).astype(np.float32),
        "l_extendedprice": (rng.random(n, np.float32) * 90000 + 900),
        "l_discount": rng.integers(0, 11, n).astype(np.float32) / 100,
        "l_tax": rng.integers(0, 9, n).astype(np.float32) / 100,
        "l_returnflag": char1(RETURNFLAGS, rng.integers(0, 3, n)),
        "l_linestatus": char1(LINESTATUSES, rng.integers(0, 2, n)),
        "l_shipdate": rng.integers(DATE_LO, DATE_HI, n).astype(np.int32),
    }


def lineitem_table(ctx: CylonContext, data: Dict[str, object]) -> Table:
    return _sharded_table(ctx, list(data), list(data.values()))


Q1_AGGS = {
    "l_quantity": ["sum", "mean"],
    "l_extendedprice": ["sum", "mean"],
    "disc_price": ["sum"],
    "charge": ["sum"],
    "l_discount": ["mean", "count"],
}


def tpch_q1(t: Table) -> Table:
    """TPC-H Q1 as ``examples/tpch_q1.py:28-39`` writes it: the shipdate
    filter, the two derived columns, the 8-aggregate group-by on the two
    flags.  Groups come out in key order on each shard."""
    f = t.select(lambda r: r.l_shipdate <= Q1_CUTOFF)
    f["disc_price"] = (f["l_extendedprice"] * (f["l_discount"] * -1.0 + 1.0))
    f["charge"] = f["disc_price"] * (f["l_tax"] + 1.0)
    return f.groupby(["l_returnflag", "l_linestatus"], Q1_AGGS)


# -- TPC-H Q10 and Q5 through the planner -------------------------------------

#: the queries' constants, as ``examples/tpch_data.py:33-37`` sets them:
#: order-date windows as day ordinals from 1992-01-01, Q10's top-k and
#: Q5's region (ASIA's regionkey)
Q10_DATES = (639, 730)
Q10_TOP = 20
Q5_DATES = (730, 1095)
Q5_REGION = 2


def tpch_q10_plan(cust: Table, orde: Table, line: Table, nati: Table):
    """TPC-H Q10 (returned-item reporting) as a lazy plan, the twin of
    ``examples/tpch_q10.py:33 build_plan``: orders in the window joined
    with returned lineitems, then customer and nation, revenue per
    customer, top ``Q10_TOP``.  After the nation join the rows are placed
    by ``c_nationkey``, which the group keys hold, so the planner elides
    the group-by's shuffle and fuses the last join with the aggregate."""
    from .plan import col, lit

    lo, hi = Q10_DATES
    o = orde.plan().filter((col("o_orderdate") >= lo)
                           & (col("o_orderdate") < hi))
    li = line.plan().filter(col("l_returnflag") == "R")
    return (o.join(li, left_on="o_orderkey", right_on="l_orderkey")
            .join(cust.plan(), left_on="o_custkey", right_on="c_custkey")
            .join(nati.plan(), left_on="c_nationkey",
                  right_on="n_nationkey")
            .with_column("revenue",
                         col("l_extendedprice") * (lit(1.0)
                                                   - col("l_discount")))
            .groupby(["c_custkey", "c_nationkey", "n_name"],
                     {"revenue": ["sum"]})
            .sort(["sum_revenue", "c_custkey"], ascending=[False, True])
            .limit(Q10_TOP))


def tpch_q5_plan(cust: Table, orde: Table, line: Table, supp: Table,
                 nati: Table, regi: Table):
    """TPC-H Q5 (local supplier volume) as a lazy plan, the twin of the
    plan ``examples/tpch_q5.py:92 run_plan`` builds: six tables, the
    region join last, grouped by (n_regionkey, n_name) so the group-by's
    shuffle is elided and fused with the region probe, the ASIA filter
    and the revenue derive; revenue descending, n_name ascending."""
    from .plan import col, lit

    lo, hi = Q5_DATES
    return (cust.plan()
            .join(orde.plan().filter((col("o_orderdate") >= lo)
                                     & (col("o_orderdate") < hi)),
                  left_on="c_custkey", right_on="o_custkey")
            .join(line.plan(), left_on="o_orderkey", right_on="l_orderkey")
            .join(supp.plan(), left_on="l_suppkey", right_on="s_suppkey")
            .filter(col("c_nationkey") == col("s_nationkey"))
            .join(nati.plan(), left_on="c_nationkey",
                  right_on="n_nationkey")
            .join(regi.plan(), left_on="n_regionkey",
                  right_on="r_regionkey")
            .filter(col("r_regionkey") == lit(Q5_REGION))
            .with_column("revenue",
                         col("l_extendedprice") * (lit(1.0)
                                                   - col("l_discount")))
            .groupby(["n_regionkey", "n_name"], {"revenue": ["sum"]})
            .project(["n_name", "sum_revenue"])
            .sort(["sum_revenue", "n_name"], ascending=[False, True]))
