"""BASELINE config 4 — TPC-H Q5, the port's twin of
``examples/tpch_q5.py``: local-supplier-volume multi-way join + sort
(customer ⋈ orders ⋈ lineitem ⋈ supplier ⋈ nation ⋈ region, region =
ASIA, orderdate in [1994, 1995), group by nation, revenue desc).

Exercises the deepest relational pipeline in the framework: four
distributed joins, a cross-table equality filter
(c_nationkey == s_nationkey), two dimension joins, a groupby and a sort —
the reference analog is DistributedJoin chained per table.cpp:459-489.
Three realizations: eager per-op calls (``run``), the logical planner
(``run_plan``, ``pipeline.tpch_q5_plan``) and the out-of-core engine on
one card (``run_ooc``).

``run_ooc`` takes ``raw`` (the six tables as ``draw`` returns them) and
``golden`` (``_pandas_golden``'s frame) to reuse data already drawn for
the same ``sf`` and ``seed``.
"""
from __future__ import annotations

import time

import numpy as np

from .. import config, pipeline
from ..obs import metrics as obs_metrics
from . import tpch_data
from .util import default_ctx, emit, table_from_arrays


def draw(sf: float, seed: int = 0) -> dict:
    """Q5's six tables, keyed ``c o l s n r``, drawn in the reference's
    order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    raw = {"c": tpch_data.customer(sf, rng), "o": tpch_data.orders(sf, rng)}
    raw["l"] = tpch_data.lineitem(sf, rng, q5_keys=True,
                                  orders_rows=len(raw["o"]["o_orderkey"]))
    raw["s"] = tpch_data.supplier(sf, rng)
    raw["n"] = tpch_data.nation()
    raw["r"] = tpch_data.region()
    return raw


def _check(res, exp) -> None:
    """Nation for nation against the pandas golden, rtol 1e-4."""
    assert len(res) == len(exp), (len(res), len(exp))
    got = dict(zip(res["n_name"], res["sum_revenue"]))
    for name, rev in zip(exp["n_name"], exp["revenue"]):
        np.testing.assert_allclose(got[name], rev, rtol=1e-4)


def run(sf: float = 0.01, world: int | None = None, seed: int = 0,
        check: bool = True, device=None) -> dict:
    ctx = default_ctx(world, device)
    raw = draw(sf, seed)

    cust = table_from_arrays(raw["c"], ctx)
    orde = table_from_arrays(raw["o"], ctx)
    line = table_from_arrays(raw["l"], ctx)
    supp = table_from_arrays(raw["s"], ctx)
    nati = table_from_arrays(raw["n"], ctx)
    regi = table_from_arrays(raw["r"], ctx)
    rows = line.row_count + orde.row_count + cust.row_count

    t0 = time.perf_counter()
    o = orde.select(lambda r: (r.o_orderdate >= tpch_data.Q5_LO)
                    & (r.o_orderdate < tpch_data.Q5_HI))
    co = cust.distributed_join(o, left_on="c_custkey", right_on="o_custkey")
    col = co.distributed_join(line, left_on="o_orderkey",
                              right_on="l_orderkey")
    cols_ = col.distributed_join(supp, left_on="l_suppkey",
                                 right_on="s_suppkey")
    # Q5's local-supplier condition: customer and supplier share a nation
    loc = cols_.select(lambda r: r.c_nationkey == r.s_nationkey)
    ln = loc.distributed_join(nati, left_on="c_nationkey",
                              right_on="n_nationkey")
    lnr = ln.distributed_join(regi, left_on="n_regionkey",
                              right_on="r_regionkey")
    asia_key = tpch_data.REGIONS.index("ASIA")
    asia = lnr.select(lambda r: r.r_regionkey == asia_key)
    asia["revenue"] = (asia["l_extendedprice"]
                       * (asia["l_discount"] * -1.0 + 1.0))
    g = asia.groupby("n_name", {"revenue": ["sum"]})
    res = g.to_pandas().sort_values("sum_revenue", ascending=False)
    dt = time.perf_counter() - t0

    if check:
        _check(res, _pandas_golden(*(raw[k] for k in "colsnr"), asia_key))

    return emit("tpch_q5", rows=rows, seconds=dt, rows_per_sec=rows / dt,
                world=ctx.GetWorldSize(), nations=len(res), sf=sf)


def run_plan(sf: float = 0.01, world: int | None = None, seed: int = 0,
             check: bool = True, compare_eager: bool = False,
             device=None) -> dict:
    """Q5 through the logical planner: the same 6-table pipeline built
    lazily with ``Table.plan()`` (``pipeline.tpch_q5_plan``).  The
    nation→region join is ordered last and the group keys include
    n_regionkey, so the rows reaching the group-by are already
    hash-partitioned on a subset of its keys: the planner elides the
    final shuffle and fuses the region probe + ASIA filter + revenue
    derive + local aggregate into one shard body.  n_name tie-breaks the
    ordering (engine f32 vs pandas f64 revenue)."""
    ctx = default_ctx(world, device)
    raw = draw(sf, seed)
    tables = {k: table_from_arrays(v, ctx) for k, v in raw.items()}
    rows = sum(tables[k].row_count for k in "loc")
    asia_key = tpch_data.REGIONS.index("ASIA")

    plan = pipeline.tpch_q5_plan(*(tables[k] for k in "colsnr"))

    elided0 = obs_metrics.counter_value("plan.shuffles_elided")
    t0 = time.perf_counter()
    res = plan.execute().to_pandas().reset_index(drop=True)
    dt = time.perf_counter() - t0
    elided = int(obs_metrics.counter_value("plan.shuffles_elided")
                 - elided0)

    eager_identical = None
    if compare_eager:
        with config.knob_env(CYLON_TPU_PLAN="0"):
            eager = plan.execute().to_pandas().reset_index(drop=True)
        for c in res.columns:
            np.testing.assert_array_equal(
                res[c].to_numpy(), eager[c].to_numpy(),
                err_msg=f"planner vs eager mismatch in {c}")
        eager_identical = True

    if check:
        _check(res, _pandas_golden(*(raw[k] for k in "colsnr"), asia_key))

    rec = emit("tpch_q5_plan", rows=rows, seconds=dt,
               rows_per_sec=rows / dt, world=ctx.GetWorldSize(),
               nations=len(res), sf=sf, shuffles_elided=elided)
    if eager_identical is not None:
        rec["eager_bit_identical"] = eager_identical
    return rec


def run_ooc(sf: float = 1.0, passes: int | None = None, seed: int = 0,
            check: bool = False, device=None, raw: dict | None = None,
            golden=None) -> dict:
    """Q5 at scales past one card's memory: the same five-way join +
    group-by chained through the out-of-core engine
    (``exec.chunked_join``), with column pruning between stages so host
    intermediates stay narrow.  The final dimension join + group-by fuse
    into one ``chunked_join_groupby_tables`` call (partial/final combine:
    group key n_name does not pin the partition key).  BASELINE config 4
    pipeline at any SF on a single card (``device``, default the CUDA
    card, passed to every engine call as its context)."""
    import pandas as pd

    from ..exec import chunked_join, chunked_join_groupby_tables

    ctx = default_ctx(1, device)
    if passes is None:
        # lineitem is ~6M rows/SF: ~2^24 rows/side per pass
        passes = max(1, int(np.ceil(sf * 6_000_000 / (1 << 24))))
    raw = raw or draw(sf, seed)
    raw_c, raw_o, raw_l, raw_s, raw_n = (raw[k] for k in "colsn")
    rows = (len(raw_l["l_orderkey"]) + len(raw_o["o_orderkey"])
            + len(raw_c["c_custkey"]))

    t0 = time.perf_counter()
    # host-side date filter (the reference pushes the filter below the
    # join too)
    sel = ((raw_o["o_orderdate"] >= tpch_data.Q5_LO)
           & (raw_o["o_orderdate"] < tpch_data.Q5_HI))
    orders_f = {"o_orderkey": raw_o["o_orderkey"][sel],
                "o_custkey": raw_o["o_custkey"][sel]}
    cust = {"c_custkey": raw_c["c_custkey"],
            "c_nationkey": raw_c["c_nationkey"]}
    r1, _ = chunked_join(cust, orders_f, left_on="c_custkey",
                         right_on="o_custkey", how="inner", passes=passes,
                         ctx=ctx)
    r1 = {"c_nationkey": r1["c_nationkey"], "o_orderkey": r1["o_orderkey"]}

    line = {"l_orderkey": raw_l["l_orderkey"],
            "l_suppkey": raw_l["l_suppkey"],
            "l_extendedprice": raw_l["l_extendedprice"],
            "l_discount": raw_l["l_discount"]}
    r2, _ = chunked_join(r1, line, left_on="o_orderkey",
                         right_on="l_orderkey", how="inner", passes=passes,
                         ctx=ctx)
    r2 = {k: r2[k] for k in ("c_nationkey", "l_suppkey",
                             "l_extendedprice", "l_discount")}

    supp = {"s_suppkey": raw_s["s_suppkey"],
            "s_nationkey": raw_s["s_nationkey"]}
    r3, _ = chunked_join(r2, supp, left_on="l_suppkey",
                         right_on="s_suppkey", how="inner", passes=passes,
                         ctx=ctx)
    keep = np.asarray(r3["c_nationkey"]) == np.asarray(r3["s_nationkey"])
    revenue = (np.asarray(r3["l_extendedprice"])[keep]
               * (1.0 - np.asarray(r3["l_discount"])[keep]))
    fact = {"c_nationkey": np.asarray(r3["c_nationkey"])[keep],
            "revenue": revenue}

    # ASIA nations only (region pre-joined host-side: 25x5 rows)
    asia_key = tpch_data.REGIONS.index("ASIA")
    nsel = raw_n["n_regionkey"] == asia_key
    nation_asia = {"n_nationkey": raw_n["n_nationkey"][nsel],
                   "n_name": raw_n["n_name"][nsel]}
    res, stats = chunked_join_groupby_tables(
        fact, nation_asia, left_on="c_nationkey", right_on="n_nationkey",
        how="inner", group_by="n_name", agg={"revenue": ["sum"]},
        passes=min(passes, 4), ctx=ctx)
    out = pd.DataFrame({"n_name": res["n_name"],
                        "sum_revenue": np.asarray(res["sum_revenue"],
                                                  np.float64)})
    out = out.sort_values("sum_revenue", ascending=False)
    dt = time.perf_counter() - t0

    if check:
        if golden is None:
            golden = _pandas_golden(*(raw[k] for k in "colsnr"), asia_key)
        _check(out, golden)
    return emit("tpch_q5_ooc", rows=rows, seconds=dt, rows_per_sec=rows / dt,
                passes=passes, nations=len(out), sf=sf)


def _pandas_golden(raw_c, raw_o, raw_l, raw_s, raw_n, raw_r, asia_key):
    import pandas as pd

    c = pd.DataFrame(raw_c)
    odf = pd.DataFrame(raw_o)
    l = pd.DataFrame(raw_l)  # noqa: E741 — the reference's name
    s = pd.DataFrame(raw_s)
    n = pd.DataFrame(raw_n)
    r = pd.DataFrame(raw_r)
    odf = odf[(odf.o_orderdate >= tpch_data.Q5_LO)
              & (odf.o_orderdate < tpch_data.Q5_HI)]
    j = (c.merge(odf, left_on="c_custkey", right_on="o_custkey")
         .merge(l, left_on="o_orderkey", right_on="l_orderkey")
         .merge(s, left_on="l_suppkey", right_on="s_suppkey"))
    j = j[j.c_nationkey == j.s_nationkey]
    j = (j.merge(n, left_on="c_nationkey", right_on="n_nationkey")
         .merge(r, left_on="n_regionkey", right_on="r_regionkey"))
    j = j[j.r_regionkey == asia_key]
    j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
    return (j.groupby("n_name").revenue.sum()
            .sort_values(ascending=False).reset_index())


if __name__ == "__main__":
    import sys

    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 0.01
    run(sf)
