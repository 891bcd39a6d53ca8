"""TPC-H Q3 — shipping-priority, the port's twin of
``examples/tpch_q3.py``: the classic 3-way join + filter + groupby +
top-k ordering (customer ⋈ orders ⋈ lineitem, BUILDING segment,
orderdate < 1995-03-15 < shipdate, group by orderkey/orderdate/
shippriority, revenue desc, limit 10).

Exercises the multi-key groupby and descending multi-column sort after a
join chain — the reference analog is DistributedJoin (table.cpp:459-489)
chained into DistributedHashGroupBy (groupby/groupby.cpp:23-73) and
DistributedSort (table.cpp:313-356).
"""
from __future__ import annotations

import time

import numpy as np

from . import tpch_data
from .util import default_ctx, emit, table_from_arrays

TOP_K = 10


def run(sf: float = 0.01, world: int | None = None, seed: int = 0,
        check: bool = True, device=None) -> dict:
    ctx = default_ctx(world, device)
    rng = np.random.default_rng(seed)
    raw_c = tpch_data.customer(sf, rng, q3_cols=True)
    raw_o = tpch_data.orders(sf, rng, q3_cols=True)
    raw_l = tpch_data.lineitem(sf, rng, q5_keys=True,
                               orders_rows=len(raw_o["o_orderkey"]))
    raw_l.pop("l_suppkey", None)  # Q3 joins on orderkey only

    cust = table_from_arrays(raw_c, ctx)
    orde = table_from_arrays(raw_o, ctx)
    line = table_from_arrays(raw_l, ctx)
    rows = line.row_count + orde.row_count + cust.row_count

    building = tpch_data.MKTSEGMENTS.index("BUILDING")
    t0 = time.perf_counter()
    c = cust.select(lambda r: r.c_mktsegment == building)
    o = orde.select(lambda r: r.o_orderdate < tpch_data.Q3_DATE)
    li = line.select(lambda r: r.l_shipdate > tpch_data.Q3_DATE)
    co = c.distributed_join(o, left_on="c_custkey", right_on="o_custkey")
    col = co.distributed_join(li, left_on="o_orderkey",
                              right_on="l_orderkey")
    col["revenue"] = (col["l_extendedprice"]
                      * (col["l_discount"] * -1.0 + 1.0))
    g = col.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                    {"revenue": ["sum"]})
    # the ORDER BY runs in the engine (multi-key, mixed ascending: the
    # DistributedSort analog this example exists to exercise); only the
    # LIMIT 10 materializes on the host.  l_orderkey tie-breaks both
    # orderings: engine revenue is f32, pandas f64, so near-ties at the
    # top-10 boundary could otherwise swap rank between the two
    ordered = g.distributed_sort(["sum_revenue", "o_orderdate",
                                  "l_orderkey"],
                                 ascending=[False, True, True])
    res = ordered.to_pandas().head(TOP_K).reset_index(drop=True)
    dt = time.perf_counter() - t0

    if check:
        import pandas as pd

        cdf = pd.DataFrame(raw_c)
        odf = pd.DataFrame(raw_o)
        ldf = pd.DataFrame(raw_l)
        cdf = cdf[cdf.c_mktsegment == building]
        odf = odf[odf.o_orderdate < tpch_data.Q3_DATE]
        ldf = ldf[ldf.l_shipdate > tpch_data.Q3_DATE]
        j = (cdf.merge(odf, left_on="c_custkey", right_on="o_custkey")
             .merge(ldf, left_on="o_orderkey", right_on="l_orderkey"))
        j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
        exp = (j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"])
               .revenue.sum().reset_index()
               .sort_values(["revenue", "o_orderdate", "l_orderkey"],
                            ascending=[False, True, True])
               .head(TOP_K).reset_index(drop=True))
        assert len(res) == len(exp), (len(res), len(exp))
        np.testing.assert_array_equal(res["l_orderkey"].to_numpy(),
                                      exp["l_orderkey"].to_numpy())
        np.testing.assert_allclose(res["sum_revenue"].to_numpy(),
                                   exp["revenue"].to_numpy(), rtol=1e-4)

    return emit("tpch_q3", rows=rows, seconds=dt, rows_per_sec=rows / dt,
                world=ctx.GetWorldSize(), top=len(res), sf=sf)


if __name__ == "__main__":
    import sys

    run(sf=float(sys.argv[1]) if len(sys.argv) > 1 else 0.01)
