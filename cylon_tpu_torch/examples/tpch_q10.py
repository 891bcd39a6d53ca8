"""TPC-H Q10 — returned-item reporting, the port's twin of
``examples/tpch_q10.py``: the 4-way join (customer ⋈ orders ⋈ lineitem ⋈
nation) that makes shuffle elision non-optional, expressed through the
logical planner (``Table.plan()``) rather than eager per-op calls.

Query shape: orders in [1993-10-01, 1994-01-01), lineitems returned
(l_returnflag = 'R'), revenue per customer with their nation, top 20 by
revenue.  The plan (``pipeline.tpch_q10_plan``) is written orders ⋈
lineitem first so the customer and nation joins keep refining the same
partitioning: after the nation join the rows are hash-partitioned on
c_nationkey, which the group-by keys (c_custkey, c_nationkey, n_name)
contain, so the planner elides the group-by's shuffle and fuses the
final join probe + local aggregate into one shard body.
``compare_eager=True`` re-executes the identical plan with
``CYLON_TPU_PLAN=0`` and asserts the results bit-identical: the planner
changes where rows meet, never what they compute.

Oracle discipline: engine revenue is f32 on the card, pandas f64, so the
ORDER BY carries an explicit c_custkey tie-break in both orderings before
the LIMIT 20 materializes.
"""
from __future__ import annotations

import time

import numpy as np

from .. import config, pipeline
from ..obs import metrics as obs_metrics
from . import tpch_data
from .util import default_ctx, emit, table_from_arrays

TOP_K = pipeline.Q10_TOP
build_plan = pipeline.tpch_q10_plan


def run(sf: float = 0.01, world: int | None = None, seed: int = 0,
        check: bool = True, compare_eager: bool = False,
        explain: bool = False, analyze: bool = False, device=None) -> dict:
    ctx = default_ctx(world, device)
    rng = np.random.default_rng(seed)
    raw_c = tpch_data.customer(sf, rng)
    raw_o = tpch_data.orders(sf, rng)
    raw_l = tpch_data.lineitem(sf, rng, q5_keys=True,
                               orders_rows=len(raw_o["o_orderkey"]))
    raw_l.pop("l_suppkey", None)  # Q10 joins on orderkey only
    raw_n = tpch_data.nation()

    cust = table_from_arrays(raw_c, ctx)
    orde = table_from_arrays(raw_o, ctx)
    line = table_from_arrays(raw_l, ctx)
    nati = table_from_arrays(raw_n, ctx)
    rows = line.row_count + orde.row_count + cust.row_count

    plan = build_plan(cust, orde, line, nati)
    if explain:
        print(plan.explain())
    if analyze:
        # EXPLAIN ANALYZE: one profiled execution with per-node
        # estimate->actual annotations (rows, self time, exchange
        # bytes, shard skew); the timed run below is unprofiled
        print(plan.explain(analyze=True))

    elided0 = obs_metrics.counter_value("plan.shuffles_elided")
    t0 = time.perf_counter()
    res_t = plan.execute()
    res = res_t.to_pandas()
    dt = time.perf_counter() - t0
    elided = int(obs_metrics.counter_value("plan.shuffles_elided")
                 - elided0)

    eager_identical = None
    if compare_eager:
        with config.knob_env(CYLON_TPU_PLAN="0"):
            eager = plan.execute().to_pandas()
        assert list(eager.columns) == list(res.columns)
        for c in res.columns:
            np.testing.assert_array_equal(
                res[c].to_numpy(), eager[c].to_numpy(),
                err_msg=f"planner vs eager mismatch in {c}")
        eager_identical = True

    if check:
        import pandas as pd

        c = pd.DataFrame(raw_c)
        o = pd.DataFrame(raw_o)
        l = pd.DataFrame(raw_l)  # noqa: E741 — the reference's name
        n = pd.DataFrame(raw_n)
        o = o[(o.o_orderdate >= tpch_data.Q10_LO)
              & (o.o_orderdate < tpch_data.Q10_HI)]
        l = l[l.l_returnflag == "R"]  # noqa: E741
        j = (o.merge(l, left_on="o_orderkey", right_on="l_orderkey")
             .merge(c, left_on="o_custkey", right_on="c_custkey")
             .merge(n, left_on="c_nationkey", right_on="n_nationkey"))
        j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
        exp = (j.groupby(["c_custkey", "c_nationkey", "n_name"])
               .revenue.sum().reset_index()
               .sort_values(["revenue", "c_custkey"],
                            ascending=[False, True])
               .head(TOP_K).reset_index(drop=True))
        assert len(res) == len(exp), (len(res), len(exp))
        np.testing.assert_array_equal(res["c_custkey"].to_numpy(),
                                      exp["c_custkey"].to_numpy())
        np.testing.assert_array_equal(res["n_name"].to_numpy(),
                                      exp["n_name"].to_numpy())
        np.testing.assert_allclose(res["sum_revenue"].to_numpy(),
                                   exp["revenue"].to_numpy(), rtol=1e-4)

    rec = emit("tpch_q10", rows=rows, seconds=dt, rows_per_sec=rows / dt,
               world=ctx.GetWorldSize(), top=len(res), sf=sf,
               shuffles_elided=elided)
    if eager_identical is not None:
        rec["eager_bit_identical"] = eager_identical
    return rec


if __name__ == "__main__":
    import sys

    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 0.01
    run(sf, compare_eager="--compare-eager" in sys.argv,
        explain="--explain" in sys.argv,
        analyze="--analyze" in sys.argv)
