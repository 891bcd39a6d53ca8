"""TPC-H Q5 (local supplier volume) through the planner, on a one-shard
context: the plan of ``cylon_tpu_torch.pipeline.tpch_q5_plan``, with the
region predicate spelled as TPC-H states it, ``r_name = 'ASIA'``, and
the order dates of the validation values, [1994-01-01, 1995-01-01).
The program holds the six tables whole, every column, and the planner
prunes what Q5 does not read.  The plan is built and executed per query;
the query ends when the result is on the host."""
from __future__ import annotations

from cylon_tpu_torch import CylonContext
from cylon_tpu_torch.plan import col, lit

from .. import portio
from ..data.tpch import day

TABLES = ("customer", "orders", "lineitem", "supplier", "nation", "region")
DATES = (day("1994-01-01"), day("1995-01-01"))
REGION = "ASIA"


def prepare(inputs: dict, params: dict, device):
    ctx = CylonContext.Init(device)
    return tuple(portio.table(ctx, inputs[t]) for t in TABLES)


def run(tables):
    cust, orde, line, supp, nati, regi = tables
    lo, hi = DATES
    plan = (cust.plan()
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
            .filter(col("r_name") == lit(REGION))
            .with_column("revenue",
                         col("l_extendedprice") * (lit(1.0)
                                                   - col("l_discount")))
            .groupby(["n_regionkey", "n_name"], {"revenue": ["sum"]})
            .project(["n_name", "sum_revenue"])
            .sort(["sum_revenue", "n_name"], ascending=[False, True]))
    return plan.execute().to_numpy()


def keep(result):
    """The result is already a small frame on the host."""
    return result


def answer(result) -> dict:
    """{"nations": names in the result's order, "revenue": floats}."""
    return {"nations": [str(n) for n in result["n_name"]],
            "revenue": [float(r) for r in result["sum_revenue"]]}
