"""TPC-H Q10 and Q5 through the port's planner, the twins of
``tests/test_examples.py:38-56`` (``examples/tpch_q10.py`` and
``examples/tpch_q5.py::run_plan`` at sf 0.004).

The tables are drawn by ``examples/tpch_data.py`` and built on a 4-shard
CPU mesh of the port (``pipeline.tpch_q10_plan`` / ``tpch_q5_plan``)
and of the JAX package (``examples/tpch_q10.py:33 build_plan``, and Q5's
plan as ``run_plan`` writes it).  Each query must: elide at least one
shuffle; give bit-identical tables planned and eager
(``CYLON_TPU_PLAN=0``); equal the reference's result (keys exact,
revenue within rtol 1e-5: the packages sum in another order); and match
a pandas float64 oracle within rtol 1e-4, as the examples check.
"""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, config, pipeline
from cylon_tpu_torch.obs import metrics as obs_metrics
from examples import tpch_data

SF = 0.004


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    raw = {"c": tpch_data.customer(SF, rng), "o": tpch_data.orders(SF, rng)}
    raw["l"] = tpch_data.lineitem(SF, rng, q5_keys=True,
                                  orders_rows=len(raw["o"]["o_orderkey"]))
    raw["s"] = tpch_data.supplier(SF, rng)
    raw["n"] = tpch_data.nation()
    raw["r"] = tpch_data.region()
    return raw


@pytest.fixture(scope="module")
def mesh4():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def _tables(T, ctx, raw, names):
    return [T.from_numpy(list(raw[n]), list(raw[n].values()), ctx=ctx)
            for n in names]


def _run(plan):
    """(planned frame, eager frame, shuffles elided by the planned run)."""
    before = obs_metrics.counter_value("plan.shuffles_elided")
    planned = plan.execute().to_pandas().reset_index(drop=True)
    elided = obs_metrics.counter_value("plan.shuffles_elided") - before
    with config.knob_env(CYLON_TPU_PLAN="0"):
        eager = plan.execute().to_pandas().reset_index(drop=True)
    return planned, eager, elided


def _assert_bit_identical(a, b):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy(),
                                      err_msg=c)


def _q10_oracle(raw):
    lo, hi = pipeline.Q10_DATES
    o = pd.DataFrame(raw["o"])
    o = o[(o.o_orderdate >= lo) & (o.o_orderdate < hi)]
    li = pd.DataFrame({k: v for k, v in raw["l"].items()
                       if k != "l_suppkey"})
    li = li[li.l_returnflag == "R"]
    j = (o.merge(li, left_on="o_orderkey", right_on="l_orderkey")
         .merge(pd.DataFrame(raw["c"]), left_on="o_custkey",
                right_on="c_custkey")
         .merge(pd.DataFrame(raw["n"]), left_on="c_nationkey",
                right_on="n_nationkey"))
    j["revenue"] = j.l_extendedprice * (1 - j.l_discount)
    return (j.groupby(["c_custkey", "c_nationkey", "n_name"])
            .revenue.sum().reset_index()
            .sort_values(["revenue", "c_custkey"], ascending=[False, True])
            .head(pipeline.Q10_TOP).reset_index(drop=True))


def test_tpch_q10_planned(data, mesh4, ctx4):
    from examples import tpch_q10

    raw = dict(data, l={k: v for k, v in data["l"].items()
                        if k != "l_suppkey"})  # Q10 joins on orderkey
    cust, orde, line, nati = _tables(Table, mesh4, raw, "coln")
    plan = pipeline.tpch_q10_plan(cust, orde, line, nati)
    planned, eager, elided = _run(plan)
    assert elided >= 1
    assert "ELIDED" in plan.explain()
    _assert_bit_identical(planned, eager)
    assert len(planned) == pipeline.Q10_TOP
    ref = tpch_q10.build_plan(*_tables(RTable, ctx4, raw, "coln"))
    assert plan.explain() == ref.explain()
    want = ref.execute().to_pandas().reset_index(drop=True)
    for c in ("c_custkey", "c_nationkey", "n_name"):
        np.testing.assert_array_equal(planned[c].to_numpy(),
                                      want[c].to_numpy())
    np.testing.assert_allclose(planned["sum_revenue"], want["sum_revenue"],
                               rtol=1e-5)
    exp = _q10_oracle(raw)
    np.testing.assert_array_equal(planned["c_custkey"], exp["c_custkey"])
    np.testing.assert_array_equal(planned["n_name"], exp["n_name"])
    np.testing.assert_allclose(planned["sum_revenue"], exp["revenue"],
                               rtol=1e-4)


def _q5_reference_plan(cust, orde, line, supp, nati, regi):
    """Q5's plan as ``examples/tpch_q5.py:92 run_plan`` builds it."""
    from cylon_tpu.plan import col, lit

    return (cust.plan()
            .join(orde.plan()
                  .filter((col("o_orderdate") >= tpch_data.Q5_LO)
                          & (col("o_orderdate") < tpch_data.Q5_HI)),
                  left_on="c_custkey", right_on="o_custkey")
            .join(line.plan(), left_on="o_orderkey", right_on="l_orderkey")
            .join(supp.plan(), left_on="l_suppkey", right_on="s_suppkey")
            .filter(col("c_nationkey") == col("s_nationkey"))
            .join(nati.plan(), left_on="c_nationkey",
                  right_on="n_nationkey")
            .join(regi.plan(), left_on="n_regionkey",
                  right_on="r_regionkey")
            .filter(col("r_regionkey") == lit(tpch_data.REGIONS.index(
                "ASIA")))
            .with_column("revenue",
                         col("l_extendedprice") * (lit(1.0)
                                                   - col("l_discount")))
            .groupby(["n_regionkey", "n_name"], {"revenue": ["sum"]})
            .project(["n_name", "sum_revenue"])
            .sort(["sum_revenue", "n_name"], ascending=[False, True]))


def test_tpch_q5_planned(data, mesh4, ctx4):
    from examples import tpch_q5

    assert pipeline.Q5_REGION == tpch_data.REGIONS.index("ASIA")
    assert pipeline.Q5_DATES == (tpch_data.Q5_LO, tpch_data.Q5_HI)
    assert pipeline.Q10_DATES == (tpch_data.Q10_LO, tpch_data.Q10_HI)
    names = "colsnr"
    plan = pipeline.tpch_q5_plan(*_tables(Table, mesh4, data, names))
    planned, eager, elided = _run(plan)
    assert elided >= 1
    _assert_bit_identical(planned, eager)
    assert len(planned) >= 1
    ref = _q5_reference_plan(*_tables(RTable, ctx4, data, names))
    assert plan.explain() == ref.explain()
    want = ref.execute().to_pandas().reset_index(drop=True)
    np.testing.assert_array_equal(planned["n_name"], want["n_name"])
    np.testing.assert_allclose(planned["sum_revenue"], want["sum_revenue"],
                               rtol=1e-5)
    exp = tpch_q5._pandas_golden(data["c"], data["o"], data["l"], data["s"],
                                 data["n"], data["r"], pipeline.Q5_REGION)
    assert len(planned) == len(exp)
    got = dict(zip(planned["n_name"], planned["sum_revenue"]))
    for name, rev in zip(exp["n_name"], exp["revenue"]):
        np.testing.assert_allclose(got[name], rev, rtol=1e-4)
