"""Each plain reference against pandas at tiny sizes, the program against
each reference on the CPU, and the control (the reference in bfloat16,
put in the program's place) failing the cell's limits."""
import numpy as np
import pytest

from benchmark import calibrate, harness
from benchmark.data import tpch

from .conftest import SEED, TINY

pd = pytest.importorskip("pandas")


def frame(cols: dict):
    out = {}
    for k, v in cols.items():
        if isinstance(v, tuple):
            data, lengths = v
            out[k] = [bytes(r[:n].tolist()).decode()
                      for r, n in zip(data, lengths.tolist())]
        else:
            out[k] = v.numpy()
    return pd.DataFrame(out)


def test_join_groupby_reference_is_pandas():
    cell = harness.Cell("jg-sort-2p28", TINY["jg-sort-2p28"])
    inputs = cell.generator.generate(cell.config, SEED, "cpu")
    want = cell.reference.compute(inputs, cell.config)
    left, right = (frame(inputs[t]).astype({"v": "f8"})
                   for t in ("left", "right"))
    j = left.merge(right, on="k")
    g = j.groupby("k").agg(s=("v_x", "sum"), m=("v_y", "mean"))
    assert want["join_rows"] == len(j) and want["groups"] == len(g)
    assert np.array_equal(want["keys"].numpy(), g.index.to_numpy())
    np.testing.assert_allclose(want["sum"].numpy(), g["s"], rtol=1e-12)
    np.testing.assert_allclose(want["mean"].numpy(), g["m"], rtol=1e-12)


def test_q1_reference_is_pandas():
    cell = harness.Cell("tpch-q1-sf10", TINY["tpch-q1-sf10"])
    inputs = cell.generator.generate(cell.config, SEED, "cpu")
    want = cell.reference.compute(inputs, cell.config)
    df = frame(inputs["lineitem"]).astype({"l_quantity": "f8",
                                           "l_extendedprice": "f8",
                                           "l_discount": "f8",
                                           "l_tax": "f8"})
    df = df[df.l_shipdate <= tpch.day("1998-09-02")]
    df["disc_price"] = df.l_extendedprice * (1 - df.l_discount)
    df["charge"] = df.disc_price * (1 + df.l_tax)
    g = df.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_l_quantity=("l_quantity", "sum"),
        sum_l_extendedprice=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        mean_l_quantity=("l_quantity", "mean"),
        mean_l_extendedprice=("l_extendedprice", "mean"),
        mean_l_discount=("l_discount", "mean"),
        count_l_discount=("l_discount", "count"))
    assert set(want) == set(g.index)
    for key, row in g.iterrows():
        for name, v in row.items():
            assert want[key][name] == pytest.approx(v, rel=1e-12), name


def test_q5_reference_is_pandas():
    cell = harness.Cell("tpch-q5-sf10", TINY["tpch-q5-sf10"])
    inputs = cell.generator.generate(cell.config, SEED, "cpu")
    want = cell.reference.compute(inputs, cell.config)
    c, o, li, s, n, r = (frame(inputs[t]) for t in (
        "customer", "orders", "lineitem", "supplier", "nation", "region"))
    o = o[(o.o_orderdate >= tpch.day("1994-01-01"))
          & (o.o_orderdate < tpch.day("1995-01-01"))]
    j = (c.merge(o, left_on="c_custkey", right_on="o_custkey")
         .merge(li, left_on="o_orderkey", right_on="l_orderkey")
         .merge(s, left_on="l_suppkey", right_on="s_suppkey"))
    j = j[j.c_nationkey == j.s_nationkey]
    j = (j.merge(n, left_on="c_nationkey", right_on="n_nationkey")
         .merge(r, left_on="n_regionkey", right_on="r_regionkey"))
    j = j[j.r_name == "ASIA"]
    rev = (j.l_extendedprice.astype("f8") * (1 - j.l_discount.astype("f8")))
    g = rev.groupby(j.n_name).sum().reset_index(name="revenue")
    g = g.sort_values(["revenue", "n_name"], ascending=[False, True])
    assert want["nations"] == list(g.n_name)
    np.testing.assert_allclose(want["revenue"], g.revenue, rtol=1e-12)


def within(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in limits.items())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_program_passes_and_control_fails(cell):
    c = harness.Cell(cell, TINY[cell])
    inputs = c.generator.generate(c.config, SEED, "cpu")
    want = c.reference.compute(inputs, c.config)
    got = c.query.answer(c.query.keep(c.query.run(c.query.prepare(
        inputs, c.traffic.get("params", {}), "cpu"))))
    assert within(c.reference.compare(got, want), c.limits)
    control = calibrate.control_numbers(c, SEED, "cpu")
    assert not within(control, c.limits)


def test_calibrate_records_readings():
    rec = calibrate.calibrate("tpch-q1-sf10", [SEED, SEED + 1], 1, 0.2,
                              "cpu", TINY["tpch-q1-sf10"])
    assert [p["correct"] for p in rec["program"]] == [True, True]
    assert rec["upper"]["sum_rel_gap"] > rec["lower"]["sum_rel_gap"]
