"""BASELINE config 2 — TPC-H Q1: pricing-summary groupby-aggregate,
distributed over the mesh, the port's twin of ``examples/tpch_q1.py``
(reference analog: the groupby benchmark drivers,
python/examples/op_benchmark; DistributedHashGroupBy groupby/groupby.cpp).

Q1 = filter(shipdate <= cutoff)
   -> derive disc_price, charge
   -> groupby(returnflag, linestatus): 8 aggregates
   -> order by the keys.

The query is ``pipeline.tpch_q1``: the reference's select, derived
columns and aggregate list.
"""
from __future__ import annotations

import time

import numpy as np

from . import tpch_data
from .util import default_ctx, emit, table_from_arrays


def run(sf: float = 1.0, world: int | None = None, seed: int = 0,
        check: bool = True, device=None) -> dict:
    from cylon_tpu_torch import pipeline

    ctx = default_ctx(world, device)
    rng = np.random.default_rng(seed)
    raw = tpch_data.lineitem(sf, rng)
    t = table_from_arrays(raw, ctx)
    rows = t.row_count

    t0 = time.perf_counter()
    g = pipeline.tpch_q1(t)
    out = g.to_pandas().sort_values(["l_returnflag", "l_linestatus"])
    dt = time.perf_counter() - t0

    if check:
        import pandas as pd

        df = pd.DataFrame(raw)
        df = df[df.l_shipdate <= tpch_data.Q1_CUTOFF]
        df["disc_price"] = df.l_extendedprice * (1 - df.l_discount)
        df["charge"] = df.disc_price * (1 + df.l_tax)
        exp = (df.groupby(["l_returnflag", "l_linestatus"])
               .agg(sum_qty=("l_quantity", "sum"),
                    sum_disc_price=("disc_price", "sum"),
                    count=("l_discount", "count"))
               .reset_index()
               .sort_values(["l_returnflag", "l_linestatus"]))
        assert len(out) == len(exp)
        np.testing.assert_allclose(out["sum_l_quantity"], exp["sum_qty"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["sum_disc_price"],
                                   exp["sum_disc_price"], rtol=1e-5)
        assert np.array_equal(out["count_l_discount"], exp["count"])

    return emit("tpch_q1", rows=rows, seconds=dt,
                rows_per_sec=rows / dt, world=ctx.GetWorldSize(),
                groups=len(out), sf=sf)


if __name__ == "__main__":
    import sys

    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 0.1
    run(sf)
