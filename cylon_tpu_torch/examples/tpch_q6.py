"""TPC-H Q6 — forecasting-revenue-change, the port's twin of
``examples/tpch_q6.py``: pure selective filter + scalar reduction over
lineitem (shipdate in 1994, discount in [0.05, 0.07], quantity < 24, sum
of extendedprice * discount).

The no-join member of the battery: exercises the vectorized predicate
path (Table.select) and the distributed scalar aggregate (one
allreduce) — the reference analog is compute::Sum over a Filter
(compute/aggregates.cpp:30-52).
"""
from __future__ import annotations

import time

import numpy as np

from . import tpch_data
from .util import default_ctx, emit, table_from_arrays


def run(sf: float = 0.1, world: int | None = None, seed: int = 0,
        check: bool = True, device=None) -> dict:
    ctx = default_ctx(world, device)
    rng = np.random.default_rng(seed)
    raw_l = tpch_data.lineitem(sf, rng)
    line = table_from_arrays(raw_l, ctx)
    rows = line.row_count

    t0 = time.perf_counter()
    f = line.select(lambda r: (r.l_shipdate >= tpch_data.Q6_LO)
                    & (r.l_shipdate < tpch_data.Q6_HI)
                    & (r.l_discount >= np.float32(0.05))
                    & (r.l_discount <= np.float32(0.07))
                    & (r.l_quantity < np.float32(24)))
    f["promo"] = f["l_extendedprice"] * f["l_discount"]
    revenue = float(f.sum("promo"))  # a host sync
    dt = time.perf_counter() - t0

    if check:
        import pandas as pd

        ldf = pd.DataFrame(raw_l)
        m = ((ldf.l_shipdate >= tpch_data.Q6_LO)
             & (ldf.l_shipdate < tpch_data.Q6_HI)
             & (ldf.l_discount >= np.float32(0.05))
             & (ldf.l_discount <= np.float32(0.07))
             & (ldf.l_quantity < 24))
        exp = float((ldf.l_extendedprice[m] * ldf.l_discount[m]).sum())
        np.testing.assert_allclose(revenue, exp, rtol=1e-4)

    return emit("tpch_q6", rows=rows, seconds=dt, rows_per_sec=rows / dt,
                world=ctx.GetWorldSize(), revenue=round(revenue, 2), sf=sf)


if __name__ == "__main__":
    import sys

    run(sf=float(sys.argv[1]) if len(sys.argv) > 1 else 0.1)
