"""BASELINE config 1 — two-table inner join from CSV files, the port's
twin of ``examples/join_csv.py``.

Mirrors the reference's canonical first example (join of
data/input/csv1_*.csv via pycylon): generate two keyed CSVs (the same
bytes for a seed as the JAX package's driver writes), read them through
the port's native C++ threaded CSV reader (``Table.from_csv``),
inner-join with ``distributed_join``.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from .util import default_ctx, emit, sync


def write_csvs(paths, rows: int, rng: np.random.Generator) -> None:
    """Write each of ``paths`` as ``key,val`` with ``rows`` rows: keys in
    ``[0, rows)``, values rounded to 6 decimals.  Python ints and floats
    print as the reference's numpy scalars do (shortest repr), at half
    the cost."""
    for p in paths:
        k = rng.integers(0, rows, rows).tolist()
        v = rng.random(rows).round(6).tolist()
        with open(p, "w") as f:
            f.write("key,val\n")
            f.writelines(f"{a},{b}\n" for a, b in zip(k, v))


def run(rows: int = 200_000, world: int | None = None, seed: int = 0,
        device=None) -> dict:
    from cylon_tpu_torch import Table

    ctx = default_ctx(world, device)
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as d:
        p1, p2 = os.path.join(d, "a.csv"), os.path.join(d, "b.csv")
        write_csvs((p1, p2), rows, rng)

        t0 = time.perf_counter()
        a = Table.from_csv(p1, ctx=ctx)
        b = Table.from_csv(p2, ctx=ctx)
        sync(ctx)
        t_read = time.perf_counter() - t0

        t0 = time.perf_counter()
        j = a.distributed_join(b, on="key", how="inner")
        n_out = j.row_count
        t_join = time.perf_counter() - t0

    return emit("join_csv", rows=2 * rows, read_seconds=t_read,
                join_seconds=t_join, out_rows=n_out,
                rows_per_sec=2 * rows / t_join, world=ctx.GetWorldSize())


if __name__ == "__main__":
    import sys

    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    run(rows)
