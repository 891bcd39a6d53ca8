"""BASELINE config 3 — large hash shuffle / repartition, the port's twin
of ``examples/shuffle_bench.py``.

The 1B-row target is scaled to the available cards and memory (``rows``
arg); the driver reports shuffled rows/sec, so the same code measures a
CPU test mesh, shards on one card, or several cards.  Reference analog:
Shuffle (table.cpp:951-964) under the scaling experiments
cpp/src/experiments/run_dist_scaling.py.  On a context of one shard
``Table.shuffle`` returns its input: pass ``world`` to put shards on the
one card.
"""
from __future__ import annotations

import time

import numpy as np

from .util import default_ctx, emit, table_from_arrays


def _gen_data(rows: int, seed: int) -> dict:
    """The config-3 k/a/b schema, generated directly in the final dtypes
    (no int64/float64 transients — at 1B rows those would cost ~20 GB of
    avoidable peak host memory)."""
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, max(rows, 1), rows, dtype=np.int32),
        "a": rng.random(rows, dtype=np.float32),
        "b": rng.integers(0, 1 << 30, rows, dtype=np.int32),
    }


def run(rows: int = 1 << 20, world: int | None = None, seed: int = 0,
        reps: int = 3, out_dir: str | None = None, device=None) -> dict:
    ctx = default_ctx(world, device)
    t = table_from_arrays(_gen_data(rows, seed), ctx)

    s = t.shuffle(["k"])  # warm-up: kernel build and allocator
    assert s.row_count == rows
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s = t.shuffle(["k"])
        assert s.row_count == rows  # blocks on the exchange
        times.append(time.perf_counter() - t0)
    dt = min(times)
    res = emit("shuffle", rows=rows, seconds=dt, rows_per_sec=rows / dt,
               world=ctx.GetWorldSize(), reps=reps)
    if out_dir is not None:
        # scalable egress: one parquet file per shard, no gather — the
        # full-preset path exercises the per-shard writer at size
        import os

        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        s.to_parquet(os.path.join(out_dir, "shard_{shard}.parquet"),
                     per_shard=True)
        res["write_seconds"] = time.perf_counter() - t0
    return res


def run_ooc(rows: int = 1 << 30, world: int = 8, passes: int = 16,
            seed: int = 0, out_dir: str | None = None, keep: bool = False,
            device=None) -> dict:
    """BASELINE config 3 at stated scale on one card: out-of-core hash
    repartition of ``rows`` rows into ``world`` hash shards, streamed in
    ``passes`` device passes (``exec.chunked_repartition``: the murmur3
    kernel and the stable split of the mesh shuffle's local half).
    Writes per-(shard, pass) parquet under ``out_dir`` (default: a new
    temporary directory) and reports end-to-end rows/sec including host
    IO; removes the output unless ``keep``."""
    import shutil
    import tempfile

    from ..exec import chunked_repartition

    ctx = default_ctx(1, device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="shuffle_ooc_")
    _, stats = chunked_repartition(_gen_data(rows, seed), "k", world,
                                   passes=passes, out_dir=out_dir, ctx=ctx)
    if not keep:
        shutil.rmtree(out_dir, ignore_errors=True)
    return emit("shuffle_ooc", rows=stats["rows"], world=world,
                passes=stats["passes"],
                seconds=stats["total_seconds"],
                rows_per_sec=stats["rows"] / max(stats["total_seconds"],
                                                 1e-9),
                run_rows_per_sec=stats["rows"] / max(stats["run_seconds"],
                                                     1e-9))


if __name__ == "__main__":
    import sys

    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    run(rows)
