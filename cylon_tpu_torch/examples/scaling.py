"""Strong/weak scaling driver, the port's twin of ``examples/scaling.py``
(reference analog: cpp/src/experiments/run_dist_scaling.py:9-60, which
sweeps world sizes and row counts over the distributed join).  Sweeps
world sizes 1, 2, 4, ... up to ``max_world`` (default: the CUDA cards)
and reports join / shuffle / groupby throughput per world size, one JSON
line each.

Shards are dealt round-robin over the cards, so a world larger than the
card count puts several shards on one card: such a rung measures the
distributed rung's overhead (hash kernel, device-local exchange, per-shard
kernels), not scaling across cards.  Each record's ``cards`` and
``shared_card`` fields say which it is.

Usage: python -m cylon_tpu_torch.examples.scaling [rows_per_shard]
       [strong|weak] [max_world]
  strong — total rows fixed at rows_per_shard * max_world, split across
           however many shards the sweep step uses
  weak   — rows_per_shard rows per shard at every world size
"""
from __future__ import annotations

import sys
import time

import numpy as np

from .util import default_ctx, emit, log, table_from_arrays


def _sweep_worlds(max_devices: int):
    w, out = 1, []
    while w <= max_devices:
        out.append(w)
        w *= 2
    return out


def run(rows_per_shard: int = 1 << 17, mode: str = "weak",
        max_world: int | None = None, device=None) -> list:
    import torch

    from cylon_tpu_torch import default_device

    if device is None:
        default_device()  # raises without a card
    if max_world is None:
        max_world = torch.cuda.device_count() if device is None else 1
    worlds = _sweep_worlds(max_world)
    max_world = worlds[-1]
    results = []
    rng = np.random.default_rng(3)
    for world in worlds:
        rows = (rows_per_shard * world if mode == "weak"
                else rows_per_shard * max_world)
        ctx = default_ctx(world, device)
        keys = max(rows, 1)
        data_l = {"k": rng.integers(0, keys, rows).astype(np.int32),
                  "a": rng.random(rows).astype(np.float32)}
        data_r = {"k": rng.integers(0, keys, rows).astype(np.int32),
                  "b": rng.random(rows).astype(np.float32)}
        tl = table_from_arrays(data_l, ctx)
        tr = table_from_arrays(data_r, ctx)

        def timed(fn, reps=3):
            fn()  # warm-up: kernel build and allocator
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()  # each ends on row_count: a host sync
                ts.append(time.perf_counter() - t0)
            return min(ts)

        t_shuffle = timed(lambda: tl.shuffle(["k"]).row_count)
        t_join = timed(
            lambda: tl.distributed_join(tr, on="k", how="inner").row_count)
        t_groupby = timed(
            lambda: tl.groupby("k", {"a": ["sum", "mean"]}).row_count)
        cards = len({str(d) for d in ctx.devices})
        results.append(emit(
            "scaling", mode=mode, world=world, rows=rows,
            shuffle_rows_per_sec=rows / t_shuffle,
            join_rows_per_sec=2 * rows / t_join,
            groupby_rows_per_sec=rows / t_groupby,
            cards=cards, shared_card=world > cards))
    return results


if __name__ == "__main__":
    rps = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 17
    mode = sys.argv[2] if len(sys.argv) > 2 else "weak"
    mw = int(sys.argv[3]) if len(sys.argv) > 3 else None
    log(f"scaling sweep: rows_per_shard={rps} mode={mode} max_world={mw}")
    run(rps, mode, mw)
