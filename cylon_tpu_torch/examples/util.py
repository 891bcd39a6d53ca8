"""Shared example-harness helpers: context setup, table ingest, JSON
timing output, the counterpart of ``examples/util.py`` (the role of the
reference's bench drivers' logging,
cpp/src/examples/bench/table_join_dist_test.cpp:28-137).

No persistent compile cache is enabled: eager PyTorch compiles nothing
per shape, and the hand kernels are built once per source hash
(``cuda/build.py``)."""
from __future__ import annotations

import json
import sys


def default_ctx(world: int | None = None, device=None):
    """The examples' context.  With no ``device``: one shard per CUDA card
    (a local context on one card), or ``world`` shards dealt round-robin
    over the cards, so ``world`` > cards puts several shards on one card.
    With a ``device`` (``"cpu"`` for the tests): ``world`` shards on it, a
    local context for one.  Without a card and without ``device`` it
    raises, as ``CylonContext.Init()`` does; it never falls back to the
    CPU."""
    import torch

    from cylon_tpu_torch import CylonContext, MeshConfig, default_device

    if device is None:
        default_device()  # raises without a card
        w = world or torch.cuda.device_count()
        if w <= 1:
            return CylonContext.Init()
        return CylonContext.InitDistributed(MeshConfig(world_size=w))
    if not world or world <= 1:
        return CylonContext.Init(device)
    return CylonContext.InitDistributed(MeshConfig(devices=[device],
                                                   world_size=world))


def sync(ctx) -> None:
    """Wait for every queued launch on the context's cards, so that a
    timed window ends on a host sync (a no-op on the CPU)."""
    import torch

    for dev in {d for d in ctx.devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def table_from_arrays(arrays: dict, ctx):
    from cylon_tpu_torch import Table

    return Table.from_numpy(list(arrays.keys()), list(arrays.values()),
                            ctx=ctx)


def emit(config: str, **fields) -> dict:
    rec = {"config": config, **{
        k: (round(v, 3) if isinstance(v, float) else v)
        for k, v in fields.items()}}
    print(json.dumps(rec), flush=True)
    return rec


def log(msg: str) -> None:
    print(f"[example] {msg}", file=sys.stderr, flush=True)
