"""BASELINE config 5 — ETL -> feature table -> the card -> a PyTorch MLP,
the port's twin of ``examples/etl_to_flax.py``.

The handoff pipeline: relational ETL in the port (join events to labels,
per-user feature aggregation), then the feature columns go to the host
(``to_numpy``, as the reference's do), are stacked into one feature
matrix and uploaded to the card in one copy (the reference's
``jax.device_put``), and a small MLP trains on them full-batch.  The
reference ships the equivalent story as its PyTorch tutorial
(cpp/src/tutorial/demo_pytorch_distributed.py).

The MLP is the reference's Flax one (Dense 32, ReLU, Dense 16, ReLU,
Dense 1) as an ``nn.Module``, trained with ``torch.optim.Adam(lr=1e-3)``
on ``BCEWithLogitsLoss``; its initial weights come from an explicit
``torch.Generator``, or from ``init`` (a ``state_dict``, such as
``params_from_flax`` makes from the reference's parameters).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from .util import default_ctx, emit, sync, table_from_arrays

FEATURES = ("sum_amount", "mean_amount", "max_amount", "count_amount",
            "nunique_kind")
WIDTHS = (len(FEATURES), 32, 16, 1)
LINEARS = ("layers.0", "layers.2", "layers.4")  # the state_dict's Linears


class MLP(nn.Module):
    """Linear 5->32, ReLU, 32->16, ReLU, 16->1; ``forward`` returns one
    logit per row."""

    def __init__(self):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(WIDTHS[0], WIDTHS[1]), nn.ReLU(),
            nn.Linear(WIDTHS[1], WIDTHS[2]), nn.ReLU(),
            nn.Linear(WIDTHS[2], WIDTHS[3]))

    def forward(self, x):
        return self.layers(x)[:, 0]


def params_from_flax(tree) -> dict:
    """The reference MLP's Flax parameters (numpy arrays, ``Dense_i`` with
    ``kernel`` of shape ``(in, out)`` and ``bias``; the ``params``
    collection or its content) as this module's ``state_dict``: each
    kernel transposed to ``nn.Linear``'s ``(out, in)`` weight."""
    tree = tree.get("params", tree)
    state = {}
    for i, name in enumerate(LINEARS):
        dense = tree[f"Dense_{i}"]
        state[f"{name}.weight"] = torch.from_numpy(
            np.array(np.asarray(dense["kernel"]).T, np.float32, order="C"))
        state[f"{name}.bias"] = torch.from_numpy(
            np.array(dense["bias"], np.float32))
    return state


def _seeded_state(seed: int) -> dict:
    """``nn.Linear``'s default distribution (uniform in +-1/sqrt(fan_in)
    for weight and bias), drawn on the CPU from a ``torch.Generator``
    seeded with ``seed``, so a seed gives the same weights on every
    device."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, fan_in, fan_out in zip(LINEARS, WIDTHS, WIDTHS[1:]):
        bound = 1.0 / np.sqrt(fan_in)
        state[f"{name}.weight"] = torch.empty(fan_out, fan_in).uniform_(
            -bound, bound, generator=gen)
        state[f"{name}.bias"] = torch.empty(fan_out).uniform_(
            -bound, bound, generator=gen)
    return state


def trainer(device, seed: int = 0, init: dict | None = None):
    """(``MLP`` on ``device`` from ``init`` or the seeded weights, its
    ``torch.optim.Adam(lr=1e-3)``).  The optimizer's first construction
    in a process imports ``torch._dynamo``, so the driver builds both
    before its timed window, as the reference builds its parameters and
    optimizer state before its own."""
    model = MLP()
    model.load_state_dict(init if init is not None else _seeded_state(seed))
    model.to(device)
    return model, torch.optim.Adam(model.parameters(), lr=1e-3)


def train(model, opt, x, y, steps: int):
    """Full-batch training: ``steps`` steps of ``opt`` on the mean binary
    cross-entropy with logits of ``model`` on ``x``.  Returns the per-step
    losses (each before its update, as the reference's
    ``value_and_grad`` step returns it) as a tensor on ``x``'s device;
    reading it is the caller's sync."""
    loss_fn = torch.nn.BCEWithLogitsLoss()
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def run(events: int = 200_000, users: int = 5_000, steps: int = 50,
        world: int | None = None, seed: int = 0, device=None,
        init: dict | None = None) -> dict:
    ctx = default_ctx(world, device)
    rng = np.random.default_rng(seed)

    # --- ETL phase: events ⋈ users -> per-user features ------------------
    t0 = time.perf_counter()
    ev = table_from_arrays({
        "user": rng.integers(0, users, events).astype(np.int32),
        "amount": rng.random(events).astype(np.float32),
        "kind": rng.integers(0, 5, events).astype(np.int32),
    }, ctx)
    lab = table_from_arrays({
        "user": np.arange(users, dtype=np.int32),
        "label": (rng.random(users) < 0.3).astype(np.int32),
    }, ctx)
    feats = ev.groupby("user", {"amount": ["sum", "mean", "max", "count"],
                                "kind": ["nunique"]})
    joined = feats.distributed_join(lab, left_on="user", right_on="user")
    cols = joined.to_numpy()  # a host sync
    etl_s = time.perf_counter() - t0

    # --- handoff: host columns -> one feature matrix on the card ---------
    t0 = time.perf_counter()
    x = np.stack([np.asarray(cols[c], np.float32) for c in FEATURES],
                 axis=1)
    y = np.asarray(cols["label"], np.float32)
    dev = ctx.devices[0]
    xd = torch.from_numpy(x).to(dev)
    yd = torch.from_numpy(y).to(dev)
    sync(ctx)
    put_s = time.perf_counter() - t0

    # --- train: the small MLP ---------------------------------------------
    model, opt = trainer(dev, seed, init)
    t0 = time.perf_counter()
    losses = train(model, opt, xd, yd, steps)
    sync(ctx)
    train_s = time.perf_counter() - t0

    return emit("etl_to_torch", events=events, users=len(y),
                etl_seconds=etl_s, device_put_seconds=put_s,
                train_seconds=train_s, steps=steps,
                final_loss=float(losses[-1]),
                world=ctx.GetWorldSize())


if __name__ == "__main__":
    run()
