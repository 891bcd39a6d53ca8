"""The distributed join -> group-by of upstream Cylon's distributed join
benchmark, through the program's main path over a mesh of one shard a
card in one process: ``pipeline.distributed_join_groupby`` (the murmur3
hash partition and the exchange of both sides, the local sort join on
every card, then the two-phase group-by on the left key with SUM(left
value) and MEAN(right value)).  The query ends when every card's group
count is on the host."""
from __future__ import annotations

import torch

from cylon_tpu_torch import CylonContext, MeshConfig, Table, pipeline

from .. import portio

TABLES = ("left", "right")  # the base tables a query reads


def _table(ctx, cols: dict, value_name: str) -> Table:
    """A table of one shard a card over the per-card tensors, no copy."""
    shards = tuple((portio.column(k), portio.column(v))
                   for k, v in zip(cols["k"], cols["v"]))
    counts = tuple(torch.tensor(k.shape[0], dtype=torch.int32,
                                device=k.device) for k in cols["k"])
    return Table(shards, counts, ("k", value_name), ctx)


def prepare(inputs: dict, params: dict, devices):
    if params.get("algo", "sort") != "sort":
        raise ValueError("the distributed join runs the sort join")
    ctx = CylonContext.InitDistributed(MeshConfig(devices=list(devices)))
    return {"left": _table(ctx, inputs["left"], "lv"),
            "right": _table(ctx, inputs["right"], "rv")}


def run(state):
    """(per card: the group columns, the group count on the host, the
    join's row count), and the joined table's capacity.  The joined
    table itself is dropped here, so no query holds the last one's."""
    groups, joined = pipeline.distributed_join_groupby(state["left"],
                                                       state["right"])
    g = [int(c) for c in groups.counts]
    return (list(groups.shards), g, list(joined.counts),
            joined.shard_capacity)


def keep(result):
    """A compact copy of what the reference judges, made where the query
    ends: each card's live groups' keys, SUM and MEAN, the join's rows a
    card, the joined capacity, and whether validity marks exactly each
    card's live prefix."""
    shards, g, jm, cap = result
    valid = all(bool(c.validity[:n].all()) and not bool(c.validity[n:].any())
                for cols, n in zip(shards, g) for c in cols)
    return {"join_rows_per_card": [int(m) for m in jm], "capacity": cap,
            "groups": sum(g), "valid": valid,
            **{name: [cols[i].data[:n].clone() for cols, n in zip(shards, g)]
               for i, name in enumerate(("keys", "sum", "mean"))}}


def answer(kept: dict) -> dict:
    """The kept result in the reference's form: the groups of every card
    gathered on the first card, by key ascending."""
    dev = kept["keys"][0].device
    keys = torch.cat([k.to(dev) for k in kept["keys"]])
    order = torch.argsort(keys, stable=True)
    out = {k: kept[k] for k in ("join_rows_per_card", "capacity", "groups",
                                "valid")}
    out["keys"] = keys[order]
    del keys
    for name in ("sum", "mean"):
        out[name] = torch.cat([x.to(dev) for x in kept[name]])[order]
    return out
