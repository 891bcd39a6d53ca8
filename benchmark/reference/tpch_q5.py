"""Plain reference of TPC-H Q5 in PyTorch on the inputs' device: each
line's order, customer and supplier found by ``searchsorted`` on the
sorted keys, the order-date window, customer and supplier in one nation,
that nation in the region named 'ASIA', and revenue per nation by
``index_add_`` in ``dtype`` (float64, or a lower precision for the
control); nations by revenue descending, then name.  Imports nothing of
the program."""
from __future__ import annotations

import torch

from ..data.tpch import day

DATES = (day("1994-01-01"), day("1995-01-01"))
REGION = b"ASIA"


def _lookup(keys: torch.Tensor, probe: torch.Tensor):
    """(row of each probe in ``keys``, whether it is there)."""
    sk, order = torch.sort(keys.long())
    pos = torch.searchsorted(sk, probe.long()).clamp_max(sk.numel() - 1)
    return order[pos], sk[pos] == probe.long()


def _names(col) -> list:
    data, lengths = col
    return [bytes(data[i, :int(lengths[i])].tolist()).decode()
            for i in range(data.shape[0])]


def compute(inputs: dict, config: dict, dtype=torch.float64) -> dict:
    c, o, li, s = (inputs[t] for t in ("customer", "orders", "lineitem",
                                       "supplier"))
    n, r = inputs["nation"], inputs["region"]
    orow, ok = _lookup(o["o_orderkey"], li["l_orderkey"])
    date = o["o_orderdate"][orow]
    ok &= (date >= DATES[0]) & (date < DATES[1])
    crow, found = _lookup(c["c_custkey"], o["o_custkey"][orow])
    ok &= found
    srow, found = _lookup(s["s_suppkey"], li["l_suppkey"])
    ok &= found
    nation = c["c_nationkey"][crow]
    ok &= nation == s["s_nationkey"][srow]
    region_names = _names(r["r_name"])
    in_region = torch.zeros(len(region_names), dtype=torch.bool,
                            device=ok.device)
    in_region[[i for i, x in enumerate(region_names)
                if x == REGION.decode()]] = True
    nrow, found = _lookup(n["n_nationkey"], nation)
    ok &= found
    rrow, found = _lookup(r["r_regionkey"], n["n_regionkey"][nrow])
    ok &= found & in_region[rrow]
    nrow = nrow[ok]
    revenue = (li["l_extendedprice"][ok].to(dtype)
               * (1 - li["l_discount"][ok].to(dtype)))
    names = _names(n["n_name"])
    total = torch.zeros(len(names), dtype=dtype, device=ok.device)
    total.index_add_(0, nrow, revenue)
    present = torch.zeros(len(names), dtype=torch.int64, device=ok.device)
    present.index_add_(0, nrow, torch.ones_like(nrow))
    rows = sorted(((float(total[i]), names[i]) for i in range(len(names))
                   if int(present[i])), key=lambda x: (-x[0], x[1]))
    return {"nations": [x[1] for x in rows], "revenue": [x[0] for x in rows]}


def compare(got: dict, want: dict) -> dict:
    """The nations missing or extra, the widest relative gap of a nation's
    revenue, and the places where the result's order breaks its own
    revenues (descending, then name) or puts a nation before one whose
    reference revenue is larger by more than 1e-3 of it."""
    ref = dict(zip(want["nations"], want["revenue"]))
    mine = dict(zip(got["nations"], got["revenue"]))
    shared = set(ref) & set(mine)
    out = {"nations_differing": len(set(ref) ^ set(mine))
           + len(got["nations"]) - len(mine)}
    out["revenue_rel_gap"] = (max(abs(mine[k] - ref[k]) / max(abs(ref[k]),
                                                              1e-30)
                                  for k in shared)
                              if shared else float("inf"))
    wrong = 0
    pairs = list(zip(got["nations"], got["revenue"]))
    for (a, ra), (b, rb) in zip(pairs, pairs[1:]):
        if (-ra, a) > (-rb, b):
            wrong += 1
        elif a in ref and b in ref and ref[b] > ref[a] * (1 + 1e-3):
            wrong += 1
    out["order_wrong"] = wrong
    return out
