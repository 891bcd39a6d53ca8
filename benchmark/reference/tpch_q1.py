"""Plain reference of TPC-H Q1 in PyTorch on the inputs' device: the
ship-date filter, the two derived prices and the eight aggregates per
(returnflag, linestatus), by ``index_add_`` over a group code, in
``dtype`` (float64, or a lower precision for the control); counts are
exact integers.  Imports nothing of the program."""
from __future__ import annotations

import torch

from ..data.tpch import day

CUTOFF = day("1998-12-01") - 90
FLAGS, STATUSES = b"ANR", b"FO"


def compute(inputs: dict, config: dict, dtype=torch.float64) -> dict:
    li = inputs["lineitem"]
    keep = li["l_shipdate"] <= CUTOFF
    flag = li["l_returnflag"][0][keep, 0].long()
    status = li["l_linestatus"][0][keep, 0].long()
    dev = flag.device
    # letter -> its rank in the alphabet, so the code orders as the keys
    rank = torch.zeros(256, dtype=torch.long, device=dev)
    for alphabet in (FLAGS, STATUSES):
        for i, b in enumerate(alphabet):
            rank[b] = i
    code = rank[flag] * len(STATUSES) + rank[status]
    cells = len(FLAGS) * len(STATUSES)
    q, price, disc, tax = (li[c][keep].to(dtype) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    count = torch.zeros(cells, dtype=torch.int64, device=dev)
    count.index_add_(0, code, torch.ones_like(code))

    def total(x):
        s = torch.zeros(cells, dtype=dtype, device=dev)
        return s.index_add_(0, code, x)

    sums = {"sum_l_quantity": total(q), "sum_l_extendedprice": total(price),
            "sum_disc_price": total(disc_price), "sum_charge": total(charge)}
    n = count.to(dtype)
    means = {"mean_l_quantity": sums["sum_l_quantity"] / n,
             "mean_l_extendedprice": sums["sum_l_extendedprice"] / n,
             "mean_l_discount": total(disc) / n}
    out = {}
    for c in torch.nonzero(count).squeeze(1).tolist():
        key = (chr(FLAGS[c // len(STATUSES)]), chr(STATUSES[c % len(STATUSES)]))
        out[key] = {"count_l_discount": float(count[c]),
                    **{k: float(v[c]) for k, v in {**sums, **means}.items()}}
    return out


def compare(got: dict, want: dict) -> dict:
    """The groups missing or extra, the counts that differ, and the widest
    relative gaps of the sums and of the means."""
    shared = set(got) & set(want)
    out = {"groups_differing": len(set(got) ^ set(want)),
           "counts_differing": sum(
               got[k]["count_l_discount"] != want[k]["count_l_discount"]
               for k in shared)}
    for kind in ("sum", "mean"):
        gaps = [abs(got[k][a] - want[k][a]) / max(abs(want[k][a]), 1e-30)
                for k in shared for a in want[k] if a.startswith(kind + "_")]
        missing = any(a not in got[k] for k in shared for a in want[k])
        out[f"{kind}_rel_gap"] = (float("inf") if missing or not shared
                                  else max(gaps))
    return out
