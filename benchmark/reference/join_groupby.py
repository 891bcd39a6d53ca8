"""Plain reference of the join -> SUM/MEAN group-by, in PyTorch on the
inputs' device: per key, the counts and value sums of each side by
``index_add_`` into key-domain accumulators.  The join count is the sum
over keys of left count times right count; a key is a group when both
sides hold it; SUM(left value) over the joined rows is the left sum times
the right count, MEAN(right value) the right sum over the right count.
``dtype`` is the precision the sums are worked out in: float64, or a
lower one for the control.  Imports nothing of the program."""
from __future__ import annotations

import torch


def compute(inputs: dict, config: dict, dtype=torch.float64) -> dict:
    left, right = inputs["left"], inputs["right"]
    domain = config["key_domain"]
    dev = left["k"].device
    counts, sums = [], []
    for side in (left, right):
        k = side["k"].long()
        c = torch.zeros(domain, dtype=torch.int64, device=dev)
        c.index_add_(0, k, torch.ones_like(k))
        s = torch.zeros(domain, dtype=dtype, device=dev)
        s.index_add_(0, k, side["v"].to(dtype))
        counts.append(c)
        sums.append(s)
        del k
    (cl, cr), (sl, sr) = counts, sums
    keys = torch.nonzero((cl > 0) & (cr > 0)).squeeze(1)
    cr_k = cr[keys]
    join_rows = int((cl * cr).sum())
    return {"join_rows": join_rows, "sized_rows": join_rows,
            "groups": int(keys.numel()), "keys": keys.to(torch.int32),
            "sum": sl[keys] * cr_k.to(dtype), "mean": sr[keys] / cr_k.to(dtype),
            "valid": True}


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of ``got`` from ``want`` over ``want``'s size
    (a gap over a zero is measured against 1e-30)."""
    want = want.double()
    gap = (got.double() - want).abs()
    return float((gap / want.abs().clamp_min(1e-30)).max()) if gap.numel() \
        else 0.0


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, each against its own limit: the counts'
    gaps, the group keys that differ (all of them when the group counts
    differ), and the widest relative gaps of SUM and MEAN."""
    same_groups = got["groups"] == want["groups"]
    out = {
        "join_rows_gap": abs(got["join_rows"] - want["join_rows"]),
        "sized_rows_gap": abs(got["sized_rows"] - want["join_rows"]),
        "groups_gap": abs(got["groups"] - want["groups"]),
        "keys_differing": (int((got["keys"].to(want["keys"].device)
                                != want["keys"]).sum())
                           if same_groups else max(got["groups"],
                                                   want["groups"])),
        "validity_wrong": 0 if got["valid"] else 1,
    }
    if same_groups and out["keys_differing"] == 0:
        dev = want["sum"].device
        out["sum_rel_gap"] = _max_rel(got["sum"].to(dev), want["sum"])
        out["mean_rel_gap"] = _max_rel(got["mean"].to(dev), want["mean"])
    else:
        out["sum_rel_gap"] = out["mean_rel_gap"] = float("inf")
    return out
