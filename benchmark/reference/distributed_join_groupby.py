"""Plain reference of the distributed join -> SUM/MEAN group-by, in
PyTorch on the inputs' cards, in key-range blocks: card ``c`` holds the
accumulators of the keys in ``[c * domain / cards, (c + 1) * domain /
cards)`` and gathers every card's rows of that range by a plain mask.
Per key, the counts and value sums of each side by ``index_add_``; the
join count is the sum over keys of left count times right count; a key
is a group when both sides hold it; SUM(left value) over the joined rows
is the left sum times the right count, MEAN(right value) the right sum
over the right count.  It uses neither the program's hash partition nor
its placement.  ``dtype`` is the precision the sums are worked out in:
float64, or a lower one for the control.  Imports nothing of the
program."""
from __future__ import annotations

import torch


def compute(inputs: dict, config: dict, dtype=torch.float64) -> dict:
    """The groups by key ascending, as one block a card: ``keys``,
    ``sum``, ``mean`` are lists of per-card tensors."""
    left, right = inputs["left"], inputs["right"]
    devices = [k.device for k in left["k"]]
    domain, cards = config["key_domain"], len(devices)
    width = domain // cards
    out = {"join_rows": 0, "groups": 0, "keys": [], "sum": [], "mean": [],
           "valid": True}
    for c, dev in enumerate(devices):
        lo = c * width
        hi = domain if c == cards - 1 else lo + width
        counts, sums = [], []
        for side in (left, right):
            cnt = torch.zeros(hi - lo, dtype=torch.int64, device=dev)
            acc = torch.zeros(hi - lo, dtype=dtype, device=dev)
            for k, v in zip(side["k"], side["v"]):
                mask = (k >= lo) & (k < hi)
                kb = (k[mask].long() - lo).to(dev)
                cnt.index_add_(0, kb, torch.ones_like(kb))
                acc.index_add_(0, kb, v[mask].to(dev, dtype))
                del mask, kb
            counts.append(cnt)
            sums.append(acc)
        (cl, cr), (sl, sr) = counts, sums
        keys = torch.nonzero((cl > 0) & (cr > 0)).squeeze(1)
        cr_k = cr[keys].to(dtype)
        out["join_rows"] += int((cl * cr).sum())
        out["groups"] += int(keys.numel())
        out["keys"].append((keys + lo).to(torch.int32))
        out["sum"].append(sl[keys] * cr_k)
        out["mean"].append(sr[keys] / cr_k)
        del counts, sums, cl, cr, sl, sr, keys, cr_k
    return out


def cap_round(n: int) -> int:
    """``n`` rounded up to a capacity of at most 8 sizes an octave (a
    3-bit mantissa; at least 16): the capacity a join sized by an exact
    count of ``n`` rows gets."""
    if n <= 16:
        return 16
    g = 1 << ((n - 1).bit_length() - 3)
    return -(-n // g) * g


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of ``got`` from ``want`` over ``want``'s size
    (a gap over a zero is measured against 1e-30)."""
    want = want.double()
    gap = (got.double() - want).abs()
    return float((gap / want.abs().clamp_min(1e-30)).max()) if gap.numel() \
        else 0.0


def _blocks(x, sizes):
    """``x`` as the reference's blocks: a list already, or one tensor cut
    into pieces of ``sizes`` rows."""
    return x if isinstance(x, list) else list(torch.split(x, sizes))


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, each against its own limit: the join's row
    count, the capacity its output was sized to (from the most rows one
    card joined, when the program gives it), the group count, the group
    keys that differ (all of them when the group counts differ), validity
    and the widest relative gaps of SUM and MEAN.  ``got`` is the
    program's answer (every group on one card, by key) or the control's
    blocks."""
    per_card = got.get("join_rows_per_card")
    join_rows = sum(per_card) if per_card is not None else got["join_rows"]
    out = {
        "join_rows_gap": abs(join_rows - want["join_rows"]),
        "sized_rows_gap": (abs(got["capacity"] - cap_round(max(per_card)))
                           if per_card is not None else 0),
        "groups_gap": abs(got["groups"] - want["groups"]),
        "validity_wrong": 0 if got["valid"] else 1,
    }
    if got["groups"] != want["groups"]:
        out["keys_differing"] = max(got["groups"], want["groups"])
        out["sum_rel_gap"] = out["mean_rel_gap"] = float("inf")
        return out
    sizes = [k.numel() for k in want["keys"]]
    differing, sum_gap, mean_gap = 0, 0.0, 0.0
    for gk, gs, gm, wk, ws, wm in zip(
            _blocks(got["keys"], sizes), _blocks(got["sum"], sizes),
            _blocks(got["mean"], sizes), want["keys"], want["sum"],
            want["mean"]):
        dev = wk.device
        differing += int((gk.to(dev) != wk).sum())
        sum_gap = max(sum_gap, _max_rel(gs.to(dev), ws))
        mean_gap = max(mean_gap, _max_rel(gm.to(dev), wm))
    out["keys_differing"] = differing
    if differing:
        sum_gap = mean_gap = float("inf")
    out["sum_rel_gap"], out["mean_rel_gap"] = sum_gap, mean_gap
    return out
