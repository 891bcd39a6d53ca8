"""The two tables of upstream Cylon's join benchmark on the card from a
seed: per side an int32 key uniform over ``key_domain`` and a float32
value uniform in [0, 1) (the shape of ``generate_csv.py`` and
``bench.py``'s ``_make_data``).

Every seed gets the same work: the keys' multiset is drawn once from
``shape_seed``, so the join count, the group count and every capacity the
program sizes from them are the same for all seeds.  The seed relabels
the keys by a random permutation of the key domain (the same on both
sides, so matches stay matches), shuffles each side's rows, and draws the
values."""
from __future__ import annotations

import torch


def generate(config: dict, seed: int, device) -> dict:
    """{"left": {"k", "v"}, "right": {"k", "v"}} of ``rows_per_side``
    rows each."""
    n, domain = config["rows_per_side"], config["key_domain"]
    shape = torch.Generator(device=device)
    shape.manual_seed(config["shape_seed"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    relabel = torch.randperm(domain, generator=g, device=device)
    out = {}
    for side in ("left", "right"):
        k = torch.randint(0, domain, (n,), generator=shape, device=device)
        k = relabel[k[torch.randperm(n, generator=g, device=device)]]
        v = torch.rand(n, generator=g, device=device, dtype=torch.float32)
        out[side] = {"k": k.to(torch.int32), "v": v}
    del relabel
    return out
