"""The two tables of upstream Cylon's distributed join benchmark, each
card drawing its own share where it lives, as each rank of the source
does: per side and per card an int32 key uniform over ``key_domain`` and
a float32 value uniform in [0, 1), ``rows_per_side`` split evenly over
the cards.  Every column is a list of per-card tensors.

Every seed gets the same work: each card's keys are drawn from a
generator seeded by ``shape_seed``, the side and the card, so the keys'
multiset, the join count and the group count are the same for all
seeds.  The seed relabels the keys by one bijection of the domain shared
by both sides (so matches stay matches), ``k -> (a * k + b) mod domain``
with an odd ``a``, which needs no table and fits beside the inputs, and
draws the values."""
from __future__ import annotations

import random

import torch

SIDES = ("left", "right")


def generate(config: dict, seed: int, devices) -> dict:
    """{"left": {"k", "v"}, "right": {"k", "v"}}, each column a list of
    one tensor a card of ``devices``."""
    n, domain = config["rows_per_side"], config["key_domain"]
    cards = len(devices)
    if n % cards:
        raise ValueError(f"{n} rows do not split over {cards} cards")
    if domain < 2 or domain & (domain - 1):
        raise ValueError(f"key_domain must be a power of two, got {domain}")
    rng = random.Random(seed)
    a, b = rng.randrange(domain) | 1, rng.randrange(domain)
    value_seeds = rng.getrandbits(62)
    out = {side: {"k": [], "v": []} for side in SIDES}
    for s, side in enumerate(SIDES):
        for c, dev in enumerate(devices):
            shape = torch.Generator(device=dev)
            shape.manual_seed((config["shape_seed"] * 2 + s) * cards + c)
            k = torch.randint(0, domain, (n // cards,), generator=shape,
                              device=dev)
            k = k.mul_(a).add_(b).bitwise_and_(domain - 1).to(torch.int32)
            g = torch.Generator(device=dev)
            g.manual_seed(value_seeds + s * cards + c)
            out[side]["k"].append(k)
            out[side]["v"].append(torch.rand(n // cards, generator=g,
                                             device=dev, dtype=torch.float32))
    return out
