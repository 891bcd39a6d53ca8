"""In-process collectives over a mesh of shards.

The port of ``cylon_tpu/parallel/collectives.py:17-50``.  There each
collective runs inside ``shard_map`` on one shard's value; here one call
takes the list of every shard's tensor (shard ``i``'s on ``devices[i]``)
and returns the list of results, each on its shard's device.  Moves
between devices are ``Tensor.to``; shards that share a device exchange by
copies within it.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def allgather(xs: Sequence[torch.Tensor],
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard receives the concatenation, in shard order, of every
    shard's tensor along dim 0."""
    out = []
    for dev in devices:
        out.append(torch.cat([x.to(dev) for x in xs]))
    return out


def _allreduce(xs, devices, fn) -> List[torch.Tensor]:
    acc = xs[0]
    for x in xs[1:]:
        acc = fn(acc, x.to(acc.device))
    return [acc.to(dev) for dev in devices]


def allreduce_sum(xs, devices) -> List[torch.Tensor]:
    return _allreduce(xs, devices, torch.add)


def allreduce_min(xs, devices) -> List[torch.Tensor]:
    return _allreduce(xs, devices, torch.minimum)


def allreduce_max(xs, devices) -> List[torch.Tensor]:
    return _allreduce(xs, devices, torch.maximum)


def all_to_all(send: Sequence[torch.Tensor], send_sizes: np.ndarray,
               out: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """The exact-size exchange (``ragged_all_to_all`` in the reference).

    ``send[s]`` holds shard ``s``'s rows (``[n]`` or ``[n, width]``)
    grouped by destination, and
    ``send_sizes[s, d]`` (host integers) counts the rows it sends to ``d``.
    Destination ``d`` receives, in source-rank order, each source's slice
    for ``d``, front-packed into ``out[d]`` (which lies on ``d``'s device
    and must hold them); rows of ``out[d]`` past the received total are
    left as they are."""
    world = len(send)
    sizes = np.asarray(send_sizes, dtype=np.int64).reshape(world, world)
    in_off = np.concatenate([np.zeros((world, 1), np.int64),
                             np.cumsum(sizes, axis=1)[:, :-1]], axis=1)
    recv_total = sizes.sum(axis=0)
    for d in range(world):
        if recv_total[d] > out[d].shape[0]:
            raise ValueError(f"all_to_all: shard {d} receives "
                             f"{int(recv_total[d])} rows into "
                             f"{out[d].shape[0]}")
        at = 0
        for s in range(world):
            n = int(sizes[s, d])
            if n:
                lo = int(in_off[s, d])
                out[d][at:at + n].copy_(send[s][lo:lo + n], non_blocking=True)
                at += n
    return out
