"""Collectives over a mesh of shards, in one process or across a process
group.

The port of ``cylon_tpu/parallel/collectives.py:17-50``.  There each
collective runs inside ``shard_map`` on one shard's value; here one call
takes the list of this process's shard tensors (shard ``i``'s on
``devices[i]``) and returns the list of results, each on its shard's
device.

In one process (``group=None``) the list holds every shard, and moves
between devices are ``Tensor.to``; shards that share a device exchange by
copies within it.  Over a process group (``context.Group``, process ``p``
holding global shards ``[p*L, (p+1)*L)``) each collective runs its
in-process part over the local shards and crosses processes with ONE
torch collective on the group's device: ``all_gather`` for ``allgather``
and ``process_allgather``, ``all_reduce`` after a local fold for the
reductions, ``all_to_all_single`` for ``all_to_all``.  Every byte that
crosses travels as a ``uint8`` view, so no backend needs the buffers'
own dtype; the reductions keep signed carriers (gloo does not reduce
torch's unsigned 32/64-bit types).  Results are those of the
one-process mesh of the same world, bit for bit: a float sum gathers the
per-shard partials and folds them in global shard order, as one process
would.

``LAUNCHES`` counts each family's launches, one per call that moves data:
over a group its one torch collective, in one process its copies or fold
between the shards (``process_allgather`` without a group moves nothing
and counts nothing).  The cylint budgets read it.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

LAUNCHES = {"allgather": 0, "process_allgather": 0, "allreduce_sum": 0,
            "allreduce_min": 0, "allreduce_max": 0, "all_to_all": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A flat ``uint8`` view of a contiguous tensor (a copy if it is not
    contiguous)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _gather_across(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's ``x`` (one shape on every process), concatenated
    along dim 0 in process order, on the group's device."""
    import torch.distributed as dist

    x = x.to(group.device)
    mine = _bytes(x)
    parts = [torch.empty_like(mine) for _ in range(group.size)]
    dist.all_gather(parts, mine)
    return torch.cat(parts).view(x.dtype).reshape(
        (group.size * x.shape[0],) + tuple(x.shape[1:]))


def allgather(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
              group=None) -> List[torch.Tensor]:
    """Every shard receives the concatenation, in global shard order, of
    every shard's tensor along dim 0.  Across processes every shard's
    tensor must have one shape."""
    LAUNCHES["allgather"] += 1
    if group is None:
        return [torch.cat([x.to(dev) for x in xs]) for dev in devices]
    local = torch.cat([x.to(group.device) for x in xs])
    whole = _gather_across(local, group)
    return [whole.to(dev) for dev in devices]


def process_allgather(x: np.ndarray, group) -> np.ndarray:
    """A host array of one shape on every process -> the concatenation of
    every process's along axis 0, in process order (the counterpart of
    ``multihost_utils.process_allgather(..., tiled=True)``,
    ``cylon_tpu/table.py:225-228``); ``x`` itself without a group."""
    x = np.ascontiguousarray(x)
    if group is None:
        return x
    LAUNCHES["process_allgather"] += 1
    return _gather_across(torch.from_numpy(x), group).cpu().numpy()


def _allreduce(xs, devices, fn, op, group) -> List[torch.Tensor]:
    LAUNCHES[f"allreduce_{op}"] += 1
    acc = xs[0]
    for x in xs[1:]:
        acc = fn(acc, x.to(acc.device))
    if group is not None:
        import torch.distributed as dist

        if op == "sum" and acc.is_floating_point():
            # the partials folded in global shard order: the one-process
            # sum's rounding, bit for bit
            parts = _gather_across(
                torch.stack([x.to(group.device) for x in xs]), group)
            acc = parts[0]
            for x in parts[1:]:
                acc = fn(acc, x)
        else:
            shape = acc.shape
            acc = acc.to(group.device).reshape(-1).clone()
            dist.all_reduce(acc, op={"sum": dist.ReduceOp.SUM,
                                     "min": dist.ReduceOp.MIN,
                                     "max": dist.ReduceOp.MAX}[op])
            acc = acc.reshape(shape)
    return [acc.to(dev) for dev in devices]


def allreduce_sum(xs, devices, group=None) -> List[torch.Tensor]:
    return _allreduce(xs, devices, torch.add, "sum", group)


def allreduce_min(xs, devices, group=None) -> List[torch.Tensor]:
    return _allreduce(xs, devices, torch.minimum, "min", group)


def allreduce_max(xs, devices, group=None) -> List[torch.Tensor]:
    return _allreduce(xs, devices, torch.maximum, "max", group)


def all_to_all(send: Sequence[torch.Tensor], send_sizes: np.ndarray,
               out: Sequence[torch.Tensor], group=None
               ) -> Sequence[torch.Tensor]:
    """The exact-size exchange (``ragged_all_to_all`` in the reference).

    ``send[i]`` holds local shard ``i``'s rows (``[n]`` or ``[n, width]``)
    grouped by destination, and ``send_sizes[s, d]`` (host integers, the
    GLOBAL ``[world, world]`` matrix) counts the rows global shard ``s``
    sends to ``d``.  Destination ``d`` receives, in global source-rank
    order, each source's slice for ``d``, front-packed into ``out`` (which
    lies on ``d``'s device and must hold them); rows of ``out`` past the
    received total are left as they are."""
    local = len(send)
    world = local * (group.size if group is not None else 1)
    sizes = np.asarray(send_sizes, dtype=np.int64).reshape(world, world)
    in_off = np.concatenate([np.zeros((world, 1), np.int64),
                             np.cumsum(sizes, axis=1)[:, :-1]], axis=1)
    first = group.rank * local if group is not None else 0
    recv_total = sizes.sum(axis=0)
    for j in range(local):
        if recv_total[first + j] > out[j].shape[0]:
            raise ValueError(f"all_to_all: shard {first + j} receives "
                             f"{int(recv_total[first + j])} rows into "
                             f"{out[j].shape[0]}")
    LAUNCHES["all_to_all"] += 1
    if group is not None:
        return _all_to_all_across(send, sizes, in_off, out, group)
    for d in range(world):
        at = 0
        for s in range(world):
            n = int(sizes[s, d])
            if n:
                lo = int(in_off[s, d])
                out[d][at:at + n].copy_(send[s][lo:lo + n], non_blocking=True)
                at += n
    return out


def _all_to_all_across(send, sizes, in_off, out, group):
    """``all_to_all`` over a process group: this process packs, per peer
    process ``q`` in order, each local source's rows for ``q``'s shards
    (one contiguous run of a source's target-grouped rows), ONE
    ``all_to_all_single`` moves the bytes (self included), and each local
    destination takes its segments in global source order.  With one
    local shard the send buffer is the source itself and the receive
    buffer is the destination: the bytes arrive in source order."""
    import torch.distributed as dist

    L, P, p = len(send), group.size, group.rank
    dev = group.device
    row_shape = tuple(send[0].shape[1:])
    row_bytes = send[0].element_size() * math.prod(row_shape)
    mine, theirs = slice(p * L, (p + 1) * L), [slice(q * L, (q + 1) * L)
                                               for q in range(P)]
    send_rows = [int(sizes[mine, t].sum()) for t in theirs]
    recv_rows = [int(sizes[t, mine].sum()) for t in theirs]
    if L == 1 and send[0].device == dev:
        sendbuf = send[0][:sum(send_rows)]
    else:
        pieces = []
        for t in theirs:
            for i in range(L):
                n = int(sizes[p * L + i, t].sum())
                lo = int(in_off[p * L + i, t.start])
                pieces.append(send[i][lo:lo + n].to(dev))
        sendbuf = torch.cat(pieces)
    direct = L == 1 and out[0].device == dev
    recvbuf = (out[0][:sum(recv_rows)] if direct else
               torch.empty((sum(recv_rows),) + row_shape,
                           dtype=send[0].dtype, device=dev))
    dist.all_to_all_single(
        _bytes(recvbuf), _bytes(sendbuf),
        [n * row_bytes for n in recv_rows],
        [n * row_bytes for n in send_rows])
    if direct:
        return out
    # recvbuf holds, for each global source s in order, its rows for each
    # local destination j in order
    at, fill = 0, [0] * L
    for s in range(P * L):
        for j in range(L):
            n = int(sizes[s, p * L + j])
            if n:
                out[j][fill[j]:fill[j] + n].copy_(recvbuf[at:at + n],
                                                  non_blocking=True)
            fill[j] += n
            at += n
    return out
