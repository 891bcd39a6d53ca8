"""The all-to-all table shuffle, in its exact-traffic form.

The port of ``cylon_tpu/parallel/shuffle.py``'s ragged shuffle
(``shuffle_shard_ragged:255``: the packed branch ``:292-318`` and the
per-buffer branch ``:320-343``), with ``buffer_count:48``,
``target_counts:63``, ``_remap_oob_targets:90``, ``_perm_by_target:99``
and ``plan_shuffle:226``; ``ragged_plan:239``'s offsets are computed by
``collectives.all_to_all``.  The reference's shard body
calls the collective in its middle; a single controller cannot stop one
shard's function halfway, so the body is split around the exchange:

1. before it, for every shard of this process: counts per target and the
   stable grouping of rows by target (``target_counts``,
   ``_perm_by_target``), each buffer gathered into that order; the count
   matrix is the global one (``count_matrix``: across processes, one
   all-gather of the local rows, as the reference's);
2. the exchange across the list of shards (``collectives.all_to_all``),
   which lands every shard's rows front-packed in global source-rank
   order:
   per buffer, one exchange for each buffer (a string column moves three:
   its ``[n, width]`` byte matrix, validity and lengths,
   ``cylon_tpu/parallel/shuffle.py:217-218, 340``); packed, every shard's
   columns packed into one plane (``plane.py``, compressed under a spec),
   grouped by target with one gather and moved in ONE exchange, then
   decoded.

A shard receives into zeroed buffers of ``plan_shuffle``'s capacity, so
rows past its count hold zero data (bytes and lengths) and validity False:
slot for slot what the reference's bucketed ``shuffle_shard`` gives on its
CPU mesh, where null rows hold zero data too.  A zeroed plane decodes to
the same, and under a spec the rows past the count are masked
(``tail_mask``), so all three realizations give bit-identical shards.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import column
from ..column import Column
from ..obs import spans as obs_spans
from ..ops import compact
from ..utils import pow2ceil
from . import collectives
from . import plane as plane_mod


#: widest target alphabet (world + 1) counted by one compare-and-reduce
#: (the reference's cutoff, ``cylon_tpu/parallel/shuffle.py``)
_WIDE_MESH_CUTOFF = 32


def buffer_count(cols: Sequence[Column]) -> int:
    """Buffers a per-buffer exchange moves: data and validity per column,
    and a string's lengths; the per-buffer collective launch count."""
    return sum(2 + (1 if c.lengths is not None else 0) for c in cols)


def _remap_oob_targets(targets: torch.Tensor, world: int) -> torch.Tensor:
    """Out-of-range targets, negative included, become padding (== world),
    so a producer bug drops rows instead of sending them to shard 0."""
    bad = (targets < 0) | (targets > world)
    return torch.where(bad, torch.full((), world, dtype=targets.dtype,
                                       device=targets.device), targets)


def target_counts(targets: torch.Tensor, world: int) -> torch.Tensor:
    """int32[world]: rows this shard sends to each target (padding rows
    carry target == world and fall off the end).

    While ``world + 1 <= 32`` a compare-and-reduce over the target
    alphabet, which needs no host sync (``torch.bincount`` reads the
    targets' range on the host).  Past that, where the [rows, world]
    compare would dwarf the rows, the histogram."""
    if world + 1 <= _WIDE_MESH_CUTOFF:
        alphabet = torch.arange(world, dtype=targets.dtype,
                                device=targets.device)
        return (targets[:, None] == alphabet[None, :]).sum(
            0, dtype=torch.int32)
    t = _remap_oob_targets(targets, world)
    return torch.bincount(t, minlength=world + 1)[:world].to(torch.int32)


def _perm_by_target(targets: torch.Tensor, world: int) -> torch.Tensor:
    """Stable permutation grouping rows by target, padding (== world)
    last: one stable sort (the reference's counting scan and its sort
    give this same permutation)."""
    return torch.sort(_remap_oob_targets(targets, world), stable=True).indices


def plan_shuffle(cm: np.ndarray) -> int:
    """Host-side sizing from the [world, world] count matrix: every
    shard's receive capacity, the power of two holding the most incoming
    rows.  (The reference also returns the bucketed shuffle's per-pair
    bucket, which the exact-traffic shuffle does not use.)"""
    cm = np.asarray(cm)
    return pow2ceil(int(cm.sum(axis=0).max()) if cm.size else 0)


def count_matrix(counts: Sequence[torch.Tensor], group=None) -> np.ndarray:
    """The global count matrix on the host (a row per shard, a column per
    target), from this process's shards' ``target_counts``: one host copy
    in one process (a span ``sync.shuffle_counts``); over a process group,
    one all-gather of the local rows, as the reference all-gathers it."""
    dev = counts[0].device if group is None else group.device
    local = torch.stack([c.to(dev) for c in counts])
    if group is not None:
        local = collectives.allgather([local], [dev], group)[0]
    return obs_spans.host_read(local, "shuffle_counts").numpy()


def shuffle_shard_ragged(shards: Sequence[Sequence[Column]],
                         targets: Sequence[torch.Tensor], cm: np.ndarray,
                         world: int, out_capacity: int,
                         devices: Sequence[torch.device],
                         packed: bool = False, spec=None, group=None,
                         shard_ids: Sequence[int] = ()
                         ) -> Tuple[List[Tuple[Column, ...]], List[int]]:
    """Shuffle this process's shards' rows to their targets: per local
    shard, columns of capacity ``out_capacity``, rows front-packed in
    global source-rank order, and its received row count.  ``cm`` is the
    global count matrix of these ``targets``; over a process ``group``
    the local shards are the global ``shard_ids``.  ``packed`` moves one
    plane (compressed under ``spec``) instead of every buffer; the shards
    are bit-identical either way."""
    perms = [_perm_by_target(t, world) for t in targets]
    ids = list(shard_ids) or list(range(len(shards)))
    totals = [int(n) for n in np.asarray(cm).sum(axis=0)[ids]]
    ncols = len(shards[0])
    if packed:
        return _packed_exchange(shards, perms, cm, totals, out_capacity,
                                devices, spec, group, world), totals
    recv: List[List[Column]] = [[] for _ in shards]

    def exchange(bufs):
        """One buffer of every shard, each grouped by target, exchanged
        into zeroed receive buffers of ``out_capacity`` rows."""
        out = [torch.zeros((out_capacity,) + tuple(bufs[0].shape[1:]),
                           dtype=bufs[0].dtype, device=dev)
               for dev in devices]
        return collectives.all_to_all(bufs, cm, out, group)

    with obs_spans.span("shuffle.collective", devices=devices,
                        family="all_to_all", packed=False,
                        launches=buffer_count(shards[0])):
        for j in range(ncols):
            cols = [s[j] for s in shards]
            data = exchange([column.gather(c.data, p)
                             for c, p in zip(cols, perms)])
            valid = exchange([c.validity[p] for c, p in zip(cols, perms)])
            lengths = ([None] * len(shards) if cols[0].lengths is None else
                       exchange([c.lengths[p] for c, p in zip(cols,
                                                               perms)]))
            for d in range(len(shards)):
                recv[d].append(Column(data[d], valid[d], lengths[d],
                                      cols[0].dtype))
    return [tuple(cols) for cols in recv], totals


def _packed_exchange(shards, perms, cm, totals, out_capacity, devices,
                     spec, group, world) -> List[Tuple[Column, ...]]:
    """The packed branch: each shard's plane (under ``spec``) grouped by
    target with one gather, ONE exchange into zeroed receive planes, and
    the decode.  No validity mask on decode: a null row's bits travel as
    the per-buffer branch moves them, and a zero plane row decodes to
    validity False and zero data, as the per-buffer branch's unwritten
    tail.  Under a spec a zero field no longer decodes to zero (to the
    offset, or to dictionary entry 0), so the rows past each received
    total are masked (``tail_mask``)."""
    codec = plane_mod.PlaneCodec(shards, spec, devices, group, world)
    with obs_spans.span("shuffle.pack", columns=len(shards[0])) as sp:
        planes = [codec.pack(s)[p] for s, p in enumerate(perms)]
        sp.set(words=int(planes[0].shape[1]), compressed=spec is not None)
    with obs_spans.span("shuffle.collective", devices=devices,
                        family="all_to_all", packed=True, launches=1):
        out = [torch.zeros((out_capacity, planes[0].shape[1]),
                           dtype=planes[0].dtype, device=dev)
               for dev in devices]
        got = list(collectives.all_to_all(planes, cm, out, group))
    del planes, out  # the sent planes are freed before any decode
    with obs_spans.span("shuffle.unpack", columns=len(shards[0])):
        recv = []
        for d, (total, dev) in enumerate(zip(totals, devices)):
            g, got[d] = got[d], None  # each received plane freed once decoded
            tail = (None if spec is None else
                    compact.live_mask(out_capacity, total, dev))
            recv.append(codec.unpack(g, d, tail_mask=tail))
            del g
    return recv
