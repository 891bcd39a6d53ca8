"""Row -> target-shard assignment: by key hash, or by range.

The port of ``cylon_tpu/parallel/partition.py:40 hash_targets`` and
``:62 range_targets``.  The reference hashes with the Pallas murmur3
kernel on a TPU and with a jnp hash elsewhere; the port hashes with
murmur3 on every device (the CUDA kernel on the card, its plain version
on the CPU), so it places rows as the reference does on a TPU.  The range
partitioner takes the same samples, bins and collectives as the
reference, so its targets agree with the reference's on every device.
``column_stats`` waits for the packed plane (``plane.py``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .. import precision
from ..column import Column
from ..ops import compact, hash_kernels
from ..status import Code, CylonError
from . import collectives


def hash_targets(cols: Sequence[Column], count, key_idx: Sequence[int],
                 world: int) -> torch.Tensor:
    """int32[cap] target shard per row; padding rows (``row >= count``) get
    ``world``, a bucket nothing is sent to."""
    _, t = hash_kernels.hash_partition([cols[i] for i in key_idx], world)
    live = compact.live_mask(t.shape[0], count, t.device)
    return torch.where(live, t, torch.full((), world, dtype=torch.int32,
                                           device=t.device))


def _clipped_int(x: torch.Tensor, hi: int) -> torch.Tensor:
    """``clip(int32(x), 0, hi)`` with XLA's conversion rules (NaN -> 0,
    saturation), which torch's cast leaves undefined."""
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                device=x.device), x)
    return x.clamp(0, hi).to(torch.int32)


def range_targets(cols: Sequence[Column], counts, devices, *, num_bins: int,
                  num_samples: int, ascending: bool = True,
                  nulls_first: bool = True) -> List[torch.Tensor]:
    """Per shard, int32[cap] range-partition targets of its sort column
    ``cols[s]``, globally monotone: every row of shard t orders before
    every row of shard t+1.  Padding rows get ``world``.

    As the reference (arrow_partition_kernels.hpp:394-519
    RangePartitionKernel): global min and max by allreduce, a stride
    sample of each shard's live rows binned into ``num_bins``, one
    allreduce of the histogram, and a bin -> shard map from each bin's
    cumulative mass midpoint; descending order flips it, and nulls go to
    shard 0 (``nulls_first``) or ``world - 1``.  The bins are float32 in
    narrow mode and float64 in wide, computed with the same operations
    in the same order as the reference."""
    world = len(cols)
    if cols[0].is_string:
        raise CylonError(Code.NotImplemented, "range partitioning on string "
                         "columns is not ported yet")
    facc = precision.float_acc(cols[0].device)
    big = torch.finfo(facc).max
    fdatas, lives, lmins, lmaxs = [], [], [], []
    for col, count in zip(cols, counts):
        live = compact.live_mask(col.capacity, count, col.device) \
            & col.validity
        data = col.data
        if data.dtype == torch.bool:
            data = data.to(torch.int32)
        fdata = data.to(facc)
        lmins.append(torch.where(live, fdata, big).min())
        lmaxs.append(torch.where(live, fdata, -big).max())
        fdatas.append(fdata)
        lives.append(live)
    gmins = collectives.allreduce_min(lmins, devices)
    gmaxs = collectives.allreduce_max(lmaxs, devices)

    hists = []
    for fdata, live, gmin, gmax in zip(fdatas, lives, gmins, gmaxs):
        dev, cap = fdata.device, fdata.shape[0]
        span = torch.clamp(gmax - gmin, min=torch.finfo(facc).tiny)
        # a deterministic stride sample of the live rows (the reference
        # samples `num_samples` values per worker, partition.cpp:181),
        # taken from the compacted live rows
        n_live = live.sum(dtype=torch.int32)
        pos = (torch.arange(num_samples, dtype=facc, device=dev)
               * n_live.clamp(min=1).to(facc) / num_samples)
        pos = _clipped_int(pos, cap - 1)
        perm, m = compact.compact_indices(live)
        sample = fdata[perm[pos]]
        sample_ok = pos < m
        sbin = _clipped_int((sample - gmin) / span * num_bins, num_bins - 1)
        hists.append(torch.zeros(num_bins, dtype=torch.int32, device=dev)
                     .index_add_(0, sbin, sample_ok.to(torch.int32)))
    hists = collectives.allreduce_sum(hists, devices)

    out = []
    for col, count, fdata, gmin, gmax, hist in zip(cols, counts, fdatas,
                                                   gmins, gmaxs, hists):
        dev, cap = fdata.device, fdata.shape[0]
        span = torch.clamp(gmax - gmin, min=torch.finfo(facc).tiny)
        total = hist.sum(dtype=torch.int32).clamp(min=1)
        cum = torch.cumsum(hist, 0, dtype=torch.int32)
        mid = cum.to(facc) - hist.to(facc) / 2
        bin_part = _clipped_int(mid * world / total, world - 1)
        if not ascending:
            bin_part = (world - 1) - bin_part
        rbin = _clipped_int((fdata - gmin) / span * num_bins, num_bins - 1)
        t = bin_part[rbin]
        null_target = torch.full((), 0 if nulls_first else world - 1,
                                 dtype=torch.int32, device=dev)
        t = torch.where(col.validity, t, null_target)
        out.append(torch.where(compact.live_mask(cap, count, dev), t,
                               torch.full((), world, dtype=torch.int32,
                                          device=dev)))
    return out
