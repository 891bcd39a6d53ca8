"""Row -> target-shard assignment: by key hash, or by range.

The port of ``cylon_tpu/parallel/partition.py:40 hash_targets`` and
``:62 range_targets``.  The reference hashes fixed-width keys with the
Pallas murmur3 kernel on a TPU and with its jnp row hash elsewhere, and
every key set holding a string with the jnp hash on every device.  The
port hashes fixed-width keys with murmur3 on every device (the CUDA kernel
on the card, its plain version on the CPU), so it places those rows as the
reference does on a TPU; a key set holding a string takes
``ops/hashing.py``, the jnp hash's copy, so it places those rows as the
reference does everywhere.  The range partitioner takes the same samples,
bins and collectives as the reference, so its targets agree with the
reference's on every device.

``column_stats`` (``partition.py:150 stats_arity``, ``:157
column_stats``) observes what the compressed exchange needs of every
column: value ranges, string extents and distinct counts, reduced across
shards (and processes) with ``collectives.allreduce_min`` /
``allreduce_max`` so every shard sees the same values and derives the
same ``plane.build_spec``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import precision
from ..column import Column
from ..ops import compact, hash_kernels, hashing, keys
from . import collectives
from . import plane as plane_mod


def hash_targets(cols: Sequence[Column], count, key_idx: Sequence[int],
                 world: int) -> torch.Tensor:
    """int32[cap] target shard per row; padding rows (``row >= count``) get
    ``world``, a bucket nothing is sent to."""
    key_cols = [cols[i] for i in key_idx]
    if hash_kernels.supported(key_cols):
        _, t = hash_kernels.hash_partition(key_cols, world)
    else:
        h = hashing.hash_columns(key_cols)
        t = (h & (world - 1) if world & (world - 1) == 0
             else h % world).to(torch.int32)
    live = compact.live_mask(t.shape[0], count, t.device)
    return torch.where(live, t, torch.full((), world, dtype=torch.int32,
                                           device=t.device))


def string_prefix(col: Column) -> torch.Tensor:
    """int64[cap]: a string column's first 4 bytes as a big-endian uint32
    (zero past its width), whose order is the bytewise order of those
    bytes: the range partitioner's key for a string lead column
    (``cylon_tpu/parallel/partition.py:80-86``)."""
    data = col.data[:, :4].to(torch.int64)
    out = torch.zeros(col.capacity, dtype=torch.int64, device=col.device)
    for i in range(data.shape[1]):
        out = out | (data[:, i] << (24 - 8 * i))
    return out


def _clipped_int(x: torch.Tensor, hi: int) -> torch.Tensor:
    """``clip(int32(x), 0, hi)`` with XLA's conversion rules (NaN -> 0,
    saturation), which torch's cast leaves undefined."""
    x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                device=x.device), x)
    return x.clamp(0, hi).to(torch.int32)


def range_targets(cols: Sequence[Column], counts, devices, *, num_bins: int,
                  num_samples: int, ascending: bool = True,
                  nulls_first: bool = True, group=None
                  ) -> List[torch.Tensor]:
    """Per local shard, int32[cap] range-partition targets of its sort
    column ``cols[s]``, globally monotone: every row of shard t orders
    before every row of shard t+1.  Padding rows get ``world``, the
    global shard count (the local shards times the processes of
    ``group``), over which the allreduces run.

    As the reference (arrow_partition_kernels.hpp:394-519
    RangePartitionKernel): global min and max by allreduce, a stride
    sample of each shard's live rows binned into ``num_bins``, one
    allreduce of the histogram, and a bin -> shard map from each bin's
    cumulative mass midpoint; descending order flips it, and nulls go to
    shard 0 (``nulls_first``) or ``world - 1``.  The bins are float32 in
    narrow mode and float64 in wide, computed with the same operations
    in the same order as the reference.  A string column bins on its
    first 4 bytes (``string_prefix``): keys sharing them share a bin, which
    costs balance, never order."""
    world = len(cols) * (group.size if group is not None else 1)
    facc = precision.float_acc(cols[0].device)
    big = torch.finfo(facc).max
    fdatas, lives, lmins, lmaxs = [], [], [], []
    for col, count in zip(cols, counts):
        live = compact.live_mask(col.capacity, count, col.device) \
            & col.validity
        data = string_prefix(col) if col.is_string else col.data
        if data.dtype == torch.bool:
            data = data.to(torch.int32)
        fdata = data.to(facc)
        lmins.append(torch.where(live, fdata, big).min())
        lmaxs.append(torch.where(live, fdata, -big).max())
        fdatas.append(fdata)
        lives.append(live)
    gmins = collectives.allreduce_min(lmins, devices, group)
    gmaxs = collectives.allreduce_max(lmaxs, devices, group)

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
    hists = collectives.allreduce_sum(hists, devices, group)

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


# -- the compression pre-pass ----------------------------------------------

def stats_arity(cols: Sequence[Column]) -> int:
    """How many stats ``column_stats`` returns for this schema."""
    lay = plane_mod.stats_layout(cols)
    return sum(2 if k == "int" else 3 if k == "str" else 0 for k in lay)


def _value_range(dtype: torch.dtype) -> Tuple[int, int]:
    w = dtype.itemsize * 8
    if dtype.is_signed:
        return -(1 << (w - 1)), (1 << (w - 1)) - 1
    return 0, (1 << w) - 1


def column_stats(shards: Sequence[Sequence[Column]], counts,
                 devices, group=None) -> Tuple[int, ...]:
    """The observed stats of every LIVE row, the same on every shard (of
    every process of ``group``), as host integers in
    ``plane.stats_layout``'s order: (min, max) per
    integer column; (nonzero byte extent, max length, max per-shard
    distinct count) per string column.

    A row is live by ``row < count``, not by validity: a null row's raw
    bits travel through the exchange and must lie inside the observed
    range, while padding rows are never sent.  Unsigned columns reduce
    through ``keys.signed_carrier`` (the CPU has no unsigned min/max);
    uint64's carrier is the value less 2^63, which the host adds back.
    The distinct count collapses non-live rows into one sentinel group,
    as the reference's does, so it bounds the codec's local
    dictionary."""
    cols0 = shards[0]
    lives = [compact.live_mask(cols[0].capacity, n, cols[0].device)
             for cols, n in zip(shards, counts)]
    stats: List[torch.Tensor] = []
    biases: List[int] = []
    for j, kind in enumerate(plane_mod.stats_layout(cols0)):
        if kind == "int":
            dt = cols0[j].data.dtype
            bias = (1 << 63) if dt == torch.uint64 else 0
            lo, hi = (v - bias for v in _value_range(dt))
            mins, maxs = [], []
            for cols, live in zip(shards, lives):
                carrier = keys.signed_carrier(cols[j].data)[0]
                mins.append(torch.where(live, carrier, hi).min()
                            .to(torch.int64))
                maxs.append(torch.where(live, carrier, lo).max()
                            .to(torch.int64))
            stats += [collectives.allreduce_min(mins, devices, group)[0],
                      collectives.allreduce_max(maxs, devices, group)[0]]
            biases += [bias, bias]
        elif kind == "str":
            extents, maxlens, distinct = [], [], []
            for cols, live in zip(shards, lives):
                c = cols[j]
                w = c.string_width
                if w:
                    nz = ((c.data != 0) & live[:, None]).any(dim=0)
                    pos = torch.arange(1, w + 1, dtype=torch.int64,
                                       device=c.device)
                    extents.append(torch.where(nz, pos, 0).max())
                else:
                    extents.append(torch.zeros((), dtype=torch.int64,
                                               device=c.device))
                maxlens.append(torch.where(live, c.lengths, 0).max()
                               .to(torch.int64))
                kws = [torch.where(live, wv, plane_mod._SENT64)
                       for wv in plane_mod.string_key_words(c)]
                flag = plane_mod.sorted_distinct_flags(kws)[1]
                distinct.append(flag.sum(dtype=torch.int64))
            stats += [collectives.allreduce_max(x, devices, group)[0]
                      for x in (extents, maxlens, distinct)]
            biases += [0, 0, 0]
    if not stats:
        return ()
    dev = stats[0].device
    host = torch.stack([x.to(dev) for x in stats]).cpu().tolist()
    return tuple(int(v) + b for v, b in zip(host, biases))
