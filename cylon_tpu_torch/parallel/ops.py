"""Distributed operators over a mesh of shards (in one process, or over a
process group): hash and range shuffles, local HashPartition, broadcast,
distributed sort, the distributed group-bys, scalar aggregates.

The port of ``cylon_tpu/parallel/ops.py``: ``_shuffled:378`` with
``_targets:162`` (hash and range modes), ``shuffle:486``,
``hash_partition:501``, ``broadcast_gather:295``,
``distributed_sort:576``, ``groupby_partial_plan:601``,
``finalize_groupby_columns:621``, ``distributed_groupby:662`` (hash and
pipeline, pre-partitioned, NUNIQUE and salted) and
``distributed_scalar_agg:836``, with the exchange accounting
``_row_bytes:234``, ``_record_exchange:249`` and ``_record_broadcast:279``.
Each keeps the reference's partition -> exchange -> local kernel shape;
where the reference runs one ``shard_map`` program per phase, the port
runs the phase for every local shard in turn.  ``world`` is always the
global shard count (``Table.num_shards``), the hash modulus and the
count matrix's size; the loops run over this process's shards.

The exchange realization (``plane.pack_enabled()``, packed or per buffer,
and ``plane.compress_enabled()`` on the packed plane) is read inside the
retried exchange, as the reference reads it.  The shuffle's exchange and
the broadcast's gather retry a transient failure under
``ctx.collective_retry_policy()`` (``resilience.retry_call``, sites
``shuffle`` and ``broadcast``, which are also fault-injection points).
``shuffle`` and the two-phase ``distributed_groupby`` stamp their output
with its placement (``_partitioning``, ``cylon_tpu/parallel/ops.py:490-497``
and ``:826-831``), which the planner reads to elide shuffles.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .. import dtypes, precision, resilience
from ..column import Column
from ..config import SortOptions
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..ops import aggregates as agg_mod
from ..ops import compact
from ..ops import groupby as groupby_mod
from ..ops import hashing, keys
from ..ops import sort as sort_mod
from ..ops import unique as unique_mod
from ..ops.groupby import AggOp
from ..status import Code, CylonError
from . import collectives, partition, plane as plane_mod
from . import shuffle as shuffle_mod


def _targets(t, key_idx: Tuple[int, ...], mode: str,
             opts: Optional[SortOptions]):
    """Every shard's target per row: by hash of the key columns, or by
    range of the first key column with ``opts``' defaults resolved as the
    reference resolves them."""
    world = t.num_shards
    if mode == "hash":
        return [partition.hash_targets(cols, n, key_idx, world)
                for cols, n in zip(t.shards, t.counts)]
    if mode != "range":
        raise CylonError(Code.Invalid, f"bad partition mode {mode!r}")
    opts = opts or SortOptions()
    return partition.range_targets(
        [cols[key_idx[0]] for cols in t.shards], t.counts, t.ctx.devices,
        num_bins=opts.num_bins or 16 * world,
        num_samples=opts.num_samples or 4096,
        ascending=opts.ascending, nulls_first=opts.nulls_first,
        group=t.ctx.group)


def _row_bytes(cols, packed: bool, spec=None) -> int:
    """Bytes one row moves: plane words when packed (compressed words
    under ``spec``); data, one validity byte and a string's lengths per
    buffer otherwise."""
    if packed:
        return plane_mod.plane_words(cols, spec) * 4
    total = 0
    for c in cols:
        total += c.data.dtype.itemsize * int(
            math.prod(c.data.shape[1:])) + 1  # data row + 1 validity byte
        if c.lengths is not None:
            total += c.lengths.dtype.itemsize
    return total


def _record_exchange(cols, packed: bool, family: str, rows_exchanged: int,
                     spec=None) -> None:
    """Account one exchange that ran: its data-collective launches (1
    packed, ``buffer_count`` per buffer), the count-matrix gather and the
    bytes moved.  Under a spec ``shuffle.bytes_sent`` is what travelled;
    the uncompressed bytes less it go to ``shuffle.bytes_saved`` and their
    ratio to the ``shuffle.compress_ratio`` gauge (the last exchange's)."""
    launches = 1 if packed else shuffle_mod.buffer_count(cols)
    bytes_sent = rows_exchanged * _row_bytes(cols, packed, spec)
    obs_metrics.counter_add("shuffle.exchanges")
    obs_metrics.counter_add("shuffle.collective_launches", launches)
    obs_metrics.counter_add("shuffle.counts_gathers")
    obs_metrics.counter_add("shuffle.bytes_sent", bytes_sent)
    if spec is not None:
        raw_bytes = rows_exchanged * _row_bytes(cols, packed)
        obs_metrics.counter_add("shuffle.bytes_saved",
                                max(0, raw_bytes - bytes_sent))
        if bytes_sent > 0:
            obs_metrics.gauge_set("shuffle.compress_ratio",
                                  raw_bytes / bytes_sent)
    obs_metrics.hist_observe("shuffle.bytes_per_exchange", bytes_sent)
    obs_spans.instant("shuffle.exchange_done", family=family, packed=packed,
                      compressed=spec is not None,
                      collective_launches=launches, rows=rows_exchanged)


def _record_broadcast(cols, packed: bool, world: int, rows_buf: int) -> None:
    """Account one broadcast: its own counter, not ``shuffle.exchanges``
    (a broadcast is the strategy that avoided an exchange); 1 all-gather
    packed, the counts' and one per buffer otherwise."""
    launches = 1 if packed else 1 + shuffle_mod.buffer_count(cols)
    bytes_sent = rows_buf * world * _row_bytes(cols, packed)
    obs_metrics.counter_add("shuffle.broadcasts")
    obs_metrics.counter_add("shuffle.collective_launches", launches)
    obs_metrics.counter_add("shuffle.bytes_sent", bytes_sent)
    obs_metrics.hist_observe("shuffle.bytes_per_exchange", bytes_sent)
    obs_spans.instant("shuffle.broadcast_done", packed=packed,
                      collective_launches=launches, rows=rows_buf * world)


def _shuffled(t, key_idx: Tuple[int, ...], mode: str = "hash",
              opts: Optional[SortOptions] = None):
    """partition -> exchange; returns the shuffled Table.  A transient
    failure (classified retryable) retries the whole plan and exchange
    under ``ctx.collective_retry_policy()``: the input table is untouched,
    so the retry is exact.  Compressing, the plan also observes every
    column (``partition.column_stats``) and the host folds the stats into
    the spec (``plane.build_spec``)."""
    world = t.num_shards
    devices, group = t.ctx.devices, t.ctx.group

    def exchange():
        # the named injection site of the collective exchange
        resilience.fault_point("shuffle")
        pack = plane_mod.pack_enabled()
        compress = pack and plane_mod.compress_enabled()
        with obs_spans.span("shuffle.plan", mode=mode, world=world,
                            family="ragged"):
            targets = _targets(t, key_idx, mode, opts)
            cm = shuffle_mod.count_matrix(
                [shuffle_mod.target_counts(tg, world) for tg in targets],
                group)
            spec = None
            if compress:
                stats = partition.column_stats(t.shards, t.counts, devices,
                                               group)
                spec = plane_mod.build_spec(t.shards[0], stats, world,
                                            t.shard_capacity)
            out_cap = shuffle_mod.plan_shuffle(cm)
        with obs_spans.span("shuffle.exchange", packed=pack, family="ragged",
                            world=world, compressed=spec is not None):
            shards, totals = shuffle_mod.shuffle_shard_ragged(
                t.shards, targets, cm, world, out_cap, devices,
                packed=pack, spec=spec, group=group, shard_ids=t.shard_ids)
        # the exact-traffic exchange moves exactly the rows that exist
        _record_exchange(t.shards[0], pack, "ragged", int(cm.sum()),
                         spec=spec)
        return t._like(shards, totals)

    out, _attempts = resilience.retry_call(
        exchange, policy=t.ctx.collective_retry_policy(), site="shuffle")
    return out


def shuffle(t, key_idx: Tuple[int, ...]):
    """Hash-repartition rows so equal keys land on the same shard.  The
    result carries its placement, ``_partitioning = ("hash", ((key
    names,),), world)``, so a downstream planned join or group-by on
    compatible keys can skip its own exchange."""
    key_idx = tuple(key_idx)
    out = _shuffled(t, key_idx, "hash")
    out._partitioning = ("hash", (tuple(t.names[i] for i in key_idx),),
                         t.num_shards)
    return out


def hash_partition(t, key_idx: Tuple[int, ...], num_partitions: int):
    """Public HashPartition: split rows into ``num_partitions`` tables by
    key hash, shard-locally (no exchange).  Partition ``p``'s table holds,
    on every shard, that shard's rows hashing to ``p``, front-packed, at
    capacity ``min(pow2ceil(max count), shard capacity)``.  The split
    gathers each buffer with ``Column.take`` under either exchange
    realization: it moves nothing between shards, so a plane would save
    no collective.  Returns ``{partition_id: Table}``."""
    key_idx = tuple(key_idx)
    targets = [partition.hash_targets(cols, n, key_idx, num_partitions)
               for cols, n in zip(t.shards, t.counts)]
    cm = shuffle_mod.count_matrix([shuffle_mod.target_counts(tg,
                                                             num_partitions)
                                   for tg in targets], t.ctx.group)
    caps = [min(shuffle_mod.pow2ceil(c), t.shard_capacity)
            for c in cm.max(axis=0)]
    parts: Dict[int, object] = {}
    for p in range(num_partitions):
        shards, counts = [], []
        for cols, tgt in zip(t.shards, targets):
            perm, m = compact.compact_indices(tgt == p)
            idx = perm[:caps[p]]
            valid = compact.live_mask(caps[p], m, tgt.device)
            shards.append(tuple(c.take(idx, valid_mask=valid) for c in cols))
            counts.append(m.to(torch.int32))
        parts[p] = t._like(shards, counts)
    return parts


def broadcast_gather(t):
    """Every shard receives the whole table, live rows packed to the front
    in source-rank order, at capacity ``shard capacity * world``.  Packed:
    ONE all-gather of each shard's plane plus one meta row holding its
    live count in word 0.  Per buffer: the counts and each buffer (data,
    validity, a string's lengths) gathered one by one.  A world of 1
    returns ``t``.  The gather retries under
    ``ctx.collective_retry_policy()``, as the shuffle's exchange does."""
    world = t.num_shards
    if world == 1:
        return t
    devices, group = t.ctx.devices, t.ctx.group
    cap = t.shard_capacity
    out_cap = cap * world

    def compaction(dev, cnt):
        live = (torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
                < cnt[:, None]).reshape(out_cap)
        perm, m = compact.compact_indices(live)
        return perm, compact.live_mask(out_cap, m, dev), m.to(torch.int32)

    def gather_packed():
        planes = []
        for cols, n in zip(t.shards, t.counts):
            plane = plane_mod.pack_plane(cols)
            meta = torch.zeros((1, plane.shape[1]), dtype=plane.dtype,
                               device=plane.device)
            meta[0, 0] = n.to(plane.dtype)
            planes.append(torch.cat([plane, meta]))
        shards, totals = [], []
        for dev, cols, g in zip(devices, t.shards,
                                collectives.allgather(planes, devices,
                                                      group)):
            g3 = g.reshape(world, cap + 1, -1)
            perm, valid, m = compaction(dev, g3[:, cap, 0])
            rows = g3[:, :cap].reshape(out_cap, -1)
            shards.append(plane_mod.unpack_plane(rows[perm], cols,
                                                 valid_mask=valid))
            totals.append(m)
        return shards, totals

    def gather_per_buffer():
        counts = collectives.allgather([c.reshape(1) for c in t.counts],
                                       devices, group)
        plans = [compaction(dev, cnt) for dev, cnt in zip(devices, counts)]
        cols_per_shard = [[] for _ in devices]
        for i, c0 in enumerate(t.shards[0]):
            data = collectives.allgather([s[i].data for s in t.shards],
                                         devices, group)
            valid = collectives.allgather([s[i].validity for s in t.shards],
                                          devices, group)
            lengths = ([None] * len(devices) if c0.lengths is None else
                       collectives.allgather([s[i].lengths for s in t.shards],
                                             devices, group))
            for d, (perm, vmask, _) in enumerate(plans):
                cols_per_shard[d].append(
                    Column(data[d], valid[d], lengths[d], c0.dtype).take(
                        perm, valid_mask=vmask))
        return cols_per_shard, [m for _, _, m in plans]

    def gather():
        resilience.fault_point("broadcast")
        pack = plane_mod.pack_enabled()
        with obs_spans.span("shuffle.broadcast", packed=pack, world=world):
            shards, totals = gather_packed() if pack else gather_per_buffer()
        _record_broadcast(t.shards[0], pack, world, cap + 1 if pack else cap)
        return t._like(shards, totals)

    out, _attempts = resilience.retry_call(
        gather, policy=t.ctx.collective_retry_policy(), site="broadcast")
    return out


def distributed_sort(t, by_idx: Tuple[int, ...], opts: SortOptions,
                     asc: Optional[Tuple[bool, ...]] = None):
    """reference: DistributedSort (table.cpp:313-356): range-partition on
    the first sort column, exchange, then sort every shard locally."""
    by_idx = tuple(by_idx)
    shuffled = _shuffled(t, by_idx, "range", opts)
    if asc is None:
        asc = tuple([opts.ascending] * len(by_idx))
    shards = [sort_mod.sort_rows(cols, n, by_idx, asc, opts.nulls_first)[0]
              for cols, n in zip(shuffled.shards, shuffled.counts)]
    return shuffled._like(shards, shuffled.counts)


def groupby_partial_plan(aggs):
    """(partial_list, partial_index): the deduped ``(src_col, partial_op)``
    list the requested aggs expand into, and each one's position."""
    partial_list: list = []
    partial_index: Dict[tuple, int] = {}
    for ci, op in aggs:
        for pop in groupby_mod.partial_ops(op):
            k = (ci, pop)
            if k not in partial_index:
                partial_index[k] = len(partial_list)
                partial_list.append(k)
    return partial_list, partial_index


def finalize_groupby_columns(fcols, nkeys: int, aggs, partial_index,
                             ddof: int):
    """One shard's combined partials -> the requested agg columns:
    pass-through for SUM/MIN/MAX/COUNT, derived math for MEAN/VAR/STDDEV."""
    out_cols = list(fcols[:nkeys])
    dev = fcols[0].device
    facc = precision.float_acc(dev)
    fdt = dtypes.float_ if precision.narrow(dev) else dtypes.double
    for ci, op in aggs:
        def pcol(pop, _ci=ci):
            return fcols[nkeys + partial_index[(_ci, pop)]]

        if op in (AggOp.SUM, AggOp.MIN, AggOp.MAX, AggOp.COUNT,
                  AggOp.SUMSQ, AggOp.COUNTSUM):
            out_cols.append(pcol(op))
            continue
        s, c = pcol(AggOp.SUM), pcol(AggOp.COUNT)
        n = c.data.clamp(min=1).to(facc)
        if op == AggOp.MEAN:
            v = s.data.to(facc) / n
            valid = s.validity & (c.data > 0)
        elif op in (AggOp.VAR, AggOp.STDDEV):
            s2 = pcol(AggOp.SUMSQ)
            v = (s2.data - s.data.to(facc) ** 2 / n) / (n - ddof).clamp(
                min=1.0)
            v = v.clamp(min=0.0)
            if op == AggOp.STDDEV:
                v = torch.sqrt(v)
            valid = s.validity & ((c.data - ddof) > 0)
        else:
            raise NotImplementedError(op)
        zero = torch.zeros((), dtype=v.dtype, device=dev)
        out_cols.append(Column(torch.where(valid, v, zero), valid, None, fdt))
    return out_cols


def distributed_groupby(t, by_idx: Tuple[int, ...],
                        aggs: Tuple[Tuple[int, AggOp], ...], ddof: int,
                        pipeline: bool = False, pre_partitioned: bool = False,
                        salt: int = 0):
    """Two-phase distributed group-by.

    ``pipeline=False``: the reference's DistributedHashGroupBy
    (groupby/groupby.cpp:23-73), a local partial aggregate, a shuffle of
    the partials on the keys, the final combine and the derived outputs.
    ``pipeline=True``: DistributedPipelineGroupBy (groupby.cpp:75-114),
    the local phases on the boundary-scan pipeline group-by over key-
    grouped rows; each shard sorts the partials it receives before the
    final pass.

    ``pre_partitioned=True``: the caller guarantees every group lies on
    one shard, so the partial shuffle is skipped; combining one partial
    is the identity, so the result equals the shuffled path's.

    NUNIQUE has no partial form: the involved columns are projected (and,
    when every aggregate is NUNIQUE, made distinct per shard first), then
    shuffled on the keys and grouped once.  ``salt > 1``, valid only for
    the all-NUNIQUE single-value-column shape, spreads a hot key's rows
    over ``hash(keys, hash(value) % salt)`` and sums the per-bucket counts
    after a second, group-sized shuffle (``AggOp.COUNTSUM``)."""
    from ..table import _groupby_output_names, _local_groupby, _shard_wise

    names_out = _groupby_output_names(t, by_idx, aggs)
    nunique = [op == AggOp.NUNIQUE for _, op in aggs]
    if pre_partitioned and any(nunique):
        raise CylonError(Code.Invalid,
                         "pre_partitioned group-by cannot carry NUNIQUE "
                         "(no partial/combine decomposition)")
    salt = int(salt)
    if salt > 1 and (pre_partitioned or not all(nunique)
                     or len({ci for ci, _ in aggs}) != 1):
        raise CylonError(Code.Invalid,
                         "salted group-by requires the all-NUNIQUE "
                         "single-distinct-column shape")
    if any(nunique):
        involved = tuple(dict.fromkeys(
            tuple(by_idx) + tuple(ci for ci, _ in aggs)))
        work = t.project(involved)
        remap = {ci: i for i, ci in enumerate(involved)}
        by_p = tuple(remap[i] for i in by_idx)
        aggs_p = tuple((remap[ci], op) for ci, op in aggs)
        if all(nunique):  # duplicate rows cannot change a distinct count
            every = tuple(range(len(involved)))
            work = _shard_wise(lambda cols, n: unique_mod.unique(
                cols, n, every, "first"), work)
        if salt > 1:
            vpos = aggs_p[0][0]
            nkeys = len(by_p)

            def salt_fn(cols, n):
                bucket = (hashing.hash_columns([cols[vpos]]) % salt).to(
                    torch.int32)
                live = compact.live_mask(bucket.shape[0], n, bucket.device)
                return tuple(cols) + (Column(bucket, live, None,
                                             dtypes.int32),), n

            salted = _shard_wise(salt_fn, work)
            salted = salted._like(salted.shards, salted.counts,
                                  work.names + ("__salt__",))
            spread = shuffle(salted, by_p + (len(involved),))
            part = _local_groupby(spread, by_p, aggs_p, ddof)
            combined = shuffle(part, tuple(range(nkeys)))
            out = _local_groupby(combined, tuple(range(nkeys)), tuple(
                (nkeys + i, AggOp.COUNTSUM) for i in range(len(aggs_p))),
                ddof)
            return out.rename(names_out)
        out = _local_groupby(shuffle(work, by_p), by_p, aggs_p, ddof)
        return out.rename(names_out)

    nkeys = len(by_idx)
    key_range = tuple(range(nkeys))

    # 1. requested aggs -> deduped partial ops
    partial_list, partial_index = groupby_partial_plan(aggs)

    # 2. local partial aggregate, per shard
    local = (groupby_mod.pipeline_groupby if pipeline
             else groupby_mod.hash_groupby)
    shards, counts = [], []
    for cols, n in zip(t.shards, t.counts):
        pcols, m = local(cols, n, tuple(by_idx), tuple(partial_list), ddof)
        shards.append(pcols)
        counts.append(m)
    pnames = tuple(f"k{i}" for i in range(nkeys)) + tuple(
        f"p{i}" for i in range(len(partial_list)))
    partial = t._like(shards, counts, pnames)

    # 3. shuffle the partials on the key columns, unless every group's
    # rows (hence its one partial) already live on one shard
    shuffled = partial if pre_partitioned else shuffle(partial, key_range)

    # 4. final combine: SUM of sums/counts/sumsqs, MIN of mins, MAX of maxes
    final_aggs = tuple((nkeys + i, groupby_mod.combine_op(pop))
                       for i, (_, pop) in enumerate(partial_list))
    shards, counts = [], []
    for cols, n in zip(shuffled.shards, shuffled.counts):
        if pipeline:  # received partials arrive unsorted: sort, then scan
            cols, n = sort_mod.sort_rows(cols, n, key_range,
                                         (True,) * nkeys, True)
            fcols, m = groupby_mod.pipeline_groupby(cols, n, key_range,
                                                    final_aggs, ddof)
        else:
            fcols, m = groupby_mod.hash_groupby(cols, n, key_range,
                                                final_aggs, ddof)
        # 5. derived outputs (MEAN/VAR/STDDEV) from the combined partials
        shards.append(finalize_groupby_columns(fcols, nkeys, aggs,
                                               partial_index, ddof))
        counts.append(m)
    out = t._like(shards, counts, names_out)
    if not pre_partitioned:
        # placed by the partial shuffle's hash of ALL group keys; a
        # pre-partitioned run is placed by the caller's key subset, which
        # only the planner knows (it stamps its own result)
        out._partitioning = ("hash", (tuple(names_out[:nkeys]),),
                             t.num_shards)
    return out


def distributed_scalar_agg(t, col_idx: int, op: agg_mod.ReduceOp):
    """A local masked reduce on every shard, then one collective combine
    (reference: compute/aggregates.cpp:30-156, a local reduction and
    mpi::AllReduce).  Empty shards give the op's neutral element.  PROD
    has no allreduce: the partials are gathered and multiplied.  Returns
    the 0-d result on shard 0's device."""
    op = agg_mod.ReduceOp(op)
    devices, group = t.ctx.devices, t.ctx.group
    vals = [agg_mod.scalar_agg(cols[col_idx], n, op)[0]
            for cols, n in zip(t.shards, t.counts)]
    if op in (agg_mod.ReduceOp.SUM, agg_mod.ReduceOp.COUNT):
        return collectives.allreduce_sum(vals, devices, group)[0]
    if op in (agg_mod.ReduceOp.MIN, agg_mod.ReduceOp.MAX):
        carried = [keys.signed_carrier(v) for v in vals]
        combine = (collectives.allreduce_min if op == agg_mod.ReduceOp.MIN
                   else collectives.allreduce_max)
        return carried[0][1](combine([c for c, _ in carried], devices,
                                     group)[0])
    return torch.prod(collectives.allgather([v.reshape(1) for v in vals],
                                            devices, group)[0])
