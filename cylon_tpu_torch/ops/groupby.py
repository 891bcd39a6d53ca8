"""Local group-by: sort (or key-grouped input) + segment reduce.

The port of ``cylon_tpu/ops/groupby.py`` (reference: groupby/
hash_groupby.cpp and pipeline_groupby.cpp):

1. group boundaries come from a lexsort of the key columns
   (``hash_groupby``) or from adjacent comparison of key-grouped rows
   (``pipeline_groupby``);
2. dense group ids are a prefix sum of the boundaries;
3. each aggregation is a masked segment reduction.  In narrow mode (the
   default for CUDA tensors) float sums, means and 32-bit min/max go
   through the segmented scan (``ops/scan.py``) and counts through int32
   prefix sums (``scan_1d``); integer sums and every wide-mode reduction
   are scatters (``index_add_`` / ``scatter_reduce_``), as in the JAX
   package.  NUNIQUE's per-group counts are a scatter-add, or under
   ``CYLON_TPU_PERMUTE=sort`` prefix-sum differences at the group bounds
   (``compact.count_leq_dense``).

String key columns group through their packed words
(``keys.column_operands``) and come out gathered with their lengths.  A
string value column takes COUNT and NUNIQUE; any other aggregate of one
raises ``TypeError``, as ``cylon_tpu/ops/groupby.py:246`` does.  The JAX
package refuses COUNT of a string too; the port counts its non-null rows.

The op set and the partial/final split for a two-phase group-by mirror
the reference's KernelTraits (compute/aggregate_kernels.hpp:38-200).
"""
from __future__ import annotations

import enum
from typing import Sequence, Tuple

import torch

from .. import dtypes, precision
from .. import column
from ..column import Column
from ..obs import spans as obs_spans
from . import compact, keys, segments


class AggOp(enum.IntEnum):
    """reference: compute/aggregate_kernels.hpp AggregationOpId."""

    SUM = 0
    MIN = 1
    MAX = 2
    COUNT = 3
    MEAN = 4
    VAR = 5
    STDDEV = 6
    NUNIQUE = 7
    SUMSQ = 8  # internal: sum of squares partial for VAR/STDDEV two-phase
    COUNTSUM = 9  # internal: sum of partial counts

    @staticmethod
    def of(name: "str | AggOp") -> "AggOp":
        if isinstance(name, AggOp):
            return name
        m = {"sum": AggOp.SUM, "min": AggOp.MIN, "max": AggOp.MAX,
             "count": AggOp.COUNT, "mean": AggOp.MEAN, "avg": AggOp.MEAN,
             "var": AggOp.VAR, "std": AggOp.STDDEV, "stddev": AggOp.STDDEV,
             "nunique": AggOp.NUNIQUE}
        return m[name.lower()]


def partial_ops(op: AggOp) -> Tuple[AggOp, ...]:
    """Partial aggregations whose columns a two-phase group-by shuffles
    for ``op`` (reference: groupby/groupby.cpp:47-62)."""
    return {
        AggOp.SUM: (AggOp.SUM,),
        AggOp.MIN: (AggOp.MIN,),
        AggOp.MAX: (AggOp.MAX,),
        AggOp.COUNT: (AggOp.COUNT,),
        AggOp.MEAN: (AggOp.SUM, AggOp.COUNT),
        AggOp.VAR: (AggOp.SUM, AggOp.COUNT, AggOp.SUMSQ),
        AggOp.STDDEV: (AggOp.SUM, AggOp.COUNT, AggOp.SUMSQ),
        AggOp.SUMSQ: (AggOp.SUMSQ,),
        AggOp.COUNTSUM: (AggOp.COUNTSUM,),
    }[op]


def combine_op(partial: AggOp) -> AggOp:
    """How a partial column recombines in the final phase."""
    if partial == AggOp.COUNT:
        return AggOp.COUNTSUM
    if partial in (AggOp.SUM, AggOp.SUMSQ):
        return AggOp.SUM
    return partial  # MIN of mins, MAX of maxes


def _agg_out_dtype(op: AggOp, dt: dtypes.DataType,
                   narrow: bool) -> dtypes.DataType:
    if op in (AggOp.COUNT, AggOp.NUNIQUE, AggOp.COUNTSUM):
        # declared int64 even in narrow mode: the buffer stays int32 and
        # widens at the host boundary
        return dtypes.int64
    if op in (AggOp.MEAN, AggOp.VAR, AggOp.STDDEV, AggOp.SUMSQ):
        return dtypes.float_ if narrow else dtypes.double
    if op == AggOp.SUM:
        if dtypes.is_floating(dt):
            if dt.type == dtypes.Type.DOUBLE and not narrow:
                return dtypes.double
            return dtypes.float_
        return dtypes.int64
    return dt  # MIN/MAX keep the input type


def _zero(dtype, device) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


def _segment_sum(x: torch.Tensor, gid: torch.Tensor, num: int) -> torch.Tensor:
    return torch.zeros(num, dtype=x.dtype, device=x.device).index_add_(
        0, gid, x)


_WIDEN_32 = {torch.uint8: torch.int32, torch.int8: torch.int32,
             torch.int16: torch.int32, torch.uint16: torch.int32,
             torch.float16: torch.float32, torch.bfloat16: torch.float32}


def _segment_aggregate(op: AggOp, data, valid, gid, num_segments: int,
                       ddof: int, spans=None, boundaries=None):
    """One masked segment reduction; returns (values, validity counts).

    ``spans`` (start, end) and ``boundaries`` (the run-start mask) describe
    rows already ordered by ``gid``.  In narrow mode counts then take an
    int32 prefix sum and float / min / max reductions the segmented scan;
    integer sums keep the int64 scatter in every mode."""
    dev = data.device
    nar = precision.narrow(dev)
    sorted_counts = spans is not None and nar
    use_scan = sorted_counts and boundaries is not None
    if sorted_counts:
        start, end = spans
        cnt32 = segments.segment_sum_sorted(valid.to(torch.int32), start,
                                            end, torch.int32)
    else:
        cnt32 = _segment_sum(valid.to(torch.int32), gid, num_segments)
    cnt = cnt32 if nar else cnt32.to(torch.int64)

    def fsum(x):
        if use_scan:
            return segments.segmented_reduce_sorted(x, boundaries, end, "sum")
        return _segment_sum(x, gid, num_segments)

    if op == AggOp.COUNT:
        return cnt, cnt
    if op == AggOp.COUNTSUM:
        x = torch.where(valid, data, _zero(data.dtype, dev)).to(
            precision.count_acc())
        s = _segment_sum(x, gid, num_segments)
        return (s if nar else s.to(torch.int64)), cnt
    if op == AggOp.SUMSQ:
        x = torch.where(valid, data, _zero(data.dtype, dev)).to(
            precision.float_acc(dev))
        return fsum(x * x), cnt
    if op == AggOp.SUM:
        acc = torch.where(valid, data, _zero(data.dtype, dev))
        if data.is_floating_point():
            return fsum(acc.to(precision.float_acc_for(data.dtype, dev))), cnt
        acc = acc.to(precision.int_acc())
        return _segment_sum(acc, gid, num_segments), cnt
    if op in (AggOp.MIN, AggOp.MAX):
        is_min = op == AggOp.MIN
        data, restore = keys.signed_carrier(data)
        if data.is_floating_point():
            sentinel = float("inf") if is_min else float("-inf")
        elif data.dtype == torch.bool:
            data = data.to(torch.uint8)
            sentinel = 1 if is_min else 0
        else:
            info = torch.iinfo(data.dtype)
            sentinel = info.max if is_min else info.min
        masked = torch.where(valid, data, torch.full((), sentinel,
                                                     dtype=data.dtype,
                                                     device=dev))
        if use_scan and masked.dtype.itemsize <= 4:
            # the scan kernels take 32-bit values; narrower types widen
            # and come back exactly (min/max never round)
            wide = _WIDEN_32.get(masked.dtype, masked.dtype)
            out = segments.segmented_reduce_sorted(
                masked.to(wide), boundaries, end,
                "min" if is_min else "max").to(masked.dtype)
        else:
            out = torch.full((num_segments,), sentinel, dtype=masked.dtype,
                             device=dev).scatter_reduce_(
                0, gid.to(torch.int64), masked, "amin" if is_min else "amax")
        return column.zero_unless(cnt > 0, restore(out)), cnt
    if op in (AggOp.MEAN, AggOp.VAR, AggOp.STDDEV):
        facc = precision.float_acc(dev)
        x = torch.where(valid, data, _zero(data.dtype, dev)).to(facc)
        s = fsum(x)
        if op == AggOp.MEAN:
            return s / cnt.clamp(min=1).to(facc), cnt
        s2 = fsum(x * x)
        n = cnt.clamp(min=1).to(facc)
        var = (s2 - s * s / n) / (n - ddof).clamp(min=1.0)
        var = var.clamp(min=0.0)
        if op == AggOp.STDDEV:
            var = torch.sqrt(var)
        return var, torch.where(cnt - ddof > 0, cnt, _zero(cnt.dtype, dev))
    if op == AggOp.NUNIQUE:
        raise NotImplementedError("NUNIQUE is computed by _nunique")
    raise ValueError(op)


def _nunique(vcol: Column, vvalid, gid, cap: int):
    """Distinct non-null values per group via a (gid, value) lexsort, then
    an int32 scatter-add of the adjacency breaks or, under
    ``CYLON_TPU_PERMUTE=sort``, differences of their prefix sums at the
    group bounds ``count_leq_dense`` finds (no scatter)."""
    ops = [~vvalid, gid] + keys.column_operands(vcol, with_validity=False)
    perm, sorted_ops = keys.lexsort_indices(ops, cap)
    eq = keys.rows_equal_adjacent(sorted_ops)
    svalid = vvalid[perm]
    gsorted = gid[perm]
    new_distinct = (~eq) & svalid
    if compact.permute_mode() == "sort":
        # valid rows sort first (primary operand ~vvalid), so the valid
        # prefix is gid-ascending: a group's distinct count is the prefix
        # sum at its end less the one at the previous group's end
        dev = gid.device
        gclean = torch.where(svalid, gsorted,
                             torch.full((), cap, dtype=gsorted.dtype,
                                        device=dev))
        ub = compact.count_leq_dense(gclean, cap)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        p0 = torch.cat([zero, torch.cumsum(new_distinct, 0,
                                           dtype=torch.int32)])
        e = p0[ub]
        cnt = e - torch.cat([zero, e[:-1]])
    else:
        cnt = _segment_sum(new_distinct.to(torch.int32), gsorted, cap)
    nar = precision.narrow(cnt.device)
    return (cnt if nar else cnt.to(torch.int64)), cnt


def _aggregate_groups(cols, live, gid, start, end, new_group, group_live,
                      aggs, ddof, cap, gather=None):
    """The aggregate output columns of both group-bys; ``gather`` reorders
    value columns into group order (None when rows already are)."""
    nar = precision.narrow(gid.device)
    out_cols = []
    for col_idx, op in aggs:
        op = AggOp(op)
        src = cols[col_idx]
        if src.is_string and op not in (AggOp.COUNT, AggOp.NUNIQUE):
            raise TypeError(f"aggregation {op.name} unsupported on strings")
        if src.is_string and op == AggOp.COUNT:
            # a count reads validity alone: leave the byte matrix ungathered
            src = Column(src.validity, src.validity, None, dtypes.bool_)
        vcol = src if gather is None else src.take(gather)
        vvalid = vcol.validity & live
        if op == AggOp.NUNIQUE:
            vals, cnts = _nunique(vcol, vvalid, gid, cap)
        else:
            vals, cnts = _segment_aggregate(op, vcol.data, vvalid, gid, cap,
                                            ddof, spans=(start, end),
                                            boundaries=new_group)
        if op in (AggOp.COUNT, AggOp.COUNTSUM, AggOp.NUNIQUE):
            validity = group_live  # a count of zero values is a valid 0
        else:
            validity = group_live & (cnts > 0)
        vals = column.zero_unless(validity, vals)
        out_cols.append(Column(vals, validity, None,
                               _agg_out_dtype(op, cols[col_idx].dtype, nar)))
    return out_cols


def _group_frame(new_group: torch.Tensor, count: torch.Tensor, cap: int):
    gid = torch.cumsum(new_group, 0, dtype=torch.int32) - 1
    start, end = segments.segment_spans(new_group)
    iota = torch.arange(cap, dtype=torch.int32, device=new_group.device)
    live = iota < count
    # the last live row's group id, gathered on the card: no host read,
    # so the host queues the next card's work behind it (at capacity 0,
    # gid's one row is rows_equal_adjacent's padded row 0)
    last = (count - 1).clamp(0, max(cap - 1, 0)).reshape(1)
    num_groups = torch.where(count > 0, gid.index_select(0, last)[0] + 1,
                             _zero(torch.int32, new_group.device))
    leader = start.clamp(0, cap - 1)
    group_live = iota < num_groups
    return gid, start, end, live, num_groups, leader, group_live


def hash_groupby(cols: Sequence[Column], count, key_idx: Tuple[int, ...],
                 aggs: Tuple[Tuple[int, AggOp], ...], ddof: int = 0):
    """Group rows by the ``key_idx`` columns and aggregate.  Output: the
    key columns (one row per distinct live key, in key order), then one
    column per (value column, op).  Returns (columns, group_count).  In
    a span ``groupby``."""
    with obs_spans.span("groupby", devices=cols[0].device):
        cap = cols[0].capacity
        dev = cols[0].device
        count = torch.as_tensor(count, dtype=torch.int32, device=dev)
        key_cols = [cols[i] for i in key_idx]
        operands = keys.build_operands(key_cols, count, cap)
        perm, sorted_ops = keys.lexsort_indices(operands, cap)
        new_group = ~keys.rows_equal_adjacent(sorted_ops)
        gid, start, end, live, num_groups, leader, group_live = _group_frame(
            new_group, count, cap)
        leader_src = perm[leader]  # one gather instead of two
        out_cols = [kc.take(leader_src, valid_mask=group_live)
                    for kc in key_cols]
        out_cols += _aggregate_groups(cols, live, gid, start, end, new_group,
                                      group_live, aggs, ddof, cap, gather=perm)
        return tuple(out_cols), num_groups


def pipeline_groupby(cols: Sequence[Column], count,
                     key_idx: Tuple[int, ...],
                     aggs: Tuple[Tuple[int, AggOp], ...], ddof: int = 0):
    """Group-by for key-grouped input (reference: pipeline_groupby.cpp):
    group boundaries come from adjacent comparison in row order, with no
    sort.  In a span ``groupby``."""
    with obs_spans.span("groupby", devices=cols[0].device):
        cap = cols[0].capacity
        dev = cols[0].device
        count = torch.as_tensor(count, dtype=torch.int32, device=dev)
        key_cols = [cols[i] for i in key_idx]
        operands = [keys.padding_operand(cap, count, dev)]
        for kc in key_cols:
            operands.extend(keys.column_operands(kc))
        new_group = ~keys.rows_equal_adjacent(keys.pack_operands(operands))
        gid, start, end, live, num_groups, leader, group_live = _group_frame(
            new_group, count, cap)
        out_cols = [kc.take(leader, valid_mask=group_live) for kc in key_cols]
        out_cols += _aggregate_groups(cols, live, gid, start, end, new_group,
                                      group_live, aggs, ddof, cap)
        return tuple(out_cols), num_groups
