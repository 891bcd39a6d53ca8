"""Local join over dense key runs, by sort-merge or by hash.

The port of ``cylon_tpu/ops/join.py`` (reference: cpp/src/cylon/join/
join.cpp sort-merge and hash joins):

1. ``algorithm="sort"``: one multi-key lexsort of the union of both
   tables' key rows is the only sort; each left row's match range
   [lo, lo + matches) into the key-ordered right side is prefix
   arithmetic over that order (``run_extents``); the key-ordered right
   permutation is a stable partition of the sorted entries;
   ``algorithm="hash"``: the same ranges from an open-addressing hash
   table (``hash_join.match_ranges_hash``), the right side ordered by
   chain head;
2. the variable-size expansion is a static-capacity gather: each emitting
   left row writes its index at its first output slot and a running max
   fills the slots after it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import precision
from ..column import Column
from ..config import JoinAlgorithm, JoinType, join_algorithm
from ..obs import spans as obs_spans
from ..status import Code, CylonError
from . import common, compact, hash_join, scan, segments

_I32_MAX = (1 << 31) - 1


def _match_ranges(cols_l, count_l, cols_r, count_r, left_on, right_on,
                  join_type: JoinType):
    """Per-left-row match ranges into the key-ordered right table.

    Returns (lo, matches, perm_r, live_l, unmatched_r, left_key_order):
    ``perm_r`` lists right rows in key order (the order ``lo`` indexes),
    ``left_key_order`` left rows in key order."""
    cap_l = cols_l[0].capacity
    cap_r = cols_r[0].capacity
    dev = cols_l[0].device
    perm, _, new_group, is_run_end, live_sorted = common.combined_sorted_runs(
        cols_l, count_l, cols_r, count_r, left_on, right_on)
    is_right = perm >= cap_l

    lo_sorted, matches_sorted = segments.run_extents(
        is_right & live_sorted, new_group, is_run_end)
    fields = [lo_sorted, matches_sorted]
    outer_right = join_type in (JoinType.RIGHT, JoinType.FULL_OUTER)
    if outer_right:
        _, left_in_run = segments.run_extents(
            (~is_right) & live_sorted, new_group, is_run_end)
        fields.append((left_in_run == 0).to(torch.int32))

    back = compact.inverse_permute(perm, *fields)

    live_l = torch.arange(cap_l, dtype=torch.int32, device=dev) < count_l
    live_r = torch.arange(cap_r, dtype=torch.int32, device=dev) < count_r
    lo = back[0][:cap_l]
    matches = torch.where(live_l, back[1][:cap_l],
                          torch.zeros((), dtype=torch.int32, device=dev))
    if outer_right:
        unmatched_r = live_r & (back[2][cap_l:] == 1)
    else:
        unmatched_r = torch.zeros(cap_r, dtype=torch.bool, device=dev)

    # one stable partition of the sorted entries: the front cap_r are the
    # right rows in key order, the tail cap_l the left rows in key order
    part, _ = compact.partition_indices(is_right)
    perm_r = perm[part[:cap_r]] - cap_l
    left_key_order = perm[part[cap_r:]]
    return lo, matches, perm_r, live_l, unmatched_r, left_key_order


def _emission(matches, live_l, join_type: JoinType):
    outer_left = join_type in (JoinType.LEFT, JoinType.FULL_OUTER)
    emit = torch.where(live_l & (matches == 0),
                       torch.full((), 1 if outer_left else 0,
                                  dtype=torch.int32, device=matches.device),
                       matches)
    csum = torch.cumsum(emit, 0, dtype=torch.int32)
    total = csum[-1] if emit.shape[0] else torch.zeros(
        (), dtype=torch.int32, device=matches.device)
    return emit, csum, total


def _ranges(cols_l, count_l, cols_r, count_r, left_on, right_on,
            join_type: JoinType, algorithm):
    """``_match_ranges``' six outputs by ``algorithm`` (a
    ``JoinAlgorithm``, or ``"sort"`` / ``"hash"``); the hash path has no
    key order of the left rows (None)."""
    try:
        algorithm = join_algorithm(algorithm)
    except ValueError:
        raise CylonError(Code.Invalid,
                         f"bad join algorithm {algorithm!r}") from None
    if algorithm == JoinAlgorithm.HASH:
        return hash_join.match_ranges_hash(
            cols_l, count_l, cols_r, count_r, left_on, right_on,
            join_type) + (None,)
    return _match_ranges(cols_l, count_l, cols_r, count_r, left_on,
                         right_on, join_type)


def join_row_count(cols_l: Sequence[Column], count_l,
                   cols_r: Sequence[Column], count_r,
                   left_on: Tuple[int, ...], right_on: Tuple[int, ...],
                   join_type: JoinType, algorithm="sort"):
    """Exact output row count of the join (0-d int32 tensor), in a span
    ``join.count``."""
    with obs_spans.span("join.count", devices=cols_l[0].device):
        _, matches, _, live_l, unmatched_r, _ = _ranges(
            cols_l, count_l, cols_r, count_r, left_on, right_on, join_type,
            algorithm)
        _, _, total = _emission(matches, live_l, join_type)
        if join_type in (JoinType.RIGHT, JoinType.FULL_OUTER):
            total = total + unmatched_r.sum(dtype=torch.int32)
        return total


def _running_max(x: torch.Tensor) -> torch.Tensor:
    if precision.narrow(x.device):
        return scan.scan_1d(x, "max")
    return torch.cummax(x, 0).values


def join_gather(cols_l: Sequence[Column], count_l,
                cols_r: Sequence[Column], count_r,
                left_on: Tuple[int, ...], right_on: Tuple[int, ...],
                join_type: JoinType, out_capacity: int,
                algorithm="sort", key_grouped: bool = False,
                project: Optional[Tuple[int, ...]] = None):
    """Gathered output columns (left columns ++ right columns, or the
    ``project`` subset in that order) of capacity ``out_capacity``, and
    the output row count.

    ``key_grouped=True`` (INNER only) emits rows with equal keys adjacent,
    so a group-by on the key can take the boundary-scan pipeline group-by
    without another sort: in key order on the sort path, where the
    combined lexsort gives the left rows' key order; on the hash path,
    which has none, by a stable sort of the left rows on ``lo``, which
    names a matched row's key group.  In a span ``join.gather``."""
    with obs_spans.span("join.gather", devices=cols_l[0].device):
        lo, matches, perm_r, live_l, unmatched_r, left_key_order = _ranges(
            cols_l, count_l, cols_r, count_r, left_on, right_on, join_type,
            algorithm)
        dev = lo.device
        perm_l = None
        if key_grouped:
            if join_type != JoinType.INNER:
                raise ValueError("key_grouped join output requires INNER")
            matched = live_l & (matches > 0)
            if left_key_order is None:
                order_key = torch.where(matched, lo, torch.full(
                    (), _I32_MAX, dtype=torch.int32, device=dev))
                perm_l = torch.sort(order_key, stable=True).indices.to(
                    torch.int32)
            else:
                part, _ = compact.partition_indices(matched[left_key_order])
                perm_l = left_key_order[part]
            lo = lo[perm_l]
            matches = matches[perm_l]
            live_l = live_l[perm_l]
        emit, csum, total = _emission(matches, live_l, join_type)

        k = torch.arange(out_capacity, dtype=torch.int32, device=dev)
        cap_l = emit.shape[0]
        cap_r = perm_r.shape[0]
        base_l = csum - emit
        if compact.permute_mode() == "sort":
            # slot k's left row is searchsorted(csum, k, 'right'): csum is
            # monotone, so it is the count of rows with csum <= k
            li = compact.count_leq_dense(csum, out_capacity).clamp(
                0, cap_l - 1)
        else:
            # each emitting row drops its index at its first output slot
            # (bases are distinct); rows that emit nothing or fall past the
            # capacity write an extra slot that is cut off; a running max
            # fills the runs
            iota_l = torch.arange(cap_l, dtype=torch.int32, device=dev)
            dest = torch.where((emit > 0) & (base_l < out_capacity), base_l,
                               torch.full((), out_capacity, dtype=torch.int32,
                                          device=dev))
            marker = torch.full((out_capacity + 1,), -1, dtype=torch.int32,
                                device=dev)
            marker.index_put_((dest,), iota_l)
            li = _running_max(marker[:out_capacity]).clamp(0, cap_l - 1)
        base = base_l[li]
        within = k - base
        matched = matches[li] > 0
        r_sorted_pos = lo[li] + within
        ridx_inner = perm_r[r_sorted_pos.clamp(0, cap_r - 1)]

        in_main = k < total
        lvalid = in_main
        rvalid = in_main & matched
        lidx = li if perm_l is None else perm_l[li]
        ridx = torch.where(rvalid, ridx_inner,
                           torch.zeros((), dtype=torch.int32, device=dev))

        out_count = total
        if join_type in (JoinType.RIGHT, JoinType.FULL_OUTER):
            perm_u, m = compact.compact_indices(unmatched_r)
            tail = k - total
            in_tail = (k >= total) & (tail < m)
            ridx_tail = perm_u[tail.clamp(0, cap_r - 1)]
            ridx = torch.where(in_tail, ridx_tail, ridx)
            rvalid = rvalid | in_tail
            lvalid = lvalid & ~in_tail
            out_count = total + m

        n_l = len(cols_l)
        n_out = n_l + len(cols_r)
        if project is None:
            project = tuple(range(n_out))
        bad = [j for j in project if not 0 <= j < n_out]
        if bad:
            raise ValueError(f"project indices {bad} out of range for "
                             f"{n_out} output columns (left {n_l} ++ right "
                             f"{n_out - n_l}; negatives not supported)")
        out = []
        for j in project:
            if j < n_l:
                out.append(cols_l[j].take(lidx, valid_mask=lvalid))
            else:
                out.append(cols_r[j - n_l].take(ridx, valid_mask=rvalid))
        return tuple(out), out_count
