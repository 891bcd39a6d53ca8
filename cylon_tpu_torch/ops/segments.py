"""Sorted-segment reductions.

The port of ``cylon_tpu/ops/segments.py``.  Rows arrive already grouped
into runs (by a sort or by key-grouped input), so per-segment work is
prefix arithmetic over the row order:

- ``run_extents``: one cumsum, one run-start cummax and one run-end
  reverse cummin;
- ``segmented_reduce_sorted``: a segmented scan that restarts at run
  starts, read at each run's last row;
- ``segment_sum_sorted``: prefix-sum differences at the span bounds.

In narrow mode (the default for CUDA tensors) every such scan, and every
int32 prefix sum of ``segment_sum_sorted``, goes through ``ops/scan.py``:
the CUDA scan kernels on the card, their plain versions on the CPU.  In
wide mode ``run_extents`` uses torch's own cumsum / cummax / cummin, as
the JAX package uses XLA's, and segment reductions stay on scatters
(``ops/groupby.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import precision
from . import compact, scan


def segment_spans(
        new_group: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment [start, end) positions from a run-start mask
    (``new_group[0]`` must be True for nonempty input).  Ids at or past
    the number of segments get empty spans at ``cap``."""
    cap = new_group.shape[0]
    starts_perm, num = compact.compact_indices(new_group)
    iota = torch.arange(cap, dtype=torch.int32, device=new_group.device)
    start = torch.where(iota < num, starts_perm.to(torch.int32),
                        torch.full((), cap, dtype=torch.int32,
                                   device=new_group.device))
    end = torch.cat([start[1:], torch.full((1,), cap, dtype=torch.int32,
                                           device=new_group.device)])
    return start, end


def run_extents(member: torch.Tensor, new_group: torch.Tensor,
                is_run_end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sorted position: (# True ``member`` rows before this position's
    run, # True ``member`` rows inside the run).  ``new_group`` marks run
    starts and ``is_run_end`` run ends; ``new_group[0]`` must be True."""
    n = member.shape[0]
    dev = member.device
    m = member.to(torch.int32)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    past = torch.full((), n + 1, dtype=torch.int32, device=dev)
    if precision.narrow(dev):
        incl = scan.scan_1d(m, "sum")
        excl = incl - m
        start = scan.scan_1d(torch.where(new_group, excl, neg), "max")
        end = scan.scan_1d(torch.where(is_run_end, incl, past), "min",
                           reverse=True)
        return start, end - start
    incl = torch.cumsum(m, 0, dtype=torch.int32)
    excl = incl - m
    start = torch.cummax(torch.where(new_group, excl, neg), 0).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_run_end, incl, past), (0,)), 0).values, (0,))
    return start, end - start


def _span_take(csum0: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return csum0[pos.clamp(0, csum0.shape[0] - 1)]


def segment_sum_sorted(x: torch.Tensor, start: torch.Tensor,
                       end: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """Segment sums as prefix-sum differences at the span bounds.  ``x``
    must already be masked.  ``acc_dtype`` defaults to the precision
    policy's accumulator."""
    if acc_dtype is None:
        if x.is_floating_point():
            acc_dtype = precision.float_acc(x.device)
        elif x.dtype == torch.bool:
            acc_dtype = torch.int32
        else:
            acc_dtype = precision.int_acc()
    if acc_dtype == torch.int32 and precision.narrow(x.device):
        # int32 prefix sums (the counts) take the scan kernel: exact in
        # any order, and faster than torch.cumsum on the card
        csum = scan.scan_1d(x.to(torch.int32).contiguous(), "sum")
    else:
        csum = torch.cumsum(x.to(acc_dtype), 0, dtype=acc_dtype)
    csum0 = torch.cat([torch.zeros(1, dtype=acc_dtype, device=x.device), csum])
    return _span_take(csum0, end) - _span_take(csum0, start)


def segment_count_sorted(valid: torch.Tensor, start: torch.Tensor,
                         end: torch.Tensor) -> torch.Tensor:
    """Number of True rows per segment, as int64."""
    return segment_sum_sorted(valid.to(torch.int32), start, end,
                              torch.int32).to(torch.int64)


def segmented_reduce_sorted(x: torch.Tensor, new_group: torch.Tensor,
                            end: torch.Tensor, op: str) -> torch.Tensor:
    """Per-segment reduction over rows already grouped into runs, with no
    scatter: the segmented scan restarts at run starts, and each run's
    total is read at its last row.  ``x`` must be a 32-bit tensor already
    masked to the op's neutral element.  Returns values indexed by segment
    id; ids past the number of segments read a clipped row."""
    run_val = scan.segmented_scan(x, new_group, op)
    return run_val[(end - 1).clamp(0, x.shape[0] - 1)]
