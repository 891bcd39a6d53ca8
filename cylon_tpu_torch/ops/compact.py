"""Mask -> front-packed compaction and the permutations built like it.

The port of ``cylon_tpu/ops/compact.py``, in its scatter realization:
cumsum destinations and one permuting scatter, one coalesced-read,
scattered-write pass on a GPU.  ``compact_indices`` and
``partition_indices`` return the reference's arrays entry for entry
under its ``scatter`` realization, the filler past ``new_count`` (zeros)
included.  Index tensors are int32 below 2^31 rows and int64 past it
(``cylon_tpu/ops/compact.py:74-79``).
"""
from __future__ import annotations

from typing import Tuple

import torch


def index_bits(cap: int) -> int:
    """Bits needed to carry a row index in [0, cap) inside a packed sort
    word (shared with keys.lexsort_indices)."""
    return max(1, (cap - 1).bit_length()) if cap > 1 else 1


def idx_dtype(cap: int) -> torch.dtype:
    """Row-index dtype wide enough for ``cap`` rows."""
    return torch.int64 if cap > (1 << 31) - 1 else torch.int32


def compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, new_count): the first ``new_count`` entries of ``idx`` are the
    row indices where ``mask`` is True, in order; the entries after them
    are 0.  ``new_count`` is a 0-d tensor of the index dtype."""
    cap = mask.shape[0]
    it = idx_dtype(cap)
    new_count = mask.sum(dtype=it)
    iota = torch.arange(cap, dtype=it, device=mask.device)
    pos = torch.cumsum(mask, 0, dtype=it) - 1
    # rows outside the mask land in one extra slot that is cut off after
    dest = torch.where(mask, pos, torch.full((), cap, dtype=it,
                                             device=mask.device))
    idx = torch.zeros(cap + 1, dtype=it, device=mask.device)
    idx.index_put_((dest,), iota)
    return idx[:cap], new_count


def partition_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, true_count): a stable partition permutation, the True rows
    first (in order) and then the False rows (in order)."""
    cap = mask.shape[0]
    it = idx_dtype(cap)
    nt = mask.sum(dtype=it)
    iota = torch.arange(cap, dtype=it, device=mask.device)
    ct = torch.cumsum(mask, 0, dtype=it)
    cf = iota + 1 - ct  # cumsum of ~mask without a second scan
    dest = torch.where(mask, ct - 1, nt + cf - 1)
    perm = torch.empty(cap, dtype=it, device=mask.device)
    perm.index_put_((dest,), iota)
    return perm, nt


def inverse_permute(perm: torch.Tensor,
                    *fields: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``out[perm[i]] = field[i]`` for each field, one scatter per field;
    ``perm`` must be a permutation of [0, n)."""
    out = []
    for f in fields:
        o = torch.empty_like(f)
        o.index_put_((perm,), f)
        out.append(o)
    return tuple(out)


def live_mask(capacity: int, row_count, device) -> torch.Tensor:
    """bool[capacity]: True for rows below the live-row count."""
    return torch.arange(capacity, dtype=torch.int32, device=device) < row_count
