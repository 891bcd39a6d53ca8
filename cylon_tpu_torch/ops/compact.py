"""Mask -> front-packed compaction, in two realizations.

The port of ``cylon_tpu/ops/compact.py``.  Both realizations give the
same rows, selected by :func:`permute_mode` (``CYLON_TPU_PERMUTE``):

- ``scatter``: cumsum destinations + one permuting scatter (one
  coalesced-read, scattered-write pass on a GPU; the port's default on
  CUDA and on the CPU, as the reference's default off the TPU);
- ``sort``: the mask bit above the row index in ONE integer word and one
  sort (the reference's TPU default, where XLA serializes scatters).

``compact_indices`` and ``partition_indices`` return the reference's
arrays entry for entry in each realization, the filler past
``new_count`` included: zeros under ``scatter``, the False rows in order
under ``sort``.  Index tensors are int32 below 2^31 rows and int64 past
it (``cylon_tpu/ops/compact.py:74-79``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import config


def permute_mode() -> str:
    """How permutations and compactions are materialized: "scatter" |
    "sort".  ``CYLON_TPU_PERMUTE`` overrides; "auto" is "scatter" on
    every device the port runs on (the reference's auto sorts only on a
    TPU)."""
    mode = config.knob("CYLON_TPU_PERMUTE")
    return mode if mode in ("scatter", "sort") else "scatter"


def invperm_mode() -> str:
    """``CYLON_TPU_INVPERM``: "sort" | "gather", the reference's two forms
    of a sort-realized :func:`inverse_permute`.  Torch has no
    multi-operand sort, so both are one sort of the permutation and one
    gather per field here."""
    return config.knob("CYLON_TPU_INVPERM")


def index_bits(cap: int) -> int:
    """Bits needed to carry a row index in [0, cap) inside a packed sort
    word (shared with keys.lexsort_indices)."""
    return max(1, (cap - 1).bit_length()) if cap > 1 else 1


def idx_dtype(cap: int) -> torch.dtype:
    """Row-index dtype wide enough for ``cap`` rows."""
    return torch.int64 if cap > (1 << 31) - 1 else torch.int32


def _mask_sort_perm(mask: torch.Tensor) -> torch.Tensor:
    """Stable partition permutation (True rows first) by ONE sort of
    ``(~mask) << bits | row``: the words are unique and the row bits
    ascend, so an unstable sort is stable per mask value.  The word rides
    in int32 while ``bits + 1 <= 31``: at 32 the flag would land in the
    sign bit and invert the order, so it rides in int64 there.  Past 2^31
    rows the flag and index no longer fit 32 bits, and the reference
    sorts the flags stably with an int64 iota: so does the port."""
    cap = mask.shape[0]
    bits = index_bits(cap)
    flag = ~mask
    if bits + 1 > 32:
        return torch.sort(flag.to(torch.uint8), stable=True).indices
    wt = torch.int32 if bits + 1 <= 31 else torch.int64
    word = (flag.to(wt) << bits) | torch.arange(cap, dtype=wt,
                                                device=mask.device)
    s = torch.sort(word).values
    return (s & ((1 << bits) - 1)).to(torch.int32)


def compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, new_count): the first ``new_count`` entries of ``idx`` are the
    row indices where ``mask`` is True, in order; the entries after them
    are 0 (scatter) or the False rows in order (sort).  ``new_count`` is
    a 0-d tensor of the index dtype."""
    cap = mask.shape[0]
    it = idx_dtype(cap)
    new_count = mask.sum(dtype=it)
    if permute_mode() == "sort":
        return _mask_sort_perm(mask), new_count
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
    if permute_mode() == "sort":
        return _mask_sort_perm(mask), nt
    iota = torch.arange(cap, dtype=it, device=mask.device)
    ct = torch.cumsum(mask, 0, dtype=it)
    cf = iota + 1 - ct  # cumsum of ~mask without a second scan
    dest = torch.where(mask, ct - 1, nt + cf - 1)
    perm = torch.empty(cap, dtype=it, device=mask.device)
    perm.index_put_((dest,), iota)
    return perm, nt


def count_leq_dense(sorted_vals: torch.Tensor,
                    num_queries: int) -> torch.Tensor:
    """``out[k] = #{i : sorted_vals[i] <= k}`` for k in [0, num_queries),
    i.e. ``searchsorted(sorted_vals, arange(num_queries), side='right')``
    for a monotone int tensor, by one merged sort and one compaction
    (``cylon_tpu/ops/compact.py:118``).

    Words are ``value << 1`` and ``query << 1 | 1``: a value v sorts
    before query k exactly when v <= k, and the queries keep their
    order, so query k's merged position is ``#{v <= k} + k``.  Values are
    clipped to ``[0, num_queries]`` first, as the reference clips them.
    Any input order works: the merge sorts."""
    dev = sorted_vals.device
    wt = torch.int32 if num_queries < (1 << 30) else torch.int64
    vals = sorted_vals.clamp(0, num_queries).to(wt) << 1
    queries = (torch.arange(num_queries, dtype=wt, device=dev) << 1) | 1
    merged = torch.sort(torch.cat([vals, queries])).values
    p, _ = compact_indices((merged & 1) == 1)
    return p[:num_queries] - torch.arange(num_queries, dtype=torch.int32,
                                          device=dev)


def inverse_permute(perm: torch.Tensor,
                    *fields: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``out[perm[i]] = field[i]`` for each field; ``perm`` must be a
    permutation of [0, n).  scatter: one scatter per field.  sort: one
    sort of ``perm``, whose indices are the inverse permutation, then one
    gather per field (``out[j] = field[inv[j]]``), under either
    ``invperm_mode``."""
    if permute_mode() == "sort":
        inv = torch.sort(perm).indices
        return tuple(f[inv] for f in fields)
    out = []
    for f in fields:
        o = torch.empty_like(f)
        o.index_put_((perm,), f)
        out.append(o)
    return tuple(out)


def live_mask(capacity: int, row_count, device) -> torch.Tensor:
    """bool[capacity]: True for rows below the live-row count."""
    return torch.arange(capacity, dtype=torch.int32, device=device) < row_count
