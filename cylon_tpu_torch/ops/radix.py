"""LSD radix sort of the packed one-word sort key: the alternative to
``torch.sort`` on the fast path of :func:`keys.lexsort_indices`.

The port of ``cylon_tpu/ops/radix.py``.  Per digit of the key's
significant bits, one stable counting split: a cumsum of the digit's
indicator and one permuting scatter.  The row index packed into the low
bits is carried, not sorted: every split is stable, so the rows keep
the index order a full sort would give them.  The key is the port's one
int64 word; digits are taken by shift then mask, so bit 63 reads as an
unsigned bit on the signed carrier.

``_cumsum_i32`` is the reference's two-level block scan: a
``[n/256, 256] @ triu(ones(256, 256))`` matmul in float32 for the
inclusive scan inside each block, plus an exclusive scan of the block
sums.  The operands are 0/1 and each block's sum is at most 256, so the
float32 result is exact, under TF32 as well.

Knobs: ``CYLON_TPU_SORT=radix`` switches the fast path here;
``CYLON_TPU_RADIX_BITS=d`` takes d-bit digits (one cumsum per digit value
per pass, clamped to 1..8); ``CYLON_TPU_RADIX_SCAN=xla`` runs every
cumsum through ``ops/scan.py::scan_1d`` (the look-back scan kernel on the
card, ``torch.cumsum`` on the CPU).
"""
from __future__ import annotations

import torch

from .. import config
from . import scan

_BLOCK = 256  # matmul-scan block edge; block sums <= 256 are exact in f32


def sort_mode() -> str:
    """Which sort the packed fast path takes: "cmp" (``torch.sort``) or
    "radix"."""
    return config.knob("CYLON_TPU_SORT")


def radix_bits() -> int:
    return max(1, min(int(config.knob("CYLON_TPU_RADIX_BITS")), 8))


def _cumsum_i32(m: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of a bool mask: the block matmul scan, or
    ``scan_1d`` under ``CYLON_TPU_RADIX_SCAN=xla``.  Below four blocks or
    off a block multiple it is one ``torch.cumsum``, as the reference
    falls back to ``jnp.cumsum`` (``cylon_tpu/ops/radix.py:63-64``)."""
    if config.knob("CYLON_TPU_RADIX_SCAN") == "xla":
        return scan.scan_1d(m.to(torch.int32), "sum")
    n = m.shape[0]
    if n < _BLOCK * 4 or n % _BLOCK:
        return torch.cumsum(m, 0, dtype=torch.int32)
    x = m.to(torch.float32).reshape(n // _BLOCK, _BLOCK)
    tri = torch.ones(_BLOCK, _BLOCK, dtype=torch.float32,
                     device=m.device).triu()
    within = x @ tri  # [nb, B] inclusive scans of each block
    block_sums = within[:, -1].to(torch.int32)
    offsets = torch.cumsum(block_sums, 0, dtype=torch.int32) - block_sums
    return (within.to(torch.int32) + offsets[:, None]).reshape(n)


def _split_destinations(digit: torch.Tensor, width: int) -> torch.Tensor:
    """Stable counting-sort destinations of one digit.  A 1-bit digit
    takes one cumsum (a set row's rank is its position less its rank
    among the clear rows); a wider one, one cumsum per digit value."""
    n = digit.shape[0]
    if width == 1:
        zero = digit == 0
        c = _cumsum_i32(zero)  # rank + 1 among the zeros
        total_zero = c[-1]
        iota = torch.arange(n, dtype=torch.int32, device=digit.device)
        return torch.where(zero, c - 1, total_zero + (iota - c))
    dest = torch.zeros(n, dtype=torch.int32, device=digit.device)
    base = torch.zeros((), dtype=torch.int32, device=digit.device)
    for v in range(1 << width):
        sel = digit == v
        c = _cumsum_i32(sel)
        dest = torch.where(sel, base + c - 1, dest)
        base = base + c[-1]
    return dest


def _permute(dest: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Apply a destination map (a permutation) as one scatter: the port
    sorts one int64 word where the reference moves two uint32 words."""
    out = torch.empty_like(a)
    out.index_put_((dest,), a)
    return out


def radix_sort_packed(key: torch.Tensor, sig_lo: int,
                      sig_hi: int) -> torch.Tensor:
    """Stable LSD radix sort of int64 ``key`` by its bits
    ``[sig_lo, sig_hi)``, read as unsigned; the bits below ``sig_lo``
    ride along.  Returns the sorted key."""
    if key.shape[0] == 0:
        return key
    d = radix_bits()
    shift = sig_lo
    while shift < sig_hi:
        width = min(d, sig_hi - shift)
        digit = (key >> shift) & ((1 << width) - 1)
        key = _permute(_split_destinations(digit, width), key)
        shift += width
    return key
