"""Row-key encoding for sort and equality kernels.

The port of ``cylon_tpu/ops/keys.py`` (reference: arrow_comparator.hpp
row comparators and util/sort.hpp index sorts).  Typed columns become
flat sortable operands, each operand becomes an order-preserving unsigned
field, and fields are bit-packed MSB-first into 32-bit words, so that
lexicographic order and row equality over the words equal those over the
columns.

A string column's operands are its byte matrix packed into big-endian
64-bit words (``pack_string_words``): zero padding keeps bytewise order,
so the word tuple orders as the strings do.  A sort key of at most 4
bytes a row is one narrow field instead (``short_string_operand``), so a
key of short strings still fits the one-sort fast path.

Torch on the CPU has no ``<<``, ``>>`` or ``%`` for ``uint32``, and no
uint64 arithmetic, so every packed word is carried in ``int64``: a field
of at most 32 bits as its non-negative value, a 64-bit field (int64 /
float64 data, a packed string word) as the bit pattern of its unsigned
encoding.  ``_WIDE`` marks the latter; they sort with the sign bit
flipped.  A string word enters the operand list as a ``torch.uint64``
view of that pattern, which tells ``_ordered_unsigned`` it is unsigned
already.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..column import Column
from . import compact

_INT64_MIN = -(1 << 63)
_MASK32 = 0xFFFFFFFF
_WIDE = 64  # field width of a standalone 64-bit word
_SHORT_STRING = 4  # widest byte matrix a sort key carries as one field

#: sorts ``lexsort_indices`` launched, by path: ``packed`` one a call of
#: the one-key fast path, ``words`` one a packed word of the other
SORTS = {"packed": 0, "words": 0}


_BYTE_LANES = (0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF)


def _bswap64(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 8 bytes of each int64.  ``>>`` is arithmetic, so every
    right shift is masked before the halves combine."""
    m8, m16 = _BYTE_LANES
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    x = ((x >> 16) & m16) | ((x & m16) << 16)
    return ((x >> 32) & 0xFFFFFFFF) | (x << 32)


def pack_string_words(data: torch.Tensor) -> List[torch.Tensor]:
    """Pack a uint8[n, W] byte matrix into ceil(W/8) int64[n] words, each
    the bit pattern of the big-endian uint64 of 8 bytes
    (``cylon_tpu/ops/keys.py:32``); the word tuple's unsigned order is the
    bytewise order.  The matrix is read as little-endian int64 lanes and
    byte-swapped, one word at a time: no ``[n, W]`` int64 temporary."""
    n, width = data.shape
    pad = (-width) % 8
    if pad:
        data = torch.cat([data, torch.zeros((n, pad), dtype=torch.uint8,
                                            device=data.device)], dim=1)
    lanes = data.contiguous().view(torch.int64)
    return [_bswap64(lanes[:, i]) for i in range(lanes.shape[1])]


def column_operands(col: Column, *, nulls_first: bool = True,
                    with_validity: bool = True) -> List[torch.Tensor]:
    """Sortable operands for one column, most significant first: the
    validity flag (nulls first by default), then the data, or a string's
    packed words as ``torch.uint64`` views."""
    ops: List[torch.Tensor] = []
    if with_validity:
        ops.append(col.validity if nulls_first else ~col.validity)
    if col.is_string:
        ops.extend(w.view(torch.uint64) for w in pack_string_words(col.data))
    else:
        ops.append(col.data)
    return ops


def short_string_operand(data: torch.Tensor) -> torch.Tensor:
    """One integer operand for a uint8[n, W] byte matrix, 1 <= W <= 4,
    whose order is the bytewise order: the W bytes as one big-endian
    value, ``uint8`` for W = 1, else biased by -2^(8W-1) into ``int16``
    (W = 2) or ``int32`` (W = 3, 4), whose sign bias in
    ``_ordered_unsigned`` undoes it.  Biasing the first byte keeps every
    partial value in the dtype's range."""
    width = data.shape[1]
    if width == 1:
        return data[:, 0]
    dt = torch.int16 if width == 2 else torch.int32
    v = data[:, 0].to(dt) - 128
    for j in range(1, width):
        v = v * 256 + data[:, j].to(dt)
    return v


def padding_operand(capacity: int, row_count, device) -> torch.Tensor:
    """First sort operand: False for live rows, True for padding, so
    padding always sorts last."""
    return torch.arange(capacity, dtype=torch.int32,
                        device=device) >= row_count


def build_operands(cols: Sequence[Column], row_count, capacity: int, *,
                   ascending: Optional[Sequence[bool]] = None,
                   nulls_first: bool = True) -> List[torch.Tensor]:
    """All sort operands of a multi-column key, padding flag first.  A
    descending column flips its data operand only, so null placement
    follows ``nulls_first`` alone.  A string of at most 4 bytes is one
    narrow operand (``short_string_operand``), not a 64-bit word."""
    ops = [padding_operand(capacity, row_count, cols[0].device)]
    for i, col in enumerate(cols):
        if col.is_string and 1 <= col.string_width <= _SHORT_STRING:
            col_ops = [col.validity if nulls_first else ~col.validity,
                       short_string_operand(col.data)]
        else:
            col_ops = column_operands(col, nulls_first=nulls_first)
        if ascending is not None and not ascending[i]:
            col_ops = [col_ops[0]] + [_invert_operand(o) for o in col_ops[1:]]
        ops.extend(col_ops)
    return ops


def _invert_operand(x: torch.Tensor) -> torch.Tensor:
    """Order-reversing transform for one operand."""
    if x.dtype == torch.uint64:  # a string word's or uint64 data's bits
        return (~x.view(torch.int64)).view(torch.uint64)
    if x.dtype in (torch.bool, torch.uint8):
        return ~x
    if x.is_floating_point():
        return -x
    if not x.is_signed():  # uint16 / uint32: no ``~`` on the CPU
        x = x.to(torch.int64)
    return -1 - x


def signed_carrier(x: torch.Tensor):
    """(carrier, restore) for an op torch lacks on unsigned dtypes (``~``,
    ``min``/``max``, ``scatter_reduce_`` "amin"/"amax" on the CPU):
    ``uint16`` and ``uint32`` ride in ``int64``, ``uint64`` in its
    sign-flipped ``int64`` view, which orders as the unsigned values do.
    ``restore`` maps a carrier result back to ``x``'s dtype; every other
    dtype passes through."""
    dt = x.dtype
    if dt in (torch.uint16, torch.uint32):
        return x.to(torch.int64), lambda y: y.to(dt)
    if dt == torch.uint64:
        return (x.view(torch.int64) ^ _INT64_MIN,
                lambda y: (y ^ _INT64_MIN).view(torch.uint64))
    return x, lambda y: y


def canonical_float(x: torch.Tensor) -> torch.Tensor:
    """Float data with -0.0 folded into +0.0 and every NaN payload into
    the one NaN torch makes of ``float("nan")``, so equal keys have equal
    bits (``cylon_tpu/ops/keys.py:121-125``)."""
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    return torch.where(torch.isnan(x),
                       torch.full((), float("nan"), dtype=x.dtype,
                                  device=x.device), x)


def _ordered_unsigned(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(int64 tensor, bit width) of an order-preserving unsigned encoding:
    signed ints are biased by the sign bit; floats take the total-order
    bit trick after -0.0 is folded into +0.0 and every NaN payload into
    one NaN (``cylon_tpu/ops/keys.py:121-125``)."""
    dt = x.dtype
    if dt == torch.bool:
        return x.to(torch.int64), 1
    if dt.is_floating_point:
        x = canonical_float(x)
        w = dt.itemsize * 8
        if w == 64:
            bits = x.view(torch.int64)
            return torch.where(bits < 0, ~bits, bits | _INT64_MIN), _WIDE
        sint = {16: torch.int16, 32: torch.int32}[w]
        bits = x.view(sint).to(torch.int64) & ((1 << w) - 1)
        top = 1 << (w - 1)
        return torch.where(bits >= top, bits ^ ((1 << w) - 1), bits | top), w
    w = dt.itemsize * 8
    if dt in (torch.int64, torch.uint64):
        bits = x.view(torch.int64)
        return (bits ^ _INT64_MIN if dt == torch.int64 else bits), _WIDE
    if dt.is_signed:
        return x.to(torch.int64) + (1 << (w - 1)), w
    return x.to(torch.int64), w


def _bit_width(dt: torch.dtype) -> int:
    """The bit width ``_ordered_unsigned`` gives an operand of ``dt``."""
    if dt == torch.bool:
        return 1
    w = dt.itemsize * 8
    return _WIDE if w == 64 else w


def pack_operands(operands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Greedily bit-pack the operands' order-preserving encodings into
    32-bit words (fields MSB-first within a word; 64-bit fields pass
    through as standalone words).  Lexicographic order and row equality
    over the words equal those over the operand list."""
    return [w for w, _ in _pack_encoded([_ordered_unsigned(o)
                                         for o in operands])]


def _pack_encoded(enc) -> List[Tuple[torch.Tensor, int]]:
    """(word, width) pairs; width is ``_WIDE`` for a 64-bit word."""
    out: List[Tuple[torch.Tensor, int]] = []
    cur = None
    used = 0
    for bits, w in enc:
        if w >= 64:
            if cur is not None:
                out.append((cur, used))
            cur, used = None, 0
            out.append((bits, _WIDE))
            continue
        if cur is None or used + w > 32:
            if cur is not None:
                out.append((cur, used))
            cur, used = bits, w
        else:
            cur = (cur << w) | bits
            used += w
    if cur is not None:
        out.append((cur, used))
    return out


def _sort_key(word: torch.Tensor, width: int) -> torch.Tensor:
    """A signed int64 whose order is the word's unsigned order."""
    return word ^ _INT64_MIN if width >= 64 else word


def lexsort_indices(operands: Sequence[torch.Tensor],
                    capacity: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable lexicographic argsort over bit-packed operands.  Returns
    (int32 permutation, sorted packed words), the words split as the JAX
    package splits them, so both can be compared word for word.  A key
    holding a short string (``build_operands``) packs narrower fields
    than the JAX package's 64-bit words: its words are the port's own,
    and its permutation is still the JAX package's.

    Fast path: when the key fields plus a row index fit 64 bits, they are
    assembled into ONE int64 with the index in the low bits and sorted
    once; unique keys make the sort stable for free.  A 64-bit key has its
    sign bit flipped so the signed sort gives unsigned order.  Otherwise
    the packed words are sorted least significant first with stable
    sorts.  ``SORTS`` counts the sorts: one a call on the fast path, one
    a word on the other.  The fast path's key is built in place, one
    operand's encoding at a time, so no two encodings live at once."""
    total_bits = sum(_bit_width(o.dtype) for o in operands)
    idx_bits = compact.index_bits(capacity)
    device = operands[0].device
    if total_bits + idx_bits <= 64:
        key = torch.zeros(capacity, dtype=torch.int64, device=device)
        for o in operands:
            bits, w = _ordered_unsigned(o)
            key.bitwise_left_shift_(w).bitwise_or_(bits)
            del bits
        key.bitwise_left_shift_(idx_bits).bitwise_or_(
            torch.arange(capacity, dtype=torch.int64, device=device))
        width = total_bits + idx_bits
        SORTS["packed"] += 1
        s = _sort_key(torch.sort(_sort_key(key, width), stable=False).values,
                      width)
        perm = (s & ((1 << idx_bits) - 1)).to(torch.int32)
        if width <= 32:
            return perm, [s >> idx_bits]
        hi = (s >> 32) & _MASK32
        lo = (s & _MASK32) >> idx_bits
        return perm, [hi, lo]
    packed = _pack_encoded([_ordered_unsigned(o) for o in operands])
    perm = torch.arange(capacity, dtype=torch.int64, device=device)
    SORTS["words"] += len(packed)
    for word, width in reversed(packed):
        order = torch.sort(_sort_key(word[perm], width), stable=True).indices
        perm = perm[order]
    return perm.to(torch.int32), [w[perm] for w, _ in packed]


def rows_equal_adjacent(
        sorted_operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool[n]: row i has the same key as row i-1 (row 0 -> False)."""
    eq = None
    for op in sorted_operands:
        e = torch.cat([torch.zeros(1, dtype=torch.bool, device=op.device),
                       op[1:] == op[:-1]])
        eq = e if eq is None else (eq & e)
    return eq


def dense_group_ids(sorted_operands: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group_id[n], num_groups incl. padding) over sorted rows: 0-based,
    nondecreasing, equal keys share an id."""
    new_group = ~rows_equal_adjacent(sorted_operands)
    gid = torch.cumsum(new_group, 0, dtype=torch.int32) - 1
    num = gid[-1] + 1 if gid.shape[0] else torch.zeros(
        (), dtype=torch.int32, device=gid.device)
    return gid, num
