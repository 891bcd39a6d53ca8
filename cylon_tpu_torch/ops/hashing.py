"""Vectorized row hash of any key columns, strings included.

The port of ``cylon_tpu/ops/hashing.py:28-81``: each column hashes
lane-wise with the murmur3 ``fmix32`` finalizer, 8-byte values and packed
string words first avalanche to 32 bits with the splitmix64 finalizer, and
columns combine as ``h = 31*h + column_hash`` from ``h = 0``.  A string
folds its packed big-endian words (``keys.pack_string_words``) from seed
``0x9747B28C`` and is finalized once; a null row hashes to ``0x52ABD123``.
Float data is folded first (``keys.canonical_float``: -0.0 as +0.0, one
NaN), which the JAX package's copy does not do, so keys that compare equal
always land on one shard.

In the JAX package this is a plain jnp function, outside any Pallas
kernel, and it places the rows of every key set holding a string
(``parallel/partition.py:hash_targets``); here it is plain PyTorch, on the
card and on the CPU alike.

Torch has no uint32 or uint64 arithmetic on the CPU, so every lane rides
in int64: 32-bit values as their non-negative value, masked to 32 bits
after each multiply and add; 64-bit values as their bit pattern, whose
products wrap modulo 2^64 as uint64 products do.  ``>>`` on int64 is
arithmetic, so a 64-bit logical shift masks off the sign copies.  Hashes
come back as int64 tensors holding the uint32 value.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..column import Column
from . import keys

_M32 = 0xFFFFFFFF
STRING_SEED = 0x9747B28C
NULL_HASH = 0x52ABD123


def _signed64(c: int) -> int:
    """The int64 value of a uint64 constant's bit pattern."""
    return c - (1 << 64) if c >= (1 << 63) else c


_MIX1 = _signed64(0xBF58476D1CE4E5B9)
_MIX2 = _signed64(0x94D049BB133111EB)


def _lsr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 x86_32 finalizer of 32-bit values held in int64."""
    h = h & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _mix64_to_32(x: torch.Tensor) -> torch.Tensor:
    """Avalanche 64-bit patterns down to 32 bits: the splitmix64 finalizer,
    then ``x ^ (x >> 32)`` truncated."""
    x = x ^ _lsr64(x, 30)
    x = x * _MIX1
    x = x ^ _lsr64(x, 27)
    x = x * _MIX2
    x = x ^ _lsr64(x, 31)
    return (x ^ _lsr64(x, 32)) & _M32


_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def hash_column(col: Column) -> torch.Tensor:
    """int64[capacity] holding each row's uint32 hash; null rows hash to
    ``NULL_HASH``."""
    if col.is_string:
        h = torch.full((col.capacity,), STRING_SEED, dtype=torch.int64,
                       device=col.device)
        for w in keys.pack_string_words(col.data):
            h = (h * 31 + _mix64_to_32(w)) & _M32
        h = _fmix32(h)
    else:
        data = col.data
        if data.is_floating_point():
            data = keys.canonical_float(data)  # -0.0 and +0.0 hash alike
        if data.dtype == torch.bool:
            h = _fmix32(data.to(torch.int64))
        elif data.dtype.itemsize <= 4:
            size = data.dtype.itemsize
            bits = data.view(_VIEW[size]).to(torch.int64)
            h = _fmix32(bits & ((1 << (8 * size)) - 1))
        else:
            h = _fmix32(_mix64_to_32(data.view(torch.int64)))
    return torch.where(col.validity, h,
                       torch.full((), NULL_HASH, dtype=torch.int64,
                                  device=col.device))


def hash_columns(cols: Sequence[Column]) -> torch.Tensor:
    """Composite row hash ``h = 31*h + hash_column(col)`` from ``h = 0``
    (the reference's UpdateHash combiner, partition/partition.cpp:145-160),
    as int64 holding the uint32 value."""
    h = torch.zeros(cols[0].capacity, dtype=torch.int64,
                    device=cols[0].device)
    for col in cols:
        h = (h * 31 + hash_column(col)) & _M32
    return h
