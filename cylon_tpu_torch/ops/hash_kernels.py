"""Row hash and hash-partition targets of fixed-width key columns: the CUDA
murmur3 kernel (``cuda/murmur3.cu``) for CUDA tensors, a plain PyTorch
version for CPU tensors.

Replaces the JAX package's Pallas TPU kernel
``cylon_tpu/ops/pallas_kernels.py:84 _hash_kernel`` (``pl.pallas_call`` at
``:113``, entered through ``hash_partition:129``), bit for bit: murmur3_x86_32
with seed 0 over each key column's little-endian 32-bit words
(``column_words``; float keys folded first, so -0.0 hashes as +0.0 and
every NaN alike), columns combined as ``h = 31*h + column_hash`` from
``h = 1``, null rows hashed as zero words, and the target ``h & (world-1)``
for a power-of-two ``world``, else ``h % world``.  Results equal the native
host hasher's ``ct_row_hash`` (``cylon_tpu/native/src/hashing.cpp``).

Bound on an H100 (3.35 TB/s): memory.  The kernel reads each key and
validity byte once and writes the uint32 hash and int32 target once: 13 B
per row for one int32 key with validity.  It needs no padding and no
intermediate tensor.

Torch on the CPU has no uint32 multiply, shift or ``%``, so the plain
version carries each 32-bit word in int64 and masks to 32 bits after every
multiply, add and shift; int64 products wrap modulo 2^64, so the low word
stays right.

A wrapper takes the plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, one
per call; ``CALLS`` counts the wrapper's calls, kernel or plain version
(the cylint budgets read it).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..column import Column
from ..status import Code, CylonError
from . import keys

C1 = 0xCC9E2D51
C2 = 0x1B873593
_MASK = 0xFFFFFFFF
MAX_COLS = 8  # CMH_MAX_COLS in cuda/murmur3.cu

LAUNCHES = {"hash_partition": 0}
CALLS = {"hash_partition": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(cols: Sequence[Column]) -> bool:
    return all(not c.is_string for c in cols)


def _check(cols: Sequence[Column], world: int) -> None:
    if not cols:
        raise ValueError("hash_partition: at least one key column required")
    if not supported(cols):
        raise CylonError(Code.NotImplemented,
                         "the murmur3 kernel hashes fixed-width keys only; "
                         "string keys hash with ops/hashing.py")
    if world < 1:
        raise ValueError(f"hash_partition: world must be >= 1, got {world}")
    cap = cols[0].capacity
    dev = cols[0].device
    for c in cols:
        if c.data.ndim != 1 or c.capacity != cap or c.device != dev \
                or c.validity.shape != c.data.shape \
                or c.validity.dtype != torch.bool \
                or c.validity.device != dev:
            raise ValueError("hash_partition: key columns must be 1-D, of one "
                             "capacity, with bool validity, on one device")
        if c.data.dtype.itemsize not in (1, 2, 4, 8):
            raise ValueError("hash_partition: unsupported dtype "
                             f"{c.data.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_partition: unsupported device {dev}")


# -- plain PyTorch version ----------------------------------------------------

_UNSIGNED_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int32}


def column_words(col: Column) -> List[torch.Tensor]:
    """The column's 32-bit words, little-endian order: one for values of at
    most 4 bytes, lo then hi for 8-byte values.  4- and 8-byte integer data
    give views of its bytes (as int32 bit patterns, no copy); 1- and 2-byte
    data are zero-extended into int32, and bool gives 0/1.  Float data is
    first folded to one bit pattern per value (``keys.canonical_float``:
    -0.0 as +0.0, one NaN), so keys that compare equal hash alike."""
    data = col.data
    if col.is_string:
        raise CylonError(Code.NotImplemented,
                         "column_words takes fixed-width columns only")
    if data.is_floating_point():
        data = keys.canonical_float(data)
    if data.dtype == torch.bool:
        return [data.to(torch.int32)]
    size = data.dtype.itemsize
    bits = data.view(_UNSIGNED_VIEW[size])
    if size == 1:
        return [bits.to(torch.int32)]
    if size == 2:
        return [bits.to(torch.int32) & 0xFFFF]
    if size == 4:
        return [bits]
    pairs = bits.view(-1, 2)
    return [pairs[:, 0], pairs[:, 1]]


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier of a 32-bit word's unsigned value."""
    return x.to(torch.int64) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur3_words_plain(words: Sequence[torch.Tensor],
                        seed: int = 0) -> torch.Tensor:
    """murmur3_x86_32 of the little-endian concatenation of 32-bit words,
    per row (the whole-block path; word input has no tail).  Returns the
    hash in an int64 tensor, as its unsigned value."""
    h = torch.full(words[0].shape, seed, dtype=torch.int64,
                   device=words[0].device)
    for w in words:
        k = (_u32(w) * C1) & _MASK
        k = _rotl(k, 15)
        k = (k * C2) & _MASK
        h = h ^ k
        h = _rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    h = h ^ (4 * len(words))
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK
    return h ^ (h >> 16)


def _targets(h: torch.Tensor, world: int) -> torch.Tensor:
    if world & (world - 1) == 0:
        return (h & (world - 1)).to(torch.int32)
    return (h % world).to(torch.int32)


def hash_partition_plain(cols: Sequence[Column], world: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint32 hash[cap], int32 target[cap]) in plain PyTorch, on whatever
    device the columns lie."""
    h = torch.ones(cols[0].capacity, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        valid = c.validity
        words = [torch.where(valid, _u32(w), 0) for w in column_words(c)]
        h = (h * 31 + murmur3_words_plain(words)) & _MASK
    return h.to(torch.uint32), _targets(h, world)


# -- kernel launch ------------------------------------------------------------

class _Columns(ctypes.Structure):
    """ctypes mirror of ``CmhColumns`` in cuda/murmur3.cu."""

    _fields_ = [("data", ctypes.c_void_p * MAX_COLS),
                ("valid", ctypes.c_void_p * MAX_COLS),
                ("width", ctypes.c_int * MAX_COLS),
                ("is_bool", ctypes.c_int * MAX_COLS),
                ("is_float", ctypes.c_int * MAX_COLS),
                ("ncols", ctypes.c_int)]


# ``is_float`` codes of the column spec: which float layout the kernel
# folds to one bit pattern per value
_FLOAT_KIND = {torch.float16: 1, torch.float32: 1, torch.float64: 1,
               torch.bfloat16: 2}


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.cmh_hash_partition.argtypes = [ctypes.POINTER(_Columns),
                                       ctypes.c_longlong, ctypes.c_int,
                                       vp, vp, vp]
    lib.cmh_hash_partition.restype = ctypes.c_int
    lib.cmh_max_cols.argtypes = []
    lib.cmh_max_cols.restype = ctypes.c_int
    if lib.cmh_max_cols() != MAX_COLS:
        raise RuntimeError("murmur3.cu and ops/hash_kernels.py disagree on "
                           "the column limit")


def _lib() -> ctypes.CDLL:
    from ..cuda import build

    return build.load("murmur3.cu", _declare)


def _launch(cols: Sequence[Column], world: int, hash_out: torch.Tensor,
            target_out: torch.Tensor) -> None:
    spec = _Columns()
    for j, c in enumerate(cols):
        if not (c.data.is_contiguous() and c.validity.is_contiguous()):
            raise ValueError("hash_partition: contiguous key columns required")
        spec.data[j] = c.data.data_ptr()
        spec.valid[j] = c.validity.data_ptr()
        spec.width[j] = c.data.dtype.itemsize
        spec.is_bool[j] = int(c.data.dtype == torch.bool)
        spec.is_float[j] = _FLOAT_KIND.get(c.data.dtype, 0)
    spec.ncols = len(cols)
    dev = hash_out.device
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cmh_hash_partition(ctypes.byref(spec), hash_out.shape[0],
                                    world, hash_out.data_ptr(),
                                    target_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_partition launch failed: CUDA error {rc}")


def hash_partition(cols: Sequence[Column], world: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint32 hash[cap], int32 target[cap]) of fixed-width key columns.
    Padding rows get whatever the hash of their bytes lands on; callers
    mask them (``parallel/partition.hash_targets`` does)."""
    _check(cols, world)
    CALLS["hash_partition"] += 1
    cap = cols[0].capacity
    dev = cols[0].device
    if dev.type == "cpu":
        return hash_partition_plain(cols, world)
    if len(cols) > MAX_COLS:
        raise ValueError(f"hash_partition: at most {MAX_COLS} key columns "
                         f"on the card, got {len(cols)}")
    h = torch.empty(cap, dtype=torch.uint32, device=dev)
    t = torch.empty(cap, dtype=torch.int32, device=dev)
    if cap == 0:
        return h, t
    _launch(cols, world, h, t)
    LAUNCHES["hash_partition"] += 1
    return h, t
