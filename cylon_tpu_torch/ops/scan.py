"""Inclusive scans of 1-D 32-bit tensors: the CUDA scan kernel family
(``cuda/scan.cu``) for CUDA tensors, a plain PyTorch version for CPU
tensors.

Replaces the JAX package's Pallas TPU scans:

- ``scan_1d`` <- ``cylon_tpu/ops/pallas_scan.py:222`` (``_scan_padded``,
  ``_sweep1_plain_kernel``): cumsum / cummax / cummin, optionally right
  to left;
- ``segmented_scan`` <- ``cylon_tpu/ops/pallas_scan.py:150`` and ``:177``
  (``_segmented_scan_padded``, sweeps 1 and 2): the same combine
  restarting at reset flags, ``(va,fa) o (vb,fb) = (fb ? vb : fn(va,vb),
  fa|fb)``.

Bound on an H100 (3.35 TB/s): memory.  The plain scan must move 8 B per
element (4 B in, 4 B out), the segmented scan 9 B (4 B value + 1 B flag in,
4 B out).

``scan_1d`` is one pass with decoupled look-back (Merrill & Garland,
NVIDIA 2016): one launch after a memset of its status words, 8 B per
element.  Each block takes a 4096-element tile from an atomic counter; its
data warps load the tile with 16-byte vector loads, scan it in registers
and publish its aggregate, while one more warp folds the predecessors'
aggregates and prefixes until it meets an inclusive prefix.  It replaces a
tile scan, a recursive scan of the tile totals and a fix-up over every
element (16 B per element, five launches at 2^27).

``segmented_scan`` scans each 4096-element tile in one block (registers,
warp shuffles, shared memory), scans the tile totals recursively with the
same kernel, and folds each tile's carry into its elements before the
tile's first reset: about 9 B per element.  Padding is the op's neutral
element, as in ``pallas_scan.py:58-64``.

Results are exact for integers and for min/max.  A float32 sum rounds in
the kernel's tree order, and in ``scan_1d`` also in the order the look-back
happens to find, so two calls may differ in rounding; it agrees with the
plain version and with the JAX package to a tolerance, as the Pallas
kernel's own contract says (``pallas_scan.py:26-31``).

A wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts the
wrappers' kernel launches, one per call.
"""
from __future__ import annotations

import ctypes

import torch

OPS = ("sum", "min", "max")
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.uint32: 2}
SCAN_1D_TILE = 4096  # kLbTile in cuda/scan.cu

LAUNCHES = {"scan_1d": 0, "segmented_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch versions ---------------------------------------------------

def _fn(op: str):
    return {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}[op]


def _via_int64(plain, x: torch.Tensor, *args) -> torch.Tensor:
    """Run a plain scan of uint32 ``x`` in int64 (torch has no uint32
    add/min/max/flip on the CPU); sums wrap to 32 bits as the kernel's."""
    out = plain(x.to(torch.int64), *args)
    return (out & 0xFFFFFFFF).to(torch.uint32)


def segmented_scan_plain(x: torch.Tensor, reset: torch.Tensor,
                         op: str) -> torch.Tensor:
    """Hillis-Steele inclusive scan over (value, flag) pairs with the
    segmented combine: log2(n) steps, each combining every element with
    the one d places before it."""
    if x.dtype == torch.uint32:
        return _via_int64(segmented_scan_plain, x, reset, op)
    fn = _fn(op)
    v, f = x, reset
    n = v.shape[0]
    d = 1
    while d < n:
        head_v, head_f = v[:d], f[:d]
        tail_v = torch.where(f[d:], v[d:], fn(v[:-d], v[d:]))
        tail_f = f[d:] | f[:-d]
        v = torch.cat([head_v, tail_v])
        f = torch.cat([head_f, tail_f])
        d *= 2
    return v.clone() if v is x else v


def scan_1d_plain(x: torch.Tensor, op: str,
                  reverse: bool = False) -> torch.Tensor:
    """Hillis-Steele inclusive scan without flags."""
    if x.dtype == torch.uint32:
        return _via_int64(scan_1d_plain, x, op, reverse)
    fn = _fn(op)
    v = torch.flip(x, (0,)) if reverse else x
    n = v.shape[0]
    d = 1
    while d < n:
        v = torch.cat([v[:d], fn(v[:-d], v[d:])])
        d *= 2
    if reverse:
        return torch.flip(v, (0,))
    return v.clone() if v is x else v


# -- kernel launches ----------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cts_scan_1d.argtypes = [i, i, vp, vp, vp, ll, i, vp]
    lib.cts_scan_1d.restype = i
    lib.cts_scan_1d_tile.argtypes = []
    lib.cts_scan_1d_tile.restype = i
    lib.cts_scan_1d_scratch_words.argtypes = [ll]
    lib.cts_scan_1d_scratch_words.restype = ll
    lib.cts_tile_scan.argtypes = [i, i, vp, vp, vp, vp, vp, vp, ll, vp]
    lib.cts_tile_scan.restype = i
    lib.cts_fixup.argtypes = [i, i, vp, vp, vp, ll, vp]
    lib.cts_fixup.restype = i
    lib.cts_tile_size.argtypes = []
    lib.cts_tile_size.restype = i
    if lib.cts_scan_1d_tile() != SCAN_1D_TILE:
        raise RuntimeError("scan.cu and ops/scan.py disagree on scan_1d's "
                           "tile size")


def _lib() -> ctypes.CDLL:
    from ..cuda import build

    return build.load("scan.cu", _declare)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _launch_1d(x: torch.Tensor, out: torch.Tensor, op: str,
               reverse: bool) -> None:
    """The look-back scan of ``x`` into ``out``: one memset of the scratch
    words (a status word per tile, then the tile counter), one launch."""
    lib = _lib()
    n = x.shape[0]
    scratch = torch.empty(lib.cts_scan_1d_scratch_words(n),
                          dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.cts_scan_1d(_DTYPE_CODE[x.dtype], _OP_CODE[op],
                               x.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), n, int(reverse), stream),
               "scan_1d")


def _launch_segmented(x: torch.Tensor, flags: torch.Tensor,
                      out: torch.Tensor, op: str) -> None:
    """tile_scan over ``x`` into ``out``; if more than one tile, scan the
    tile totals (recursively) and fix the tiles up with the carries."""
    lib = _lib()
    n = x.shape[0]
    tile = lib.cts_tile_size()
    tiles = -(-n // tile)
    agg_v = torch.empty(tiles, dtype=x.dtype, device=x.device)
    agg_f = torch.empty(tiles, dtype=torch.uint8, device=x.device)
    first = torch.empty(tiles, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dt, oc = _DTYPE_CODE[x.dtype], _OP_CODE[op]
    _check(lib.cts_tile_scan(dt, oc, x.data_ptr(), flags.data_ptr(),
                             out.data_ptr(), agg_v.data_ptr(),
                             agg_f.data_ptr(), first.data_ptr(), n, stream),
           "tile_scan")
    if tiles > 1:
        carry = torch.empty_like(agg_v)
        _launch_segmented(agg_v, agg_f, carry, op)
        _check(lib.cts_fixup(dt, oc, out.data_ptr(), carry.data_ptr(),
                             first.data_ptr(), n, stream),
               "fixup")


def _validate(x: torch.Tensor, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"scan op must be one of {OPS}, got {op!r}")
    if x.ndim != 1 or x.dtype not in _DTYPE_CODE:
        raise ValueError("scan: 1-D int32, float32 or uint32 input required, "
                         f"got {x.dtype} of shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scan: unsupported device {x.device}")


def scan_1d(x: torch.Tensor, op: str, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan (cumsum / cummin / cummax) of 1-D 32-bit ``x``;
    ``reverse=True`` scans right to left."""
    _validate(x, op)
    if x.shape[0] == 0:
        return x.clone()
    if x.device.type == "cpu":
        return scan_1d_plain(x, op, reverse)
    if not x.is_contiguous():
        raise ValueError("scan_1d: contiguous input required")
    out = torch.empty_like(x)
    _launch_1d(x, out, op, reverse)
    LAUNCHES["scan_1d"] += 1
    return out


def segmented_scan(x: torch.Tensor, reset: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Inclusive segmented scan of 1-D 32-bit ``x``; ``reset`` (bool)
    marks the rows that start a segment."""
    _validate(x, op)
    if reset.shape != x.shape or reset.dtype != torch.bool \
            or reset.device != x.device:
        raise ValueError("segmented_scan: reset must be a bool tensor of "
                         "x's shape on x's device")
    if x.shape[0] == 0:
        return x.clone()
    if x.device.type == "cpu":
        return segmented_scan_plain(x, reset, op)
    if not (x.is_contiguous() and reset.is_contiguous()):
        raise ValueError("segmented_scan: contiguous inputs required")
    out = torch.empty_like(x)
    _launch_segmented(x, reset.view(torch.uint8), out, op)
    LAUNCHES["segmented_scan"] += 1
    return out
