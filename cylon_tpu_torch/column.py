"""Device-resident column.

The port of ``cylon_tpu/column.py:64 Column`` (reference:
cpp/src/cylon/column.hpp:31-113) over torch tensors:

- every column has a static **capacity** (``data.shape[0]``); the number
  of live rows is carried beside it, and padding rows are zeroed;
- nulls are a ``bool[capacity]`` validity tensor (True = present);
- STRING / BINARY / FIXED_SIZE_BINARY columns are zero-padded byte
  matrices ``uint8[capacity, width]`` with ``int32[capacity]`` lengths.
  Zero padding keeps bytewise order, so sort and compare kernels treat
  the matrix as the value.  Null and padding rows hold zero bytes and
  length zero: every kernel relies on it.

Arrow's offsets + bytes become the padded matrix at the host boundary
(``from_numpy``, ``from_native_buffers``, ``from_arrow``) and are re-ragged
on export (``to_numpy``, ``to_arrow``).  pyarrow is imported only inside
the Arrow functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import config, dtypes
from .dtypes import DataType, Type
from .obs import spans as obs_spans
from .status import Code, CylonError

DEFAULT_STRING_WIDTH = 32


def default_device() -> torch.device:
    """The device entry points run on when the caller names none: the
    first CUDA card.  Without one this raises; it never falls back to the
    CPU (pass ``device="cpu"`` to run there)."""
    if not torch.cuda.is_available():
        raise CylonError(Code.Invalid,
                         "no CUDA device available; pass device='cpu' to "
                         "run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def max_string_width() -> int:
    """The widest byte matrix a string column may ingest without an
    explicit ``string_width`` (``CYLON_TPU_MAX_STRING_WIDTH``): one long
    cell otherwise widens the whole column."""
    return int(config.knob("CYLON_TPU_MAX_STRING_WIDTH"))


def _check_width(needed: int, explicit: Optional[int]) -> None:
    cap = max_string_width()
    if needed > cap and (explicit is None or needed > explicit):
        raise CylonError(
            Code.Invalid,
            f"string cell of {needed} bytes exceeds the column width cap "
            f"{cap} (device memory = capacity x width); pass "
            f"string_width>={needed} or raise CYLON_TPU_MAX_STRING_WIDTH to "
            "ingest it")


# CUDA torch has no indexing and no ``where`` for uint16/uint32/uint64:
# gathers and selects of such data go through the same-width signed view,
# which moves the same bits.
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def bits_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as the same-width signed dtype if it is uint16/32/64."""
    signed = _SIGNED_VIEW.get(x.dtype)
    return x if signed is None else x.view(signed)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for any dtype, bit for bit."""
    return bits_view(x)[idx].view(x.dtype)


def zero_unless(keep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``where(keep, x, 0)`` for any dtype; ``keep`` broadcasts over the
    rows of a 2-D ``x``."""
    b = bits_view(x)
    if b.ndim == 2 and keep.ndim == 1:
        keep = keep[:, None]
    return torch.where(keep, b, torch.zeros((), dtype=b.dtype,
                                            device=b.device)).view(x.dtype)


@dataclass
class Column:
    """One typed column of device buffers.

    data:      [capacity] fixed-width values, or uint8[capacity, width]
    validity:  bool[capacity]; True = value present
    lengths:   int32[capacity] byte lengths (string-like only, else None)
    dtype:     logical type
    """

    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    dtype: DataType = dtypes.int64

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_string(self) -> bool:
        return dtypes.is_string_like(self.dtype)

    @property
    def string_width(self) -> int:
        return int(self.data.shape[1]) if self.data.ndim == 2 else 0

    def with_capacity(self, capacity: int) -> "Column":
        """Pad (with zeros and False) or truncate to a new capacity."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            return Column(self.data[:capacity], self.validity[:capacity],
                          None if self.lengths is None
                          else self.lengths[:capacity], self.dtype)
        pad = capacity - cap
        dev = self.device

        def grow(x):
            return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                             dtype=x.dtype, device=dev)])

        return Column(grow(self.data), grow(self.validity),
                      None if self.lengths is None else grow(self.lengths),
                      self.dtype)

    def take(self, indices: torch.Tensor,
             valid_mask: Optional[torch.Tensor] = None) -> "Column":
        """Gather rows by index, clamping out-of-range indices into
        [0, capacity) like ``jnp.take(..., mode="clip")``; optionally AND
        validity with ``valid_mask`` and zero the rows it clears, bytes and
        lengths included (the outer joins' null fill, reference
        join.cpp:179-235)."""
        idx = indices.clamp(0, self.capacity - 1)
        data = gather(self.data, idx)
        validity = self.validity[idx]
        lengths = None if self.lengths is None else self.lengths[idx]
        if valid_mask is not None:
            validity = validity & valid_mask
            data = zero_unless(validity, data)
            if lengths is not None:
                lengths = zero_unless(validity, lengths)
        return Column(data, validity, lengths, self.dtype)


def _next_capacity(n: int, capacity: Optional[int]) -> int:
    if capacity is not None:
        if capacity < n:
            raise ValueError(f"capacity {capacity} < row count {n}")
        return capacity
    return max(8, n)


# -- string encoding at the host boundary ---------------------------------

def _u_trailing_nul(values: np.ndarray) -> bool:
    """True if an element of a U-dtype array ends in NUL code points (the
    numpy U/S item convention strips them, so the vectorized encoder would
    drop those characters)."""
    n = len(values)
    w = values.dtype.itemsize // 4
    if n == 0 or w == 0:
        return False
    raw = np.ascontiguousarray(values).view(np.uint32).reshape(n, w)
    nz = raw != 0
    exact = np.where(nz.any(axis=1), w - np.argmax(nz[:, ::-1], axis=1), 0)
    return bool((exact != np.char.str_len(values)).any())


def _is_missing(v) -> bool:
    """pandas' missing-value rule for an object cell: None, a float NaN,
    or a pandas NA/NaT marker (recognised by type name: pandas is not
    required)."""
    if v is None:
        return True
    if isinstance(v, (float, np.floating)):
        return bool(np.isnan(v))
    return type(v).__name__ in ("NAType", "NaTType")


def _encode_rows_exact(values, missing):
    """Per-row exact encoder (bytes kept verbatim, str utf-8-encoded): the
    path for inputs the vectorized encoder cannot represent."""
    enc_list = [b"" if missing[i]
                else (bytes(v) if isinstance(v, (bytes, bytearray))
                      else str(v).encode("utf-8"))
                for i, v in enumerate(values)]
    w = max(1, max(map(len, enc_list)))
    lens = np.array([len(b) for b in enc_list], np.int32)
    return np.asarray(enc_list, f"S{w}"), missing, lens


def _encode_strings(values: np.ndarray):
    """(S-dtype encoded array, missing mask, exact lengths or None) of a
    U/S/object array, as ``cylon_tpu/column.py:166``: vectorized
    (``np.char``) except for bytes mixes and values ending in NUL, which
    take the exact per-row path.  ``None`` lengths mean
    ``np.char.str_len`` is exact."""
    n = len(values)
    if n == 0:
        return np.zeros((0,), "S1"), np.zeros((0,), bool), None
    if values.dtype.kind == "S":
        lens = np.array([len(v) for v in values], np.int32)  # NUL-exact
        return np.ascontiguousarray(values), np.zeros((n,), bool), lens
    if values.dtype.kind == "U":
        if _u_trailing_nul(values):
            return _encode_rows_exact(values, np.zeros((n,), bool))
        return np.char.encode(values, "utf-8"), np.zeros((n,), bool), None
    missing = np.fromiter((_is_missing(v) for v in values), bool, n)
    if any(isinstance(v, (bytes, bytearray))
           or (isinstance(v, str) and v.endswith("\x00")) for v in values):
        return _encode_rows_exact(values, missing)
    filled = values.copy()
    filled[missing] = ""
    return np.char.encode(filled.astype("U"), "utf-8"), missing, None


def _string_column(mat: np.ndarray, valid: np.ndarray, lens: np.ndarray,
                   dt: DataType, device) -> Column:
    """A string Column from host buffers at capacity, null and padding
    rows zeroed (bytes and lengths)."""
    mat[~valid] = 0
    lens = np.where(valid, lens, 0).astype(np.int32)
    return Column(torch.from_numpy(mat).to(device),
                  torch.from_numpy(valid).to(device),
                  torch.from_numpy(lens).to(device), dt)


def from_numpy(values: np.ndarray, *, validity: Optional[np.ndarray] = None,
               capacity: Optional[int] = None,
               string_width: int = DEFAULT_STRING_WIDTH,
               dtype: Optional[DataType] = None, device=None) -> Column:
    """Build a Column from a host numpy array, with the same capacity and
    null rules as ``cylon_tpu/column.py:193 from_numpy``: float NaN is a
    null, null and padding rows hold zero, and U/S/object arrays become
    byte matrices at least ``string_width`` wide (None and NaN cells are
    nulls)."""
    device = resolve_device(device)
    values = np.asarray(values)
    n = len(values)
    cap = _next_capacity(n, capacity)
    if values.dtype.kind in ("U", "S", "O"):
        enc, missing, exact_lens = _encode_strings(values)
        obs = enc.dtype.itemsize if n else 0
        _check_width(obs, string_width)
        width = max(string_width, obs)
        mat = np.zeros((cap, width), np.uint8)
        lens = np.zeros((cap,), np.int32)
        if n and obs:
            mat[:n, :obs] = np.ascontiguousarray(enc).view(np.uint8).reshape(
                n, obs)
            lens[:n] = (np.char.str_len(enc) if exact_lens is None
                        else exact_lens)
        valid = np.zeros((cap,), bool)
        valid[:n] = ~missing if validity is None else validity[:n]
        return _string_column(mat, valid, lens, dtype or dtypes.string,
                              device)
    if values.dtype.kind == "M":
        if validity is None:
            validity = ~np.isnat(values)
        values = values.astype("datetime64[us]").astype(np.int64)
        dt = dtype or dtypes.timestamp("us")
    else:
        dt = dtype or dtypes.from_numpy_dtype(values.dtype)
    if validity is None and values.dtype.kind == "f":
        validity = ~np.isnan(values)
    buf = np.zeros((cap,), values.dtype)
    valid = np.zeros((cap,), bool)
    valid[:n] = True if validity is None else validity[:n]
    buf[:n] = np.where(valid[:n], values, np.zeros((), values.dtype))
    return Column(torch.from_numpy(buf).to(device),
                  torch.from_numpy(valid).to(device), None, dt)


def from_native_buffers(data: np.ndarray, validity: Optional[np.ndarray],
                        lengths: Optional[np.ndarray] = None, *,
                        capacity: Optional[int] = None,
                        string_width: Optional[int] = None,
                        device=None) -> Column:
    """A Column from buffers already in the device layout
    (``cylon_tpu/column.py:236``): 1-D fixed-width data, or a 2-D uint8
    byte matrix with its lengths for strings (widened to ``string_width``
    when that is larger).  No per-row Python: pad to capacity and copy."""
    device = resolve_device(device)
    n = len(data)
    cap = _next_capacity(n, capacity)
    valid = np.zeros((cap,), bool)
    valid[:n] = True if validity is None else validity[:n]
    if data.ndim == 2:
        w = max(data.shape[1], string_width or 0)
        mat = np.zeros((cap, w), np.uint8)
        mat[:n, :data.shape[1]] = data
        lens = np.zeros((cap,), np.int32)
        if lengths is not None:
            lens[:n] = np.minimum(lengths, w)
        return _string_column(mat, valid, lens, dtypes.string, device)
    dt = dtypes.from_numpy_dtype(data.dtype)
    buf = np.zeros((cap,), data.dtype)
    buf[:n] = data
    buf[:n] = np.where(valid[:n], buf[:n], np.zeros((), data.dtype))
    return Column(torch.from_numpy(buf).to(device),
                  torch.from_numpy(valid).to(device), None, dt)


def from_arrow(arr, *, capacity: Optional[int] = None,
               string_width: int = DEFAULT_STRING_WIDTH,
               device=None) -> Column:
    """A Column from a pyarrow Array or ChunkedArray
    (``cylon_tpu/column.py:268``); dictionary arrays are decoded, and a
    null slot's undefined bytes never reach the matrix."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.dictionary_decode()
    dt = dtypes.from_arrow_type(arr.type)
    n = len(arr)
    validity = np.ones((n,), bool)
    if arr.null_count:
        validity = np.asarray(arr.is_valid())
    if dtypes.is_string_like(dt):
        cap = _next_capacity(n, capacity)
        if pa.types.is_fixed_size_binary(arr.type):
            w = arr.type.byte_width
            data = np.frombuffer(arr.buffers()[1], np.uint8)
            lo = arr.offset * w
            offsets = np.arange(lo, lo + (n + 1) * w, w, np.int64)
            lens_np = np.full((n,), w, np.int64)
        else:
            off_np = (np.int64 if pa.types.is_large_string(arr.type)
                      or pa.types.is_large_binary(arr.type) else np.int32)
            bufs = arr.buffers()
            offsets = np.frombuffer(bufs[1], off_np)[
                arr.offset: arr.offset + n + 1].astype(np.int64)
            data = (np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None
                    else np.zeros((0,), np.uint8))
            lens_np = np.diff(offsets)
        lens_np = np.where(validity[:n], lens_np, 0)
        obs = int(lens_np.max()) if n else 0
        _check_width(obs, string_width)
        width = max(string_width, obs)
        mat = np.zeros((cap, width), np.uint8)
        total = int(lens_np.sum())
        if total:
            # a ragged copy with O(total payload) temporaries
            starts = np.cumsum(lens_np) - lens_np
            within = np.arange(total, dtype=np.int64) - np.repeat(starts,
                                                                  lens_np)
            src = np.repeat(offsets[:-1], lens_np) + within
            dst_row = np.repeat(np.arange(n, dtype=np.int64), lens_np)
            mat[:n].reshape(-1)[dst_row * width + within] = data[src]
        lens = np.zeros((cap,), np.int32)
        lens[:n] = lens_np
        valid = np.zeros((cap,), bool)
        valid[:n] = validity[:n]
        return _string_column(mat, valid, lens, dt, resolve_device(device))
    if arr.null_count:
        # fill nulls before to_numpy: a nullable int64 would otherwise
        # detour through float64 and round values past 2^53
        if pa.types.is_boolean(arr.type):
            arr = arr.fill_null(False)
        elif pa.types.is_integer(arr.type) or pa.types.is_floating(arr.type):
            arr = arr.fill_null(0)
    np_vals = arr.to_numpy(zero_copy_only=False)
    if np_vals.dtype.kind in ("O", "m", "M"):
        np_vals = np.asarray(arr.cast(dtypes.to_arrow_type(dt)).to_numpy(
            zero_copy_only=False))
        if np_vals.dtype == object:
            np_vals = np.array([0 if v is None else v for v in np_vals],
                               dtype=dt.numpy_dtype())
    np_vals = np.ascontiguousarray(np_vals)
    if np_vals.dtype.kind == "f" and arr.null_count:
        np_vals = np.nan_to_num(np_vals, copy=False)
    if np_vals.dtype != dt.numpy_dtype():
        np_vals = np_vals.astype(dt.numpy_dtype())
    return from_numpy(np_vals, validity=validity, capacity=capacity, dtype=dt,
                      device=device)


def _bytes_rows(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """object[n] of per-row ``bytes`` of a padded byte matrix, through an
    S-dtype view; a row whose payload really ends in NUL bytes is cut to
    its length one by one."""
    n, w = mat.shape
    if n == 0 or w == 0:
        return np.full((n,), b"", object)
    sview = np.ascontiguousarray(mat).view(f"S{w}")[:, 0]
    out = sview.astype(object)
    for i in np.nonzero(np.char.str_len(sview) != lens)[0]:
        out[i] = mat[i, :lens[i]].tobytes()
    return out


def _decode_rows(rows: np.ndarray, valid: np.ndarray,
                 errors: str = "strict") -> np.ndarray:
    """object[n] of decoded str (raw bytes where utf-8 fails under
    ``errors='strict'``), None for null rows: ``np.char.decode`` with a
    per-row path for invalid utf-8 and payloads ending in NUL."""
    n = rows.shape[0]
    out = np.empty((n,), object)
    slow = (np.array([bool(v) and r.endswith(b"\x00")
                      for v, r in zip(valid, rows)], bool)
            if n else np.zeros((0,), bool))
    fast = valid & ~slow
    try:
        if fast.any():
            out[fast] = np.char.decode(rows[fast].astype("S"), "utf-8",
                                       errors).astype(object)
    except UnicodeDecodeError:
        fast = np.zeros_like(valid)
    for i in np.nonzero(valid & ~fast)[0]:
        b = rows[i]
        try:
            out[i] = b.decode("utf-8", errors)
        except UnicodeDecodeError:
            out[i] = b
    out[~valid] = None
    return out


def _read(t: torch.Tensor) -> np.ndarray:
    """One buffer of an export on the host: one sync, ``sync.to_numpy``."""
    return obs_spans.host_read(t, "to_numpy").numpy()


def to_numpy(col: Column, row_count) -> np.ndarray:
    """Export the live rows to the host, as ``cylon_tpu/column.py:395
    to_numpy``: nulls become None in an object array, and strings an
    object array of str (bytes where utf-8 decoding fails)."""
    n = int(row_count)
    valid = _read(col.validity[:n])
    if col.is_string:
        rows = _bytes_rows(_read(col.data[:n]), _read(col.lengths[:n]))
        return _decode_rows(rows, valid)
    vals = _read(col.data[:n])
    ndt = col.dtype.numpy_dtype()
    if vals.dtype != ndt and vals.dtype.kind in "iu" \
            and np.dtype(ndt).kind in "iu":
        vals = vals.astype(ndt)  # narrow-mode count buffers widen at export
    if valid.all():
        return vals
    out = vals.astype(object)
    out[~valid] = None
    return out


def to_arrow(col: Column, row_count):
    """Export the live rows to a pyarrow Array, re-ragging byte matrices
    into offsets and bytes (``cylon_tpu/column.py:415``)."""
    import pyarrow as pa

    n = int(row_count)
    valid = col.validity[:n].cpu().numpy()
    mask = None if valid.all() else ~valid
    at = dtypes.to_arrow_type(col.dtype)
    if col.dtype.type in (Type.STRING, Type.BINARY):
        arr = _ragged_arrow(col, n, valid, at)
        if arr is not None:
            return arr
    if col.is_string:
        rows = _bytes_rows(col.data[:n].cpu().numpy(),
                           col.lengths[:n].cpu().numpy())
        if col.dtype.type == Type.STRING:
            vals = _decode_rows(rows, valid, errors="replace")
            vals[~valid] = ""  # a placeholder under the null mask
        else:
            vals = rows
        return pa.array(vals, type=at, mask=mask)
    return pa.array(col.data[:n].cpu().numpy(), type=at, mask=mask)


def _ragged_arrow(col: Column, n: int, valid: np.ndarray, at):
    """A string or binary column's live rows as an Arrow array built from
    buffers (offsets from the lengths, the payload bytes gathered from the
    byte matrix in row order), or None where that array would differ from
    the per-row path's: invalid utf-8 (which that path replaces) or a
    payload past 32-bit offsets."""
    import pyarrow as pa

    mat = col.data[:n].cpu().numpy()
    lens = col.lengths[:n].cpu().numpy().astype(np.int64)
    offsets = np.zeros((n + 1,), np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] >= 2**31:
        return None
    payload = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
    nulls = int(n - valid.sum())
    bitmap = (pa.py_buffer(np.packbits(valid, bitorder="little"))
              if nulls else None)
    arr = pa.Array.from_buffers(
        at, n, [bitmap, pa.py_buffer(offsets.astype(np.int32)),
                pa.py_buffer(np.ascontiguousarray(payload))],
        null_count=nulls)
    try:
        arr.validate(full=True)
    except pa.ArrowInvalid:
        return None
    return arr
