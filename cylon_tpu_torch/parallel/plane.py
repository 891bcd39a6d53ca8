"""Column-packed single-collective exchange plane, and its compression.

The port of ``cylon_tpu/parallel/plane.py``.  The per-buffer exchange
moves every buffer of every column in a collective of its own (data,
validity and a string's lengths: ``shuffle.buffer_count``); the packed
exchange bit-packs all of them into ONE ``[rows, words]`` plane of 32-bit
words per shard, which travels in one collective and is unpacked on the
receiver.  The field layout is a pure function of the columns' dtypes and
string widths, with the reference's field order, word layout and bits:

- validity        -> 1 bit
- bool data       -> 1 bit
- 8/16-bit data   -> 8/16 bits (the unsigned bit pattern)
- 32-bit data     -> one word (its bits)
- 64-bit data     -> two words, the low word first
- string data     -> ceil(width/4) words (4 bytes big-endian each)
- string lengths  -> one word

Fields take words first-fit-decreasing, MSB-aligned, ties by field index
(``_layout``).  Floats travel as raw bits: NaN payloads and -0.0 survive,
and nothing is folded (the fold of ``keys.canonical_float`` is for hashing
only).

Torch has no uint32 shifts or adds on the CPU, so the plane is ``int32``
on both devices (the same bits, viewed as the reference's ``uint32`` plane
by ``numpy.view``): a field that owns a whole word is its column's bits
viewed as ``int32``, sub-word fields are shifted and OR-ed in ``int32``,
and a right shift (arithmetic) is always followed by its field's mask.
Only the narrow codec computes in ``int64``.

Compression (``CYLON_TPU_SHUFFLE_COMPRESS``, riding the packed plane)
shrinks each field to what its observed values need, exactly:

- integer columns narrow to ``("narrow", offset, bits)``, ``value -
  offset`` in ``bits`` bits, from the min and max over the live rows (null
  rows' raw bits included); one value costs 0 bits;
- string columns truncate to ``("trunc", nbytes, len_bits)``;
- low-cardinality string columns become ``("dict", nbytes, lcap, gcap,
  code_bits)`` codes into one global dictionary (``PlaneCodec``); code 0
  is the all-zero row.

``auto`` leaves both knobs off on CUDA and on the CPU: the reference turns
them on only for TPU-family backends.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import config
from ..column import Column, zero_unless
from ..obs import spans as obs_spans
from ..ops import compact, keys as keys_mod
from . import collectives

_MASK32 = 0xFFFFFFFF
_SIGNED_OF_BITS = {8: torch.int8, 16: torch.int16, 32: torch.int32}

#: per-column spec entry for the uncompressed field layout
RAW: Tuple = ("raw",)

#: dictionary padding key word: the bits of uint64 0xFFFF_FFFF_FFFF_FFFF,
#: which sorts after every real word in unsigned order (no real row has a
#: length of 2^64-1, so it never equals a live key tuple)
_SENT64 = -1

#: largest global dictionary worth gathering
_DICT_GCAP_MAX = 4096


def pack_enabled() -> bool:
    """Whether shuffle exchanges move one packed plane instead of one
    collective per buffer per column.  ``CYLON_TPU_SHUFFLE_PACK`` 1/0
    overrides; ``auto`` packs only on TPU-family backends, so it is off on
    CUDA and on the CPU."""
    mode = config.knob("CYLON_TPU_SHUFFLE_PACK")
    return mode in ("1", "on", "packed")


def compress_enabled() -> bool:
    """Whether packed exchanges may narrow, truncate and dictionary-code
    the plane (``CYLON_TPU_SHUFFLE_COMPRESS``; ``auto`` is off on CUDA and
    on the CPU).  Callers also require ``pack_enabled()``."""
    mode = config.knob("CYLON_TPU_SHUFFLE_COMPRESS")
    return mode in ("1", "on")


def _is_int(dtype: torch.dtype) -> bool:
    return dtype != torch.bool and not dtype.is_floating_point


def _string_word_count(col: Column) -> int:
    return (col.string_width + 3) // 4


def _spec_of(cols: Sequence[Column], spec) -> Tuple[Tuple, ...]:
    return tuple(spec) if spec is not None else (RAW,) * len(cols)


def _field_widths(cols: Sequence[Column], spec=None) -> List[int]:
    """Bit width of every plane field, in column order: the one field
    sequence ``_field_values`` and ``unpack_plane`` walk too."""
    ws: List[int] = []
    for c, enc in zip(cols, _spec_of(cols, spec)):
        ws.append(1)                                  # validity
        if c.is_string:
            if enc[0] == "dict":
                ws.append(enc[4])                     # code field
            elif enc[0] == "trunc":
                ws.extend([32] * ((enc[1] + 3) // 4))  # truncated data
                ws.append(enc[2])                     # narrowed lengths
            else:
                ws.extend([32] * _string_word_count(c))   # data words
                ws.append(32)                             # lengths
        elif c.data.dtype == torch.bool:
            ws.append(1)
        elif enc[0] == "narrow":
            ws.append(enc[2])                         # offset-reduced data
        elif c.data.dtype.itemsize == 8:
            ws.extend([32, 32])
        else:
            ws.append(c.data.dtype.itemsize * 8)
    return ws


def _layout(widths: Sequence[int]) -> Tuple[List[Tuple[int, int, int]], int]:
    """First-fit-decreasing assignment of fields to 32-bit words:
    (slots, num_words), ``slots[i] = (word, shift, bits)``, MSB-aligned in
    each word.  A zero-bit field owns no bits: slot ``(-1, 0, 0)``."""
    order = sorted(range(len(widths)), key=lambda i: (-widths[i], i))
    slots: List[Optional[Tuple[int, int, int]]] = [None] * len(widths)
    word, used = -1, 32
    for i in order:
        w = widths[i]
        if w == 0:
            slots[i] = (-1, 0, 0)
            continue
        if used + w > 32:
            word += 1
            used = 0
        slots[i] = (word, 32 - used - w, w)
        used += w
    return slots, word + 1  # type: ignore[return-value]


def plane_words(cols: Sequence[Column], spec=None) -> int:
    """The plane's word count for this schema (under ``spec``'s encodings
    when given)."""
    return _layout(_field_widths(cols, spec))[1]


# -- bits <-> values ---------------------------------------------------------

def _as_int64(v: int) -> int:
    """A Python int in [-2^63, 2^64) as the int64 with its low 64 bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _word_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 holding the unsigned bit pattern of a 1-, 8-, 16- or 32-bit
    tensor, zero-extended (the reference's ``bitcast`` to unsigned)."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    w = x.dtype.itemsize * 8
    v = x.view(_SIGNED_OF_BITS[w])
    return v if w == 32 else v.to(torch.int32) & ((1 << w) - 1)


def _from_bits(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A tensor of ``dtype`` whose bits are the low bits of the int32 or
    int64 ``v``."""
    if dtype == torch.bool:
        return v != 0
    w = dtype.itemsize * 8
    if w == v.dtype.itemsize * 8:
        return v.view(dtype)
    v = v & ((1 << w) - 1)
    v = v - ((v >> (w - 1)) << w)  # into the signed range of w bits
    return v.to(_SIGNED_OF_BITS[w]).view(dtype)


def _int_value(x: torch.Tensor) -> torch.Tensor:
    """The exact value of an integer tensor of at most 32 bits, or an
    int64's, in int64 (a uint64's bits)."""
    if x.dtype.itemsize == 8:
        return x.view(torch.int64)
    if x.is_signed() or x.dtype == torch.uint8:
        return x.to(torch.int64)
    return _word_bits(x).to(torch.int64) & _MASK32


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 4 bytes of each int32 (right shifts masked)."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def _pack_string_data(data: torch.Tensor) -> List[torch.Tensor]:
    """uint8[n, width] byte matrix -> ceil(width/4) int32[n] words, each
    the big-endian 32-bit word of 4 bytes."""
    n, width = data.shape
    pad = (-width) % 4
    if pad:
        data = torch.cat([data, torch.zeros((n, pad), dtype=torch.uint8,
                                            device=data.device)], dim=1)
    if data.shape[1] == 0:
        return []
    lanes = data.contiguous().view(torch.int32)
    return [_bswap32(lanes[:, i]) for i in range(lanes.shape[1])]


def _unpack_string_data(words: Sequence[torch.Tensor],
                        width: int) -> torch.Tensor:
    """Inverse of ``_pack_string_data``: big-endian int32 words ->
    uint8[n, width]; ``words`` is non-empty."""
    lanes = torch.stack([_bswap32(w) for w in words], dim=1)
    return lanes.view(torch.uint8)[:, :width].contiguous()


def _unpack_string_words64(words: Sequence[torch.Tensor],
                           width: int) -> torch.Tensor:
    """Big-endian 64-bit words (``keys.pack_string_words``' layout) ->
    uint8[n, width]: the decode half of the dictionary."""
    lanes = torch.stack([keys_mod._bswap64(w) for w in words], dim=1)
    return lanes.contiguous().view(torch.uint8)[:, :width].contiguous()


def _narrow_encode(data: torch.Tensor, offset: int, bits: int
                   ) -> torch.Tensor:
    """value -> int32 field: the low 32 bits of ``value - offset``, exact
    for every row inside the observed range; a row outside it (padding,
    never sent) wraps as the reference's does."""
    if bits == 0:
        return torch.zeros(data.shape, dtype=torch.int32, device=data.device)
    return _from_bits(_int_value(data) - _as_int64(offset), torch.int32)


def _narrow_decode(field: torch.Tensor, offset: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """int32 field (its unsigned bits) -> value: ``offset + field`` in 64
    bits, cast back to the column's dtype."""
    u = field.to(torch.int64) & _MASK32
    return _from_bits(u + _as_int64(offset), dtype)


def _field_values(cols: Sequence[Column], spec=None,
                  codes: Optional[Dict[int, torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """int32[n] per field (the order of ``_field_widths``), each holding
    the bits the field carries.  ``codes`` holds the per-row dictionary
    codes of "dict" columns (``PlaneCodec``)."""
    vals: List[torch.Tensor] = []
    for i, (c, enc) in enumerate(zip(cols, _spec_of(cols, spec))):
        vals.append(c.validity.to(torch.int32))
        if c.is_string:
            if enc[0] == "dict":
                vals.append((codes or {})[i].to(torch.int32))
            elif enc[0] == "trunc":
                vals.extend(_pack_string_data(c.data[:, :enc[1]]))
                vals.append(c.lengths)
            else:
                vals.extend(_pack_string_data(c.data))
                vals.append(c.lengths)
        elif c.data.dtype == torch.bool:
            vals.append(c.data.to(torch.int32))
        elif enc[0] == "narrow":
            vals.append(_narrow_encode(c.data, enc[1], enc[2]))
        elif c.data.dtype.itemsize == 8:
            halves = c.data.view(torch.int32).view(-1, 2)  # low word first
            vals.append(halves[:, 0])
            vals.append(halves[:, 1])
        else:
            vals.append(_word_bits(c.data))
    return vals


def pack_plane(cols: Sequence[Column], spec=None,
               codes: Optional[Dict[int, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Bit-pack the columns' buffers into one int32[rows, words] plane;
    bit-exact round trip with ``unpack_plane``.  With ``spec``, the
    compressed fields are laid out instead (dict columns need
    ``codes``)."""
    slots, nwords = _layout(_field_widths(cols, spec))
    n, dev = cols[0].capacity, cols[0].device
    words: List[Optional[torch.Tensor]] = [None] * nwords
    for (word, shift, bits), v in zip(slots, _field_values(cols, spec,
                                                           codes)):
        if bits == 0:
            continue
        sh = v << shift if shift else v
        words[word] = sh if words[word] is None else words[word] | sh
    if nwords == 0:
        return torch.zeros((n, 0), dtype=torch.int32, device=dev)
    return torch.stack(words, dim=1)


def unpack_plane(plane: torch.Tensor, like: Sequence[Column],
                 valid_mask: Optional[torch.Tensor] = None, spec=None,
                 dicts: Optional[Dict[int, Tuple[torch.Tensor, ...]]] = None,
                 tail_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Column, ...]:
    """Decode a plane into Columns of ``like``'s schema.  ``valid_mask``
    ANDs into every validity and zeroes the rows it clears (as
    ``Column.take`` does, so packed and per-buffer results are
    bit-identical).  ``tail_mask`` zeroes the rows past it without touching
    null rows inside it: under a spec, a zero field decodes to the offset
    or to dictionary entry 0, not to zero."""
    slots, nwords = _layout(_field_widths(like, spec))
    if plane.shape[1] != nwords:
        raise ValueError(f"plane of {plane.shape[1]} words for a layout of "
                         f"{nwords}")
    n, dev = plane.shape[0], plane.device
    words = plane.t().contiguous()  # one pass; every word then contiguous
    it = iter(slots)

    def owned(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``x``, copied when it is a view into ``words`` (a full-word
        field no mask rewrote), so no decoded column keeps the whole
        transposed plane alive."""
        if x is not None and (x.untyped_storage().data_ptr()
                              == words.untyped_storage().data_ptr()):
            return x.clone()
        return x

    def field() -> torch.Tensor:
        """The next field's bits, int32 (sub-word fields non-negative)."""
        word, shift, bits = next(it)
        if bits == 0:
            return torch.zeros((n,), dtype=torch.int32, device=dev)
        v = words[word]
        if shift:
            v = v >> shift
        if bits < 32:
            v = v & ((1 << bits) - 1)
        return v

    def widen(mat: torch.Tensor, width: int) -> torch.Tensor:
        if mat.shape[1] == width:
            return mat
        pad = torch.zeros((n, width - mat.shape[1]), dtype=torch.uint8,
                          device=dev)
        return torch.cat([mat, pad], dim=1)

    out: List[Column] = []
    for i, (c, enc) in enumerate(zip(like, _spec_of(like, spec))):
        validity = field() != 0
        lengths = None
        if c.is_string:
            if enc[0] == "dict":
                gws = (dicts or {})[i]
                idx = field().clamp(0, gws[0].shape[0] - 1)
                vals = [w[idx] for w in gws]
                lengths = vals[-1].to(torch.int32)
                nbytes = enc[1]
                mat = (_unpack_string_words64(vals[:-1], nbytes) if nbytes
                       else torch.zeros((n, 0), dtype=torch.uint8,
                                        device=dev))
                data = widen(mat, c.string_width)
            elif enc[0] == "trunc":
                nbytes = enc[1]
                ws = [field() for _ in range((nbytes + 3) // 4)]
                mat = (_unpack_string_data(ws, nbytes) if ws else
                       torch.zeros((n, 0), dtype=torch.uint8, device=dev))
                data = widen(mat, c.string_width)
                lengths = field()
            else:
                ws = [field() for _ in range(_string_word_count(c))]
                data = (_unpack_string_data(ws, c.string_width) if ws else
                        torch.zeros((n, c.string_width), dtype=torch.uint8,
                                    device=dev))
                lengths = field()
        elif c.data.dtype == torch.bool:
            data = field() != 0
        elif enc[0] == "narrow":
            data = _narrow_decode(field(), enc[1], c.data.dtype)
        elif c.data.dtype.itemsize == 8:
            lo = field()
            halves = torch.stack([lo, field()], dim=1)
            data = halves.view(torch.int64).view(-1).view(c.data.dtype)
        else:
            data = _from_bits(field(), c.data.dtype)
        for mask, keep in ((tail_mask, "tail"), (valid_mask, "valid")):
            if mask is None:
                continue
            validity = validity & mask
            rows = mask if keep == "tail" else validity
            data = zero_unless(rows, data)
            if lengths is not None:
                lengths = zero_unless(rows, lengths)
        out.append(Column(owned(data), validity, owned(lengths), c.dtype))
    return tuple(out)


# -- compression spec: observed stats -> field encodings -------------------

def stats_layout(cols: Sequence[Column]) -> Tuple[Optional[str], ...]:
    """Which observation each column needs: "int" (min, max), "str"
    (extent, max length, distinct count) or None (float, bool: raw
    always); the walk ``partition.column_stats`` and ``build_spec``
    share."""
    lay: List[Optional[str]] = []
    for c in cols:
        if c.is_string:
            lay.append("str")
        elif _is_int(c.data.dtype):
            lay.append("int")
        else:
            lay.append(None)
    return tuple(lay)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _round_bits(bits: int) -> int:
    """Field widths round up to multiples of 4 bits."""
    return ((bits + 3) // 4) * 4


def build_spec(cols: Sequence[Column], stats: Sequence, world: int,
               shard_cap: int):
    """Observed per-column stats -> the compression spec, or None when
    nothing compresses.  ``stats`` is the flat sequence of
    ``stats_layout``: (min, max) per "int" column, (byte extent, max
    length, max per-shard distinct count) per "str" column, the same on
    every shard."""
    it = iter(stats)
    spec: List[Tuple] = []
    any_comp = False
    for c, kind in zip(cols, stats_layout(cols)):
        if kind == "int":
            mn, mx = int(next(it)), int(next(it))
            raw_bits = c.data.dtype.itemsize * 8
            if mx < mn:                      # no live rows anywhere
                spec.append(("narrow", 0, 0))
                any_comp = True
                continue
            bits = _round_bits((mx - mn).bit_length())
            if bits <= 32 and bits < raw_bits:
                spec.append(("narrow", mn, bits))
                any_comp = True
            else:
                spec.append(RAW)
        elif kind == "str":
            extent, maxlen, nun = int(next(it)), int(next(it)), int(next(it))
            len_bits = _round_bits(maxlen.bit_length())
            raw_cost = 32 * _string_word_count(c) + 32
            trunc_cost = 32 * ((extent + 3) // 4) + len_bits
            lcap = min(_pow2(max(1, nun)), max(1, int(shard_cap)))
            gcap = 1 + world * lcap
            code_bits = _round_bits(max(1, (gcap - 1).bit_length()))
            if nun > 0 and gcap <= _DICT_GCAP_MAX \
                    and code_bits < min(trunc_cost, raw_cost):
                spec.append(("dict", extent, lcap, gcap, code_bits))
                any_comp = True
            elif trunc_cost < raw_cost:
                spec.append(("trunc", extent, len_bits))
                any_comp = True
            else:
                spec.append(RAW)
        else:
            spec.append(RAW)
    return tuple(spec) if any_comp else None


def estimate_spec(cols: Sequence[Column], world: int, shard_cap: int,
                  count=None):
    """A spec from one shard's buffers, read on the host: for advisory
    readers (the planner's explain annotations).  The exchange takes its
    spec from ``partition.column_stats``, which every shard shares."""
    import numpy as np

    n = cols[0].capacity if cols else 0
    live_n = n if count is None else int(count)
    stats: List[int] = []
    for c, kind in zip(cols, stats_layout(cols)):
        if kind == "int":
            d = c.data[:live_n].cpu().numpy()
            stats.extend([int(d.min()), int(d.max())] if d.size else [0, -1])
        elif kind == "str":
            mat = c.data[:live_n].cpu().numpy()
            lens = c.lengths[:live_n].cpu().numpy()
            if mat.shape[0] == 0:
                stats.extend([0, 0, 1])
                continue
            nz = np.nonzero(mat.any(axis=0))[0]
            extent = int(nz[-1]) + 1 if nz.size else 0
            rows = np.concatenate(
                [mat, lens.astype(np.int64).view(np.uint8).reshape(
                    len(lens), 8)], axis=1)
            nun = len(np.unique(rows, axis=0))
            stats.extend([extent, int(lens.max()), nun])
    return build_spec(cols, stats, world, shard_cap)


# -- the dictionary key: shared by the stats pass and the codec ------------

def string_key_words(c: Column, nbytes: Optional[int] = None
                     ) -> List[torch.Tensor]:
    """THE dictionary key tuple of a string column: its big-endian 64-bit
    data words (truncated to ``nbytes`` when given) and its length, each
    an int64 carrying unsigned bits."""
    data = c.data if nbytes is None else c.data[:, :nbytes]
    kws = keys_mod.pack_string_words(data) if data.shape[1] else []
    return kws + [c.lengths.to(torch.int64)]


def sorted_distinct_flags(kws: Sequence[torch.Tensor]
                          ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """(the key tuple sorted in unsigned order, bool flag on the first row
    of every distinct key); ``flag.sum()`` is the distinct count."""
    n = kws[0].shape[0]
    perm, _ = keys_mod.lexsort_indices([w.view(torch.uint64) for w in kws],
                                       n)
    swv = tuple(w[perm] for w in kws)
    neq = functools.reduce(torch.logical_or,
                           [w[1:] != w[:-1] for w in swv])
    flag = torch.cat([torch.ones(1, dtype=torch.bool, device=neq.device),
                      neq])
    return swv, flag


def _distinct_sorted(kws: Sequence[torch.Tensor], keep: int):
    """(the first ``keep`` distinct keys in order, padded with the
    sentinel, distinct count)."""
    swv, flag = sorted_distinct_flags(kws)
    perm, m = compact.compact_indices(flag)
    sel = perm[:keep]
    ok = torch.arange(keep, device=flag.device) < m
    sent = torch.full((), _SENT64, dtype=torch.int64, device=flag.device)
    return [torch.where(ok, w[sel], sent) for w in swv], m


def _dictionary_codes(gd: Sequence[torch.Tensor],
                      kws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per row, the index of its key in the sorted distinct dictionary
    ``gd``: one stable merged sort of (entries, rows) with entries first,
    where a row's code counts the entries at or before it."""
    gcap, cap, dev = gd[0].shape[0], kws[0].shape[0], kws[0].device
    merged = [torch.cat([g, r]) for g, r in zip(gd, kws)]
    marker = torch.cat([torch.zeros(gcap, dtype=torch.bool, device=dev),
                        torch.ones(cap, dtype=torch.bool, device=dev)])
    perm, _ = keys_mod.lexsort_indices(
        [w.view(torch.uint64) for w in merged] + [marker], gcap + cap)
    marker_s = marker[perm]
    payload = torch.cat([torch.zeros(gcap, dtype=torch.int64, device=dev),
                         torch.arange(cap, dtype=torch.int64, device=dev)])
    dictpos = torch.cumsum((~marker_s).to(torch.int64), 0) - 1
    target = torch.where(marker_s, payload[perm],
                         torch.full((), cap, dtype=torch.int64, device=dev))
    codes = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    codes.index_put_((target,), dictpos)
    return codes[:cap]


class PlaneCodec:
    """pack/unpack of every shard of one exchange under one spec.
    ``spec=None`` is the plain plane.  Dictionary columns cost ONE
    all-gather in all, before any shard packs: every shard's local sorted
    dictionary travels to every shard, and each derives the same global
    dictionary from them, so a sender's codes decode on any receiver.
    ``shards`` are this process's; over a process ``group`` of ``world``
    shards the gather crosses processes, and every shard's block has the
    spec's fixed ``lcap`` rows, so the shapes agree on every process.
    ``codes[s]`` / ``dicts[s]`` are local shard ``s``'s, on its device."""

    def __init__(self, shards: Sequence[Sequence[Column]], spec,
                 devices: Sequence[torch.device], group=None,
                 world: Optional[int] = None):
        self.shards = shards
        self.spec = spec
        self.codes: List[Dict[int, torch.Tensor]] = [{} for _ in shards]
        self.dicts: List[Dict[int, Tuple[torch.Tensor, ...]]] = [
            {} for _ in shards]
        if spec is None:
            return
        dcols = [(i, e) for i, e in enumerate(spec) if e[0] == "dict"]
        if not dcols:
            return
        world = len(shards) if world is None else world
        with obs_spans.span("shuffle.dict_gather", columns=len(dcols)):
            keyed, bufs = [], []
            for cols in shards:
                locs = []
                for i, e in dcols:
                    kws = string_key_words(cols[i], e[1])
                    locs.append((i, kws, _distinct_sorted(kws, e[2])[0]))
                maxk = max(len(loc) for _, _, loc in locs)
                blocks = []
                for _, _, loc in locs:
                    pad = [torch.full_like(loc[0], _SENT64)] * (maxk
                                                                - len(loc))
                    blocks.append(torch.stack(loc + pad, dim=1))
                keyed.append(locs)
                bufs.append(torch.cat(blocks))           # [rows, maxk]
            gathered = collectives.allgather(bufs, devices, group)
        rows = bufs[0].shape[0]
        for s, (locs, g) in enumerate(zip(keyed, gathered)):
            g3 = g.reshape(world, rows, -1)
            off = 0
            for (i, kws, loc), (_, e) in zip(locs, dcols):
                lcap, gcap, k = e[2], e[3], len(loc)
                block = g3[:, off:off + lcap, :k].reshape(world * lcap, k)
                off += lcap
                zero = torch.zeros(1, dtype=torch.int64, device=g.device)
                gl = [torch.cat([zero, block[:, j]]) for j in range(k)]
                gd, _ = _distinct_sorted(gl, gcap)
                self.dicts[s][i] = tuple(gd)
                self.codes[s][i] = _dictionary_codes(gd, kws)

    def pack(self, s: int) -> torch.Tensor:
        """Shard ``s``'s plane."""
        return pack_plane(self.shards[s], self.spec, self.codes[s])

    def unpack(self, plane: torch.Tensor, s: int,
               valid_mask: Optional[torch.Tensor] = None,
               tail_mask: Optional[torch.Tensor] = None
               ) -> Tuple[Column, ...]:
        """Decode a plane received by shard ``s``."""
        return unpack_plane(plane, self.shards[s], valid_mask=valid_mask,
                            spec=self.spec, dicts=self.dicts[s],
                            tail_mask=tail_mask)
