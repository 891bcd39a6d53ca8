"""Index hierarchy for the DataFrame facade.

A copy of ``cylon_tpu/index.py`` (numpy only; reference:
python/pycylon/index.py:22-221 — Index / NumericIndex / IntegerIndex /
RangeIndex / CategoricalIndex / ColumnIndex plus resolution helpers).
Row identity in a sharded table is positional; RangeIndex is the default
and a ColumnIndex records which column plays the index role, with its
values on the host, where labels resolve to positions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Index:
    """Base index (reference: index.py:22-33)."""

    def __init__(self, data=None):
        self._data = data

    def initialize(self) -> None:
        pass

    @property
    def index(self) -> "Index":
        return self

    @property
    def index_values(self):
        return self._data

    def __len__(self) -> int:
        v = self.index_values
        return 0 if v is None else len(v)


class NumericIndex(Index):
    """reference: index.py:36-56."""

    def __init__(self, data):
        super().__init__(np.asarray(data))

    @Index.index_values.getter
    def index_values(self):
        return self._data

    @index_values.setter
    def index_values(self, data):
        self._data = np.asarray(data)


class IntegerIndex(NumericIndex):
    """reference: index.py:59-66."""


class Int64Index(IntegerIndex):
    pass


class RangeIndex(Index):
    """Positional row index (reference: index.py:69-95)."""

    def __init__(self, start: int = 0, stop: int = 0, step: int = 1):
        super().__init__(None)
        if isinstance(start, range):
            rng = start
            start, stop, step = rng.start, rng.stop, rng.step
        self._start, self._stop, self._step = start, stop, step

    @property
    def start(self) -> int:
        return self._start

    @start.setter
    def start(self, v: int) -> None:
        self._start = v

    @property
    def stop(self) -> int:
        return self._stop

    @stop.setter
    def stop(self, v: int) -> None:
        self._stop = v

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, v: int) -> None:
        self._step = v

    @property
    def index_values(self):
        return np.arange(self._start, self._stop, self._step)

    def __len__(self) -> int:
        return len(range(self._start, self._stop, self._step))


class CategoricalIndex(Index):
    """reference: index.py:106-115."""

    def __init__(self, key):
        super().__init__(key)

    @property
    def index_values(self):
        return self._data


class ColumnIndex(Index):
    """A named column acting as the index (reference: index.py:117-124).

    Beyond the reference (whose ``_libs/index.pyx`` loc engine is an empty
    stub), this index carries the column's HOST values so label lookups
    resolve to row positions without touching the device."""

    def __init__(self, key, values=None):
        super().__init__(values)
        self.names = [key] if isinstance(key, str) else list(key)

    @property
    def key(self):
        return self.names[0] if len(self.names) == 1 else self.names

    @property
    def index_values(self):
        return self._data


def range_calculator(index: Index) -> int:
    """reference: index.py resolution helper."""
    return len(index)


def process_index_by_value(key, table) -> Index:
    """set_index routing (reference: table.pyx:1992-2022 ->
    process_index_by_value): an Index passes through; a column name (or
    list of names) becomes a ColumnIndex with that column's host values;
    an array-like of row_count labels becomes a CategoricalIndex."""
    names = list(table.names)
    if isinstance(key, ColumnIndex) and key.index_values is None:
        # a bare ColumnIndex("name") (an older API shape) carries
        # no values; materialize them so loc/take_rows actually work
        if all(n in names for n in key.names):
            key = key.names[0] if len(key.names) == 1 else list(key.names)
        else:
            raise KeyError(f"ColumnIndex names {key.names} not all in table")
    if isinstance(key, Index):
        return key
    if isinstance(key, str) and key in names:
        return ColumnIndex(key, table.project([key]).to_numpy()[key])
    if isinstance(key, (list, tuple, np.ndarray)):
        if len(key) and all(isinstance(k, str) for k in key) and \
                all(k in names for k in key):
            vals = table.project(list(key)).to_numpy()
            return ColumnIndex(list(key), [vals[k] for k in key])
        if len(key) == table.row_count:
            return CategoricalIndex(np.asarray(key, dtype=object))
    raise KeyError(f"cannot build an index from {key!r}")


def as_label_index(key, row_count: int) -> Index:
    """Force the ROW-LABEL interpretation of ``key`` (the DataFrame
    constructor's ``index=``): label values that happen to coincide with
    column names must still become row labels, exactly as pandas does."""
    if isinstance(key, Index):
        return key
    if isinstance(key, (list, tuple, np.ndarray, range)):
        if len(key) != row_count:
            raise KeyError(f"index length {len(key)} != row count {row_count}")
        return CategoricalIndex(np.asarray(key, dtype=object))
    raise KeyError(f"cannot build a label index from {key!r}")


# ---------------------------------------------------------------------------
# label/position resolution (the working analog of the reference's stubbed
# _libs/index.pyx LocIndexr.get_loc)
# ---------------------------------------------------------------------------

def _match_positions(values, label) -> np.ndarray:
    values = np.asarray(values)
    # object arrays compare elementwise in C too — no Python-level scan
    eq = values == label
    if not isinstance(eq, np.ndarray):  # exotic __eq__ returned a scalar
        eq = np.asarray([v == label for v in values])
    pos = np.flatnonzero(eq)
    if pos.size == 0:
        raise KeyError(f"label {label!r} not in index")
    return pos


def loc_positions(index: Index, key, row_count: int) -> np.ndarray:
    """Row positions selected by a pandas-style ``loc`` key over
    ``index``: a scalar label (all matching rows), a list of labels (in
    list order), an inclusive label slice (first occurrence of start to
    LAST occurrence of stop), or a boolean mask."""
    if isinstance(index, RangeIndex):
        return _range_loc(index, key, row_count)
    values = index.index_values
    if isinstance(index, ColumnIndex) and len(index.names) > 1:
        return _multi_loc(values, key, row_count)
    if values is None:
        raise KeyError("index has no values to resolve labels against")
    if isinstance(key, slice):
        if key.step is not None and key.step != 1:
            raise KeyError("label slices do not support a step")
        lo = 0 if key.start is None else int(_match_positions(values, key.start)[0])
        hi = (row_count - 1 if key.stop is None
              else int(_match_positions(values, key.stop)[-1]))
        return np.arange(lo, hi + 1, dtype=np.int64)
    if _is_bool_mask(key):
        return _bool_mask_positions(key, row_count)
    if isinstance(key, (list, tuple, np.ndarray)):
        return np.concatenate([_match_positions(values, k) for k in key]) \
            if len(key) else np.zeros(0, np.int64)
    return _match_positions(values, key)


def _multi_loc(values, key, row_count: int) -> np.ndarray:
    """Multi-column index: a label is a tuple matched across all columns."""
    if _is_bool_mask(key):
        return _bool_mask_positions(key, row_count)
    if isinstance(key, slice):
        raise KeyError("label slices are unsupported on a multi-column index")
    labels = key if isinstance(key, list) else [key]
    out = []
    for label in labels:
        if not isinstance(label, tuple) or len(label) != len(values):
            raise KeyError(f"multi-index label must be a "
                           f"{len(values)}-tuple, got {label!r}")
        mask = np.ones(row_count, bool)
        for col_vals, part in zip(values, label):
            col_vals = np.asarray(col_vals)
            if col_vals.dtype == object:
                mask &= np.asarray([v == part for v in col_vals])
            else:
                mask &= col_vals == part
        pos = np.flatnonzero(mask)
        if pos.size == 0:
            raise KeyError(f"label {label!r} not in index")
        out.append(pos)
    return np.concatenate(out)


def _range_loc(index: RangeIndex, key, row_count: int) -> np.ndarray:
    """RangeIndex labels ARE the range values: position arithmetic."""
    start, step = index.start, index.step

    def pos_of(label) -> int:
        off = label - start
        if step == 0 or off % step or not 0 <= off // step < row_count:
            raise KeyError(f"label {label!r} not in index")
        return off // step

    if isinstance(key, slice):
        if key.step is not None and key.step != 1:
            raise KeyError("label slices do not support a step")
        lo = 0 if key.start is None else pos_of(key.start)
        hi = row_count - 1 if key.stop is None else pos_of(key.stop)
        return np.arange(lo, hi + 1, dtype=np.int64)
    if _is_bool_mask(key):
        return _bool_mask_positions(key, row_count)
    if isinstance(key, (list, tuple, np.ndarray)):
        return np.asarray([pos_of(k) for k in key], np.int64)
    return np.asarray([pos_of(key)], np.int64)


def iloc_positions(key, row_count: int) -> np.ndarray:
    """Row positions for a pandas-style ``iloc`` key: int (negatives
    allowed), slice, int list/array, or boolean mask."""
    if isinstance(key, slice):
        return np.arange(*key.indices(row_count), dtype=np.int64)
    if _is_bool_mask(key):
        try:
            return _bool_mask_positions(key, row_count)
        except KeyError as e:          # iloc's error surface is IndexError
            raise IndexError(str(e))
    if isinstance(key, (list, tuple, np.ndarray)):
        idx = np.asarray(key, np.int64)
    else:
        idx = np.asarray([key], np.int64)
    idx = np.where(idx < 0, idx + row_count, idx)
    if idx.size and (idx.min() < 0 or idx.max() >= row_count):
        raise IndexError(f"position out of bounds for {row_count} rows")
    return idx


def _is_bool_mask(key) -> bool:
    if isinstance(key, np.ndarray) and key.dtype == bool:
        return True
    return (isinstance(key, (list, tuple)) and len(key) > 0
            and all(isinstance(k, (bool, np.bool_)) for k in key))


def _bool_mask_positions(key, row_count: int) -> np.ndarray:
    """Validated mask -> positions: a wrong-length mask must raise (as
    pandas does), never silently select clamped rows downstream."""
    mask = np.asarray(key, bool)
    if mask.shape != (row_count,):
        raise KeyError(f"boolean mask length {mask.shape} != row count "
                       f"{row_count}")
    return np.flatnonzero(mask)
