"""DataFrame: the pandas-like facade over Table.

The port of ``cylon_tpu/frame.py`` (reference:
python/pycylon/frame.py:33-961): construction from list/dict/pandas/numpy/
Arrow, ``[]`` get/set, comparison/logical/math dunders, drop/fillna/where/
isnull/notnull/rename/add_prefix/add_suffix — each delegating to the Table
layer — plus the relational verbs (merge/join/groupby/sort_values/
drop_duplicates) that the reference exposes through Table.

Context handling mirrors frame.py:56-61 _initialize_context: one shard on
the card by default, and with ``distributed=True`` an in-process mesh of
one shard per visible CUDA device (``MeshConfig``); a ``ctx`` given by the
caller wins and is used as given, a context over a process group
included.  Over a group every process builds the frame from the same
data and keeps its own shards' rows; every verb is then collective
(call it on every process alike), exports gather every row to every
process, and ``loc`` / ``iloc`` resolve labels against global row
positions (every row gathered first).  pandas and pyarrow are never
imported here: a pandas or Arrow input is recognised only when its
package is already loaded.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .context import CylonContext, MeshConfig
from .index import ColumnIndex, Index, RangeIndex
from .series import Series
from .status import Code, CylonError
from .table import Table

_dist_ctx_cache: Dict[int, CylonContext] = {}


def _resolve_ctx(distributed: bool, ctx: Optional[CylonContext]) -> CylonContext:
    """The caller's ``ctx`` as given (one shard, a mesh, or a process
    group); else one shard on the card, or with ``distributed`` a cached
    in-process mesh of one shard per CUDA device."""
    if ctx is not None:
        return ctx
    if not distributed:
        return CylonContext.Init()
    import torch

    n = torch.cuda.device_count()
    if n not in _dist_ctx_cache:
        _dist_ctx_cache[n] = CylonContext.InitDistributed(MeshConfig())
    return _dist_ctx_cache[n]


class DataFrame:
    """reference: frame.py:33-961."""

    def __init__(self, data=None, index=None, columns: Optional[Sequence[str]] = None,
                 dtype=None, copy: bool = False, distributed: bool = False,
                 ctx: Optional[CylonContext] = None):
        self._index: Index = RangeIndex()
        ctx = _resolve_ctx(distributed, ctx)
        self._table = self._initialize_dataframe(data, columns, dtype, ctx)
        self._index = RangeIndex(0, self._table.row_count)
        if index is not None:
            # constructor index= is ALWAYS row labels (pandas), even when
            # the labels coincide with column names — only set_index
            # prefers the column interpretation
            from .index import as_label_index

            self._table._index = as_label_index(index,
                                                self._table.row_count)
            self._index = self._table.index

    # -- construction (frame.py:63-146) ------------------------------------
    def _initialize_dataframe(self, data, columns, dtype, ctx) -> Table:
        if data is None:
            data = {}
        if isinstance(data, DataFrame):
            t = data._table
            if columns is not None:
                t = t.rename(list(columns))
            return t
        if isinstance(data, Table):
            return data if columns is None else data.rename(list(columns))
        if isinstance(data, dict):
            arrays = {str(k): np.asarray(v) for k, v in data.items()}
            if columns is not None:
                arrays = {str(c): arrays[str(c)] for c in columns}
            return Table.from_pydict(arrays, ctx=ctx)
        if isinstance(data, (list, tuple)):
            # each inner sequence is one column (reference frame.py:77-86)
            names = ([str(i) for i in range(len(data))] if columns is None
                     else [str(c) for c in columns])
            if len(names) != len(data):
                raise CylonError(Code.Invalid, "columns length mismatch")
            return Table.from_pydict(
                {n: np.asarray(c, dtype=dtype) for n, c in zip(names, data)},
                ctx=ctx)
        if isinstance(data, np.ndarray):
            if data.ndim == 1:
                data = data[:, None]
            names = ([str(i) for i in range(data.shape[1])] if columns is None
                     else [str(c) for c in columns])
            return Table.from_pydict(
                {n: np.ascontiguousarray(data[:, i]) for i, n in enumerate(names)},
                ctx=ctx)
        pd = sys.modules.get("pandas")
        if pd is not None:
            if isinstance(data, pd.DataFrame):
                return Table.from_pandas(data, ctx=ctx)
            if isinstance(data, pd.Series):
                name = str(data.name) if data.name is not None else "0"
                return Table.from_pydict({name: data.to_numpy()}, ctx=ctx)
        pa = sys.modules.get("pyarrow")
        if pa is not None and isinstance(data, pa.Table):
            return Table.from_arrow(data, ctx=ctx)
        raise CylonError(Code.Invalid, f"cannot build DataFrame from {type(data)}")

    @staticmethod
    def _wrap(table: Table) -> "DataFrame":
        df = DataFrame.__new__(DataFrame)
        df._table = table
        df._index = RangeIndex(0, table.row_count)
        return df

    # -- identity / metadata (frame.py:45-158) ------------------------------
    @property
    def is_distributed(self) -> bool:
        return self._table.is_distributed()

    def distributed(self) -> "DataFrame":
        """Re-shard onto a mesh of one shard per CUDA device (reference
        frame.py:48-51 turns on distributed mode)."""
        if self.is_distributed:
            return self
        ctx = _resolve_ctx(True, None)
        return DataFrame(self.to_pandas(), distributed=True, ctx=ctx)

    @property
    def context(self) -> CylonContext:
        return self._table.ctx

    @property
    def index(self) -> Index:
        return self._index

    def set_index(self, key, drop: bool = True) -> "DataFrame":
        """Route loc lookups through ``key`` (a column name, list of
        names, Index, or row_count labels).  ``drop`` removes used index
        column(s) from the data and DEFAULTS TO TRUE like pandas — this
        facade mirrors pandas, while Table.set_index keeps the column."""
        self._table.set_index(key)
        self._index = self._table.index
        if drop:
            if isinstance(self._index, ColumnIndex):
                keep = [n for n in self._table.names
                        if n not in self._index.names]
                dropped = self._table.project(keep)
                dropped._index = self._index
                self._table = dropped
        return self

    def reset_index(self) -> "DataFrame":
        self._table.reset_index()
        self._index = self._table.index
        return self

    @property
    def loc(self) -> "_FrameIndexer":
        """Label-based row access (the working analog of the reference's
        stubbed _libs/index.pyx loc engine)."""
        return _FrameIndexer(self, "loc")

    @property
    def iloc(self) -> "_FrameIndexer":
        """Position-based row access."""
        return _FrameIndexer(self, "iloc")

    @property
    def shape(self):
        return (self._table.row_count, self._table.column_count)

    @property
    def columns(self) -> List[str]:
        return self._table.column_names

    def __len__(self) -> int:
        return self._table.row_count

    def __repr__(self) -> str:
        return "DataFrame\n" + repr(self.to_pandas())

    # -- exporters (frame.py:159-177) ---------------------------------------
    def to_pandas(self):
        return self._table.to_pandas()

    def to_numpy(self, order: str = "F", zero_copy_only: bool = True,
                 writable: bool = False) -> np.ndarray:
        d = self._table.to_numpy()
        return np.stack(list(d.values()), axis=1) if d else np.empty((0, 0))

    def to_arrow(self):
        return self._table.to_arrow()

    def to_dict(self) -> Dict:
        return self._table.to_pydict()

    def to_table(self) -> Table:
        return self._table

    def to_csv(self, path, csv_write_options=None) -> None:
        self._table.to_csv(path, csv_write_options)

    def to_parquet(self, path, options=None) -> None:
        self._table.to_parquet(path, options)

    # -- [] get/set (frame.py:179-281) --------------------------------------
    def __getitem__(self, key):
        if isinstance(key, DataFrame):
            return DataFrame._wrap(self._table.filter(key._table))
        if isinstance(key, (str, int, np.integer, list, tuple, slice)):
            return DataFrame._wrap(self._table[key])
        raise CylonError(Code.Invalid, f"bad DataFrame key {key!r}")

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, DataFrame):
            value = value._table
        self._table[key] = value
        self._index = RangeIndex(0, self._table.row_count)

    # -- dunders (frame.py:285-713) -----------------------------------------
    def _delegate(self, other, op):
        if isinstance(other, DataFrame):
            other = other._table
        return DataFrame._wrap(op(self._table, other))

    def __eq__(self, other):  # type: ignore[override]
        return self._delegate(other, lambda t, o: t == o)

    def __ne__(self, other):  # type: ignore[override]
        return self._delegate(other, lambda t, o: t != o)

    def __lt__(self, other):
        return self._delegate(other, lambda t, o: t < o)

    def __gt__(self, other):
        return self._delegate(other, lambda t, o: t > o)

    def __le__(self, other):
        return self._delegate(other, lambda t, o: t <= o)

    def __ge__(self, other):
        return self._delegate(other, lambda t, o: t >= o)

    __hash__ = object.__hash__

    def __or__(self, other):
        return self._delegate(other, lambda t, o: t | o)

    def __and__(self, other):
        return self._delegate(other, lambda t, o: t & o)

    def __invert__(self):
        return DataFrame._wrap(~self._table)

    def __neg__(self):
        return DataFrame._wrap(-self._table)

    def __add__(self, other):
        return self._delegate(other, lambda t, o: t + o)

    def __sub__(self, other):
        return self._delegate(other, lambda t, o: t - o)

    def __mul__(self, other):
        return self._delegate(other, lambda t, o: t * o)

    def __truediv__(self, other):
        return self._delegate(other, lambda t, o: t / o)

    # -- cleaning / selection (frame.py:714-961) -----------------------------
    def drop(self, column_names) -> "DataFrame":
        return DataFrame._wrap(self._table.drop(column_names))

    def fillna(self, fill_value) -> "DataFrame":
        return DataFrame._wrap(self._table.fillna(fill_value))

    def where(self, condition: "DataFrame" = None, other=None) -> "DataFrame":
        if condition is None:
            raise CylonError(Code.Invalid, "where() requires a condition")
        return DataFrame._wrap(self._table.where(condition._table, other))

    def isnull(self) -> "DataFrame":
        return DataFrame._wrap(self._table.isnull())

    isna = isnull

    def notnull(self) -> "DataFrame":
        return DataFrame._wrap(self._table.notnull())

    notna = notnull

    def dropna(self, axis: int = 0, how: str = "any") -> "DataFrame":
        return DataFrame._wrap(self._table.dropna(axis=axis, how=how))

    def isin(self, values) -> "DataFrame":
        return DataFrame._wrap(self._table.isin(values))

    def rename(self, column_names) -> "DataFrame":
        return DataFrame._wrap(self._table.rename(column_names))

    def add_prefix(self, prefix: str) -> "DataFrame":
        return DataFrame._wrap(self._table.add_prefix(prefix))

    def add_suffix(self, suffix: str) -> "DataFrame":
        return DataFrame._wrap(self._table.add_suffix(suffix))

    def applymap(self, fn) -> "DataFrame":
        return DataFrame._wrap(self._table.applymap(fn))

    # -- relational verbs (Table layer pass-throughs) ------------------------
    def merge(self, right: "DataFrame", on=None, left_on=None, right_on=None,
              how: str = "inner", algorithm: str = "sort") -> "DataFrame":
        t = self._table.distributed_join(
            right._table, on=on, left_on=left_on, right_on=right_on, how=how,
            algorithm=algorithm) if self.is_distributed else self._table.join(
            right._table, on=on, left_on=left_on, right_on=right_on, how=how,
            algorithm=algorithm)
        return DataFrame._wrap(t)

    join = merge

    def groupby(self, by, agg: Dict[str, Union[str, Sequence[str]]]) -> "DataFrame":
        return DataFrame._wrap(self._table.groupby(by, agg))

    def sort_values(self, by, ascending: bool = True) -> "DataFrame":
        t = (self._table.distributed_sort(by, ascending=ascending)
             if self.is_distributed else self._table.sort(by, ascending=ascending))
        return DataFrame._wrap(t)

    def drop_duplicates(self, subset=None, keep: str = "first") -> "DataFrame":
        t = (self._table.distributed_unique(subset, keep)
             if self.is_distributed else self._table.unique(subset, keep))
        return DataFrame._wrap(t)

    def __getattr__(self, name: str):
        # column access as attribute, pandas-style
        if name.startswith("_"):
            raise AttributeError(name)
        table = self.__dict__.get("_table")
        if table is not None and name in table.names:
            cols, total = table.project([name])._gathered_columns()
            return Series(name, column=cols[0], row_count=total)
        raise AttributeError(name)


class _FrameIndexer:
    """loc/iloc facade over the Table indexers, re-wrapping as DataFrame
    (``cylon_tpu/frame.py:354``).  A frame of several shards, in one
    process or over a process group, resolves labels and positions
    against its global rows: it gathers every row first
    (``Table._gathered_table``), so the result is one local shard, the
    same on every process."""

    def __init__(self, df: DataFrame, kind: str):
        self._df = df
        self._kind = kind

    def __getitem__(self, key) -> DataFrame:
        t = self._df._table._gathered_table()
        out = t.loc[key] if self._kind == "loc" else t.iloc[key]
        wrapped = DataFrame._wrap(out)
        wrapped._index = out.index
        return wrapped
