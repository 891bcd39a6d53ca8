"""A table of columns split into shards over a mesh.

The port of ``cylon_tpu/table.py:55 Table``.  The reference holds one
global array per buffer, sharded over its mesh, and ``int32[num_shards]``
row counts; this Table holds one tuple of Columns per shard, each on its
shard's device (``ctx.devices[i]``), and one 0-d int32 row count per
shard beside it.  Every shard of a table has the same capacity, and a
string column the same width on every shard.

On a context over a process group (``context.py``) a Table holds only
this process's shards, global ids ``shard_ids``, and every process holds
as many; ``num_shards``, ``row_counts``, ``capacity`` and
``is_distributed`` are global, so a two-process table of one shard each
takes the distributed paths.  The constructors take the same global data
on every process and keep their own chunks; ``to_pandas`` and the other
exports gather across processes (every process sees every row), and the
per-shard writers write only this process's shards.  Capacities taken
from a max over shards (the join's output) are maxed across processes.

Ported, for fixed-width and string columns:

- host boundary and metadata: the constructors ``from_numpy``
  (contiguous chunks, ``_shard_plan``; string columns at one width on
  every shard), ``from_pydict``, ``from_pandas``, ``from_arrow``,
  ``from_list``, ``from_columns``, ``from_csv`` and ``from_parquet``
  (``io/``: parsed on the host, uploaded once per shard; a list of files
  maps file i to shard i); the exports ``to_numpy``, ``to_arrow``,
  ``to_pandas``, ``to_pydict``, ``to_string``, ``print``, ``show``,
  ``to_csv`` and ``to_parquet`` (live rows gathered in shard order, or
  with ``per_shard=True`` one file per shard); ``shape``, ``schema`` and
  the other metadata; ``__setitem__``, ``project``, ``rename``,
  ``add_prefix``, ``add_suffix``, ``drop``, ``applymap``;
- row access over an index (``index.py``): ``set_index``,
  ``reset_index``, ``loc``, ``iloc`` and ``take_rows``, which gathers on
  the table's device and, as in the reference, needs one shard;
- shard-local operators (``_shard_wise`` runs them shard by shard, as
  each MPI rank of the reference runs its own): ``sort``, ``merge``,
  ``select`` with its ``_RowEnv``, ``filter``, ``__getitem__``, ``join``,
  ``union`` / ``intersect`` / ``subtract``, ``unique``, and the
  element-wise surface of ``compute.py`` (comparison, logical and
  arithmetic dunders, ``fillna``, ``where``, ``isnull`` and its aliases,
  ``dropna``, ``isin``);
- scalar aggregates ``sum`` / ``count`` / ``min`` / ``max``, with an
  allreduce over more than one shard;
- joins by sort-merge or hash (``algorithm=``), shard-local ``join`` and
  ``distributed_join`` (shuffle both sides, then ``_local_join``'s exact
  two-pass sizing);
- ``groupby``, hash or pipeline, local on one shard and two-phase over
  more (NUNIQUE by a shuffle of the raw rows);
- distributed operators: ``distributed_sort`` (range partitioning),
  ``distributed_unique`` and the distributed set ops (hash shuffles on
  the keys), and ``shuffle`` and ``hash_partition``.

A one-shard ``join`` or hash ``groupby`` that runs out of device memory
falls back to the chunked out-of-core engine (``exec.py``) on the table's
own device.  ``plan()`` starts a lazy query plan (``plan/``).

A table placed by a hash exchange carries that placement as the
``_partitioning`` attribute, ``("hash", (key-name tuples...), world)``,
which the planner reads to elide shuffles: ``shuffle`` stamps its keys,
the two-phase ``distributed_groupby`` its group keys, and
``distributed_join`` (``_stamp_join_partitioning``) the key names of
whichever sides keep real key values.  Every other operator builds a new
Table without it, so anything that moves rows clears it.  The
reference's adaptive join-capacity cache is not ported.
"""
from __future__ import annotations

import logging
import math
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import column as column_mod
from . import compute, config, dtypes, durable, resilience
from .column import Column
from .config import JoinConfig, JoinType, SortOptions
from .context import CylonContext
from .obs import spans as obs_spans
from .ops import aggregates as agg_mod
from .ops import common as common_mod
from .ops import compact
from .ops import groupby as groupby_mod
from .ops import join as join_mod
from .ops import setops as setops_mod
from .ops import sort as sort_mod
from .ops import unique as unique_mod
from .ops.groupby import AggOp
from .parallel import collectives
from .parallel import ops as par_ops
from .utils import pow2ceil
from .status import Code, CylonError, Status


@dataclass
class Table:
    """shards: per shard, its columns; counts: per shard, its live-row
    count (0-d int32 on the shard's device); names, ctx: metadata."""

    shards: Tuple[Tuple[Column, ...], ...]
    counts: Tuple[torch.Tensor, ...]
    names: Tuple[str, ...]
    ctx: CylonContext

    # -- shape / metadata ---------------------------------------------------
    @property
    def num_shards(self) -> int:
        """The global shard count: this process's shards times the
        processes of the context's group."""
        return len(self.shards) * self.ctx.num_processes()

    @property
    def shard_ids(self) -> List[int]:
        """The global ids of this process's shards."""
        first = self.ctx.GetRank() * len(self.shards)
        return list(range(first, first + len(self.shards)))

    @property
    def shard_capacity(self) -> int:
        return self.shards[0][0].capacity if self.names else 0

    @property
    def row_counts(self) -> np.ndarray:
        """Every shard's live-row count on the host, in global shard order
        (synchronises; over a process group, one all-gather, the
        counterpart of ``cylon_tpu/table.py:1081 _host_row_counts``)."""
        return collectives.process_allgather(self._local_row_counts(),
                                             self.ctx.group)

    def _local_row_counts(self) -> np.ndarray:
        """This process's shards' live-row counts on the host."""
        dev = self.counts[0].device
        return torch.stack([c.to(dev) for c in self.counts]).cpu().numpy()

    @property
    def row_count(self) -> int:
        return int(self.row_counts.sum())

    @property
    def capacity(self) -> int:
        """Rows the table can hold over all its shards."""
        return self.shard_capacity * self.num_shards

    @property
    def column_count(self) -> int:
        return len(self.names)

    @property
    def column_names(self) -> List[str]:
        return list(self.names)

    @property
    def schema(self) -> List[Tuple[str, dtypes.DataType]]:
        return [(n, c.dtype) for n, c in zip(self.names, self.shards[0])]

    @property
    def shape(self) -> Tuple[int, int]:
        """(rows, columns) — reference: python/pycylon/data/table.pyx:981."""
        return (self.row_count, self.column_count)

    @property
    def context(self) -> CylonContext:
        """The owning context — reference: data/table.pyx:207."""
        return self.ctx

    def is_distributed(self) -> bool:
        return self.num_shards > 1

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype}"
                         for n, c in zip(self.names, self.shards[0]))
        return (f"Table[{self.row_count} rows x {len(self.names)} cols | "
                f"shards={self.num_shards} cap={self.shard_capacity}]({cols})")

    def _like(self, shards, counts, names=None) -> "Table":
        """A table of this one's context; ``counts`` may be host ints."""
        counts = tuple(c if isinstance(c, torch.Tensor) else
                       torch.tensor(int(c), dtype=torch.int32, device=dev)
                       for c, dev in zip(counts, self.ctx.devices))
        return Table(tuple(tuple(s) for s in shards), counts,
                     tuple(self.names if names is None else names), self.ctx)

    # -- column references --------------------------------------------------
    def _resolve(self, ref) -> int:
        if isinstance(ref, (int, np.integer)):
            i = int(ref)
            if not 0 <= i < len(self.names):
                raise CylonError(Code.IndexError,
                                 f"column index {i} out of range")
            return i
        try:
            return self.names.index(ref)
        except ValueError:
            raise CylonError(Code.KeyError, f"no column named {ref!r}")

    def _resolve_many(self, refs) -> Tuple[int, ...]:
        if isinstance(refs, (int, np.integer, str)):
            refs = [refs]
        return tuple(self._resolve(r) for r in refs)

    # -- host boundary ------------------------------------------------------
    @staticmethod
    def from_numpy(names: Sequence[str], arrays: Sequence[np.ndarray],
                   ctx: Optional[CylonContext] = None,
                   capacity: Optional[int] = None) -> "Table":
        """Rows split into contiguous chunks of ``ceil(n/world)``, chunk
        ``i`` on shard ``i`` at shard capacity ``max(8, chunk)``, or
        ``capacity // world`` when a total ``capacity`` is given (never
        below the chunk), as ``cylon_tpu/table.py:1640 _shard_plan``.
        Over a process group every process passes the same arrays and
        keeps its own shards' chunks."""
        ctx = ctx or CylonContext.Init()
        arrays = [np.asarray(a) for a in arrays]
        n = len(arrays[0]) if arrays else 0
        for name, a in zip(names, arrays):
            if len(a) != n:
                raise CylonError(Code.Invalid,
                                 f"column {name} length {len(a)} != {n}")
        world = ctx.GetWorldSize()
        chunk, counts, shard_cap = _shard_plan(n, world, capacity)
        counts = [counts[s] for s in ctx.shard_ids]
        return _assemble(
            [[column_mod.from_numpy(a[s * chunk:s * chunk + c],
                                    capacity=shard_cap, device=dev)
              for s, c, dev in zip(ctx.shard_ids, counts, ctx.devices)]
             for a in arrays], counts, names, ctx)

    @staticmethod
    def from_columns(cols: Dict[str, Column], row_count: int,
                     ctx: Optional[CylonContext] = None) -> "Table":
        """One shard of ``cols`` (Columns of one capacity on the context's
        first device) holding ``row_count`` live rows."""
        ctx = ctx or CylonContext.Init()
        return Table((tuple(cols.values()),),
                     (torch.tensor(int(row_count), dtype=torch.int32,
                                   device=ctx.devices[0]),),
                     tuple(cols.keys()), ctx)

    @staticmethod
    def from_pydict(data: Dict[str, Sequence],
                    ctx: Optional[CylonContext] = None,
                    capacity: Optional[int] = None) -> "Table":
        return Table.from_numpy([str(k) for k in data],
                                [np.asarray(v) for v in data.values()], ctx,
                                capacity)

    @staticmethod
    def from_pandas(df, ctx: Optional[CylonContext] = None,
                    capacity: Optional[int] = None) -> "Table":
        """Reads ``df.columns`` and each column's ``to_numpy()``; needs no
        import of pandas."""
        return Table.from_numpy([str(n) for n in df.columns],
                                [df[n].to_numpy() for n in df.columns], ctx,
                                capacity)

    @staticmethod
    def from_arrow(atable, ctx: Optional[CylonContext] = None,
                   capacity: Optional[int] = None) -> "Table":
        return _table_from_arrow(
            {n: atable.column(n) for n in atable.column_names},
            ctx or CylonContext.Init(), capacity)

    @staticmethod
    def from_list(col_names: Sequence[str], data_list: Sequence[Sequence],
                  ctx: Optional[CylonContext] = None) -> "Table":
        """Column-major lists (reference: data/table.pyx:811 from_list)."""
        if len(col_names) != len(data_list):
            raise CylonError(Code.Invalid, f"{len(col_names)} names for "
                             f"{len(data_list)} columns")
        return Table.from_pydict(dict(zip(col_names, data_list)), ctx=ctx)

    @staticmethod
    def from_csv(paths, options=None, ctx: Optional[CylonContext] = None,
                 capacity: Optional[int] = None) -> "Table":
        """Read CSV file(s); a list of paths maps file i -> shard i
        (reference: Table::FromCSV, table.cpp:803-855)."""
        from . import io as io_mod

        return io_mod.read_csv(paths, options, ctx, capacity)

    @staticmethod
    def from_parquet(paths, options=None, ctx: Optional[CylonContext] = None,
                     capacity: Optional[int] = None) -> "Table":
        """reference: Table::FromParquet (table.cpp:1049-1116)."""
        from . import io as io_mod

        return io_mod.read_parquet(paths, options, ctx, capacity)

    def to_csv(self, path, options=None, per_shard: bool = False) -> None:
        """reference: Table::WriteCSV (table.cpp:243-256).  With
        ``per_shard=True``, ``path`` must contain a ``{shard}`` placeholder
        and each shard is written to its own file, with no gather: the
        inverse of the list-of-paths read."""
        from . import io as io_mod

        io_mod.write_csv(self, path, options, per_shard=per_shard)

    def to_parquet(self, path, options=None, per_shard: bool = False) -> None:
        """reference: Table::WriteParquet (table.cpp:1118-1131); per-shard
        mode as in ``to_csv``."""
        from . import io as io_mod

        io_mod.write_parquet(self, path, options, per_shard=per_shard)

    def plan(self):
        """Start a lazy logical plan at this table (``plan/``): a
        multi-op pipeline built this way runs through the rule-based
        optimizer (shuffle elision from tracked partitioning, column
        pruning before plane packing, the fused join -> aggregate shard
        body) instead of one eager exchange per op.  ``execute()`` runs
        it and ``explain()`` shows every decision."""
        from .plan import LogicalPlan

        return LogicalPlan.scan(self)

    # -- exporters ------------------------------------------------------------
    def _addressable_host_shards(self) -> List[Tuple[int, List[Column],
                                                     int]]:
        """This process's shards' live rows as host (CPU) Columns, without
        a gather: ``[(global shard id, columns, live count)]`` in shard
        order (``cylon_tpu/table.py:255``)."""
        return [(s, [_host_column(c, int(n)) for c in cols], int(n))
                for s, cols, n in zip(self.shard_ids, self.shards,
                                      self._local_row_counts())]

    def _gathered_columns(self) -> Tuple[List[Column], int]:
        """The live rows of every shard in global shard order as one
        column set (``cylon_tpu/table.py:222``): a one-shard table's own
        columns, else host Columns.  Over a process group every process
        gets every row: the shards' whole buffers cross in one host
        all-gather per buffer (one shape on every process), then each
        shard's live prefix is kept."""
        if self.num_shards == 1:
            return list(self.shards[0]), int(self._local_row_counts()[0])
        group = self.ctx.group
        if group is None:
            parts = self._addressable_host_shards()
            counts = [p[2] for p in parts]
        else:
            counts = [int(n) for n in self.row_counts]
            cap = self.shard_capacity
        cols = []
        for j, c0 in enumerate(self.shards[0]):
            def cat(buf):
                if group is None:
                    return torch.cat([getattr(p[1][j], buf) for p in parts])
                mine = torch.cat([getattr(s[j], buf).cpu()
                                  for s in self.shards]).numpy()
                whole = torch.from_numpy(
                    collectives.process_allgather(mine, group))
                return torch.cat([whole[s * cap:s * cap + n]
                                  for s, n in enumerate(counts)])

            cols.append(Column(cat("data"), cat("validity"),
                               cat("lengths") if c0.is_string else None,
                               c0.dtype))
        return cols, sum(counts)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Live rows of every shard, in shard order; nulls become None in
        an object array, strings str (``column.to_numpy``)."""
        cols, total = self._gathered_columns()
        return {n: column_mod.to_numpy(c, total)
                for n, c in zip(self.names, cols)}

    def to_arrow(self):
        import pyarrow as pa

        cols, total = self._gathered_columns()
        return pa.table([column_mod.to_arrow(c, total) for c in cols],
                        names=list(self.names))

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_pydict(self) -> Dict[str, list]:
        return self.to_arrow().to_pydict()

    def print(self, limit: int = 20) -> None:
        """CSV-ish row dump (reference: table.cpp Print/PrintToOStream)."""
        print(self.to_string(limit))

    def to_string(self, row_limit: int = 10) -> str:
        """reference: pycylon Table.to_string (data/table.pyx:1602)."""
        d = self.to_pydict()
        names = list(d.keys())
        lines = [",".join(names)]
        for i in range(min(row_limit, self.row_count)):
            lines.append(",".join(str(d[c][i]) for c in names))
        return "\n".join(lines)

    def show(self, row1: int = -1, row2: int = -1, col1: int = -1,
             col2: int = -1) -> None:
        """Print a row/column range; -1 bounds mean "to the end"
        (reference: data/table.pyx:101 show)."""
        if row1 == -1 and col1 == -1:
            self.print()
            return
        t = self
        if col1 != -1:
            hi_c = len(self.names) if col2 == -1 else col2
            t = t.project(list(range(col1, hi_c)))
        lo = max(row1, 0)
        hi = t.row_count if row2 == -1 else min(row2, t.row_count)
        d = t.to_pydict()
        names = list(d.keys())
        print(",".join(names))
        for i in range(lo, hi):
            print(",".join(str(d[c][i]) for c in names))

    def shard_frames(self) -> List[Tuple[int, Dict[str, np.ndarray], int]]:
        """This process's shards' live rows on the host, without a gather:
        ``[(global shard id, {name: host column}, live count)]`` in shard
        order."""
        return [(s, {name: column_mod.to_numpy(c, n)
                     for name, c in zip(self.names, cols)}, n)
                for s, cols, n in self._addressable_host_shards()]

    def clear(self) -> None:
        """Drop all rows (reference: data/table.pyx:130 clear); padding
        rows hold zero, so the buffers are zeroed too."""
        self.shards = tuple(
            tuple(Column(torch.zeros_like(c.data),
                         torch.zeros_like(c.validity),
                         None if c.lengths is None
                         else torch.zeros_like(c.lengths), c.dtype)
                  for c in cols) for cols in self.shards)
        self.counts = tuple(torch.zeros_like(c) for c in self.counts)

    def retain_memory(self, retain: bool) -> None:
        """Parity no-op (reference: data/table.pyx:136 — whether ops free
        their inputs; torch frees tensors by reference count)."""

    def is_retain(self) -> bool:
        return True

    # -- index surface (reference: data/table.pyx:1977-2036) ----------------
    @property
    def index(self):
        from .index import RangeIndex

        idx = getattr(self, "_index", None)
        return idx if idx is not None else RangeIndex(0, self.row_count)

    def set_index(self, key) -> None:
        """Route row lookups through ``key`` (reference: table.pyx:1992-2022
        — an Index object, a column name / list of names, or row_count
        labels).  Unlike the reference's stubbed loc engine
        (_libs/index.pyx get_loc: pass), the resulting index resolves
        ``loc`` lookups, on the host."""
        from .index import process_index_by_value

        self._index = process_index_by_value(key, self)

    def reset_index(self, key=None) -> None:
        from .index import RangeIndex

        self._index = RangeIndex(0, self.row_count)

    @property
    def loc(self) -> "_TableIndexer":
        """Label-based row access over the active index: ``t.loc[label]``,
        ``t.loc[[l1, l2]]``, ``t.loc[lo:hi]`` (inclusive), boolean masks,
        and ``t.loc[rows, cols]`` column selection."""
        return _TableIndexer(self, "loc")

    @property
    def iloc(self) -> "_TableIndexer":
        """Position-based row access: int (negatives ok), slice, int
        list/array, boolean mask, and ``t.iloc[rows, cols]``."""
        return _TableIndexer(self, "iloc")

    def _gathered_table(self) -> "Table":
        """Every row in global shard order as a one-shard table on this
        process's first device, over a local context (collective over a
        process group: every process gets the same rows); the active
        index carries over.  A one-shard table is itself."""
        if self.num_shards == 1:
            return self
        cols, total = self._gathered_columns()
        dev = self.ctx.devices[0]
        cap = max(8, total)
        whole = Table((tuple(Column(
            c.data.to(dev), c.validity.to(dev),
            None if c.lengths is None else c.lengths.to(dev),
            c.dtype).with_capacity(cap) for c in cols),),
            (torch.tensor(total, dtype=torch.int32, device=dev),),
            self.names, CylonContext.Init(dev))
        whole._index = getattr(self, "_index", None)
        return whole

    def take_rows(self, positions) -> "Table":
        """Gather rows by position into a new one-shard table on this
        table's device (the gather behind loc/iloc); the active index's
        labels follow their rows."""
        if self.num_shards != 1:
            raise CylonError(Code.Invalid,
                             "row access requires a local (1-shard) table; "
                             "gather or repartition first")
        from .index import (CategoricalIndex, ColumnIndex, Int64Index,
                            RangeIndex)

        idx = np.asarray(positions, np.int64)
        n = idx.shape[0]
        cap = max(8, n)
        dev = self.counts[0].device
        pad = torch.zeros(cap, dtype=torch.int64)
        pad[:n] = torch.from_numpy(idx)
        valid = compact.live_mask(cap, n, dev)
        pad = pad.to(dev)
        out = self._like([tuple(c.take(pad, valid_mask=valid)
                                for c in self.shards[0])], [n])
        idx_obj = getattr(self, "_index", None)
        if isinstance(idx_obj, CategoricalIndex):
            out._index = CategoricalIndex(
                np.asarray(idx_obj.index_values, object)[idx])
        elif isinstance(idx_obj, ColumnIndex):
            vals = idx_obj.index_values
            if len(idx_obj.names) == 1:
                out._index = ColumnIndex(idx_obj.names[0],
                                         np.asarray(vals)[idx])
            else:
                out._index = ColumnIndex(list(idx_obj.names),
                                         [np.asarray(v)[idx] for v in vals])
        elif idx_obj is None or isinstance(idx_obj, RangeIndex):
            # positional labels survive selection (pandas: iloc[[5,7]]
            # keeps labels 5,7, not a fresh 0..n-1 range)
            labels = (np.asarray(idx_obj.index_values) if idx_obj is not None
                      else np.arange(self.row_count, dtype=np.int64))
            out._index = Int64Index(labels[idx])
        else:  # NumericIndex and friends: gather their labels
            out._index = type(idx_obj)(np.asarray(idx_obj.index_values)[idx])
        return out

    # -- column assignment ----------------------------------------------------
    def __setitem__(self, key: str, value) -> None:
        """Add or replace column ``key`` (``cylon_tpu/table.py:772``):
        ``value`` is a one-column Table of this table's shard layout, a
        Column of a one-shard table's capacity, a host array of
        ``row_count`` values (over a process group, the same global array
        on every process), or a scalar repeated to every row."""
        if not isinstance(key, str):
            raise CylonError(Code.Invalid, "column name must be a string")
        cols = self._column_from_value(value)
        if key in self.names:
            i = self.names.index(key)
            self.shards = tuple(s[:i] + (c,) + s[i + 1:]
                                for s, c in zip(self.shards, cols))
        else:
            self.shards = tuple(s + (c,) for s, c in zip(self.shards, cols))
            self.names = self.names + (key,)

    def _column_from_value(self, value) -> List[Column]:
        """Per shard, the Column ``__setitem__`` stores."""
        cap = self.shard_capacity
        if isinstance(value, Column):
            value = [value]
        elif isinstance(value, Table):
            if len(value.names) != 1:
                raise CylonError(Code.Invalid,
                                 "expected a single-column table")
            value = [s[0] for s in value.shards]
        if isinstance(value, list):
            if len(value) != len(self.shards) or any(
                    c.capacity != cap for c in value):
                raise CylonError(Code.Invalid, "column capacity mismatch")
            return value
        if np.isscalar(value) or isinstance(value, (bool, int, float, str)):
            value = np.full((self.row_count,), value)
        arr = np.asarray(value)
        if arr.shape[0] != self.row_count:
            raise CylonError(Code.Invalid, f"value length {arr.shape[0]} != "
                             f"rows {self.row_count}")
        counts = [int(n) for n in self.row_counts]
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        # over a process group the host value is global: keep our slices
        return [column_mod.from_numpy(arr[offsets[s]:offsets[s] + counts[s]],
                                      capacity=cap, device=dev)
                for s, dev in zip(self.shard_ids, self.ctx.devices)]

    # -- column subsets -----------------------------------------------------
    def project(self, refs) -> "Table":
        """Zero-copy column subset (reference: table.cpp:857-876)."""
        idx = self._resolve_many(refs)
        return self._like([tuple(s[i] for i in idx) for s in self.shards],
                          self.counts, tuple(self.names[i] for i in idx))

    def rename(self, mapping: Union[Dict[str, str], Sequence[str]]
               ) -> "Table":
        if isinstance(mapping, dict):
            names = tuple(mapping.get(n, n) for n in self.names)
        else:
            if len(mapping) != len(self.names):
                raise CylonError(Code.Invalid, "rename length mismatch")
            names = tuple(mapping)
        return self._like(self.shards, self.counts, names)

    def add_prefix(self, prefix: str) -> "Table":
        return self.rename([prefix + n for n in self.names])

    def add_suffix(self, suffix: str) -> "Table":
        return self.rename([n + suffix for n in self.names])

    def drop(self, column_names) -> "Table":
        """Drop columns (reference: table.pyx:1625-1652)."""
        drop_idx = set(self._resolve_many(column_names))
        return self.project([i for i in range(len(self.names))
                             if i not in drop_idx])

    def applymap(self, fn) -> "Table":
        """Apply a vectorized function to every column's data tensor; null
        rows hold zero in the result (``cylon_tpu/table.py:966``)."""
        shards = []
        for cols in self.shards:
            out = []
            for c in cols:
                if c.is_string:
                    raise CylonError(Code.Invalid, "applymap on string column")
                data = fn(c.data)
                out.append(Column(
                    column_mod.zero_unless(c.validity, data), c.validity,
                    None, dtypes.from_numpy_dtype(
                        torch.empty(0, dtype=data.dtype).numpy().dtype)))
            shards.append(tuple(out))
        return self._like(shards, self.counts)

    # -- shard-local row operators ------------------------------------------
    def select(self, predicate) -> "Table":
        """Filter rows with a vectorized predicate over named column
        tensors (reference: table.cpp:491-520 Select with a row lambda;
        here the lambda sees whole columns and returns a bool mask)."""

        def fn(cols, count):
            env = _RowEnv(dict(zip(self.names, cols)))
            cap, dev = cols[0].capacity, cols[0].device
            mask = torch.as_tensor(predicate(env), dtype=torch.bool,
                                   device=dev)
            return _compact_rows(cols, mask & compact.live_mask(cap, count,
                                                                dev))

        return _shard_wise(fn, self)

    def filter(self, mask: "Table") -> "Table":
        """Row filter by a boolean table (pandas ``df[bool_mask]``;
        reference: table.pyx:991-1024)."""
        if len(mask.names) != 1:
            raise CylonError(Code.Invalid, "filter mask must have one column")
        if mask.shards[0][0].dtype.type != dtypes.Type.BOOL:
            raise CylonError(Code.Invalid, "filter mask must be boolean")

        def fn(cols, count, mcols, _):
            mc = mcols[0]
            live = compact.live_mask(cols[0].capacity, count, mc.device)
            return _compact_rows(cols, mc.data & mc.validity & live)

        return _shard_wise(fn, self, mask)

    def merge(self, other: "Table") -> "Table":
        """Row concatenation (reference: table.cpp:278-299 Merge)."""
        _check_schemas(self, other)

        def fn(cols_a, count_a, cols_b, count_b):
            dev = cols_a[0].device
            mask = torch.cat([
                compact.live_mask(cols_a[0].capacity, count_a, dev),
                compact.live_mask(cols_b[0].capacity, count_b, dev)])
            return _compact_rows([common_mod.concat_columns(a, b)
                                  for a, b in zip(cols_a, cols_b)], mask)

        return _shard_wise(fn, self, other)

    def sort(self, by, ascending: Union[bool, Sequence[bool]] = True,
             nulls_first: bool = True) -> "Table":
        """Shard-local sort (reference: local Sort, util::SortTable)."""
        by_idx = self._resolve_many(by)
        asc = (tuple([ascending] * len(by_idx))
               if isinstance(ascending, bool) else tuple(ascending))
        return _shard_wise(lambda cols, n: sort_mod.sort_rows(
            cols, n, by_idx, asc, nulls_first), self)

    def unique(self, columns=None, keep: str = "first") -> "Table":
        """Drop rows whose key repeats, keeping the first or last
        occurrence, in row order (reference: table.cpp:966-1029)."""
        key_idx = (tuple(range(len(self.names))) if columns is None
                   else self._resolve_many(columns))
        return _shard_wise(lambda cols, n: unique_mod.unique(
            cols, n, key_idx, keep), self)

    def join(self, other: "Table", config: Optional[JoinConfig] = None, *,
             on=None, left_on=None, right_on=None, how="inner",
             algorithm="sort") -> "Table":
        """Shard-local join (reference: Table::Join, table.cpp:441-457):
        shard by shard, with no shuffle; ``distributed_join`` shuffles
        first.

        If the one-shot join exceeds device memory (the join OUTPUT can
        dwarf the resident inputs), one-shard tables fall back to the
        chunked out-of-core engine on their own device instead of dying
        (``CYLON_TPU_ONESHOT_FALLBACK=0`` disables), as
        ``cylon_tpu/table.py:555-574``."""
        cfg = _join_config(self, other, config, on, left_on, right_on, how,
                           algorithm)
        try:
            resilience.fault_point("oneshot_join")
            return _local_join(self, other, cfg)
        except Exception as e:
            if not _oneshot_oom_fallback(self, other, e):
                raise
        # outside the handler: the failed attempt's frames (and the device
        # memory they hold) are gone before the chunked engine starts
        from . import exec as exec_mod

        res, _stats = exec_mod.chunked_join(
            self, other, left_on=[self.names[i] for i in cfg.left_on],
            right_on=[other.names[i] for i in cfg.right_on],
            how=_HOW_NAMES[cfg.join_type], algo=cfg.algorithm,
            passes=_fallback_passes(), ctx=self.ctx,
            left_prefix=cfg.left_prefix, right_prefix=cfg.right_prefix)
        return _table_from_fallback(
            res, _join_output_names(self, other, cfg), self.ctx)

    # -- set operators ------------------------------------------------------
    def union(self, other: "Table") -> "Table":
        return _local_set_op(self, other, "union")

    def subtract(self, other: "Table") -> "Table":
        return _local_set_op(self, other, "subtract")

    def intersect(self, other: "Table") -> "Table":
        return _local_set_op(self, other, "intersect")

    def distributed_union(self, other: "Table") -> "Table":
        return _dist_set_op(self, other, "union")

    def distributed_subtract(self, other: "Table") -> "Table":
        return _dist_set_op(self, other, "subtract")

    def distributed_intersect(self, other: "Table") -> "Table":
        return _dist_set_op(self, other, "intersect")

    # -- distributed operators ----------------------------------------------
    def distributed_join(self, other: "Table",
                         config: Optional[JoinConfig] = None, *, on=None,
                         left_on=None, right_on=None, how="inner",
                         algorithm="sort") -> "Table":
        """Global join: shuffle both tables on the key columns, then join
        shard by shard (reference: DistributedJoin, table.cpp:459-489)."""
        cfg = _join_config(self, other, config, on, left_on, right_on, how,
                           algorithm)
        if self.num_shards == 1:
            return _local_join(self, other, cfg)
        out = _local_join(par_ops.shuffle(self, cfg.left_on),
                          par_ops.shuffle(other, cfg.right_on), cfg)
        _stamp_join_partitioning(out, self, other, cfg)
        return out

    def distributed_unique(self, columns=None, keep: str = "first"
                           ) -> "Table":
        """reference: DistributedUnique (table.cpp:1031-1047): shuffle on
        the key columns, then the local unique."""
        if self.num_shards == 1:
            return self.unique(columns, keep)
        key_idx = (tuple(range(len(self.names))) if columns is None
                   else self._resolve_many(columns))
        return par_ops.shuffle(self, key_idx).unique(key_idx, keep)

    def distributed_sort(self, by, options: Optional[SortOptions] = None,
                         ascending: Union[bool, Sequence[bool], None] = None
                         ) -> "Table":
        """reference: DistributedSort (table.cpp:313-356): sampled-
        histogram range partition on the first column, exchange, local
        sort.  ``ascending`` overrides ``options.ascending`` per column."""
        opts = options or SortOptions()
        by_idx = self._resolve_many(by)
        if ascending is None:
            asc = tuple([opts.ascending] * len(by_idx))
        elif isinstance(ascending, bool):
            asc = tuple([ascending] * len(by_idx))
        else:
            asc = tuple(bool(a) for a in ascending)
            if len(asc) != len(by_idx):
                raise CylonError(Code.Invalid, "ascending length mismatch")
        if asc[0] != opts.ascending:
            opts = SortOptions(ascending=asc[0], num_bins=opts.num_bins,
                               num_samples=opts.num_samples,
                               nulls_first=opts.nulls_first)
        if self.num_shards == 1:
            return self.sort(by, ascending=asc, nulls_first=opts.nulls_first)
        return par_ops.distributed_sort(self, by_idx, opts, asc)

    def groupby(self, by, agg: Dict, ddof: int = 0,
                groupby_type: str = "hash") -> "Table":
        """Group-by, local on one shard, else two-phase distributed
        (``par_ops.distributed_groupby``: partial aggregate, shuffle on
        the keys, combine).  ``groupby_type="hash"``: the sort-based
        group-by (reference: groupby/groupby.cpp:23-73).
        ``groupby_type="pipeline"``: the boundary-scan group-by over
        key-grouped rows (the caller guarantees each shard's runs of a key
        are contiguous, as the reference does; groupby.cpp:75-114).  A
        one-shard hash group-by that exceeds device memory falls back to
        ``exec.chunked_groupby`` as ``join`` does; a pipeline group-by
        never does."""
        if groupby_type not in ("hash", "pipeline"):
            raise CylonError(Code.Invalid,
                             f"bad groupby_type {groupby_type!r}")
        by_idx = self._resolve_many(by)
        aggs: List[Tuple[int, AggOp]] = []
        for ref, ops in agg.items():
            ci = self._resolve(ref)
            for op in ([ops] if isinstance(ops, (str, AggOp)) else ops):
                aggs.append((ci, AggOp.of(op)))
        pipeline = groupby_type == "pipeline"
        if self.num_shards != 1:
            return par_ops.distributed_groupby(self, by_idx, tuple(aggs),
                                               ddof, pipeline)
        try:
            resilience.fault_point("oneshot_groupby")
            return _local_groupby(self, by_idx, tuple(aggs), ddof, pipeline)
        except Exception as e:
            # the chunked engine is hash-based: substituting it for a
            # pipeline (run-length) group-by would silently merge
            # non-adjacent key runs, so pipeline never falls back
            if pipeline or not _oneshot_oom_fallback(self, None, e):
                raise
        from . import exec as exec_mod

        agg_by_name: Dict[str, list] = {}
        for ci, op in aggs:
            agg_by_name.setdefault(self.names[ci], []).append(op)
        res, _stats = exec_mod.chunked_groupby(
            self, [self.names[i] for i in by_idx], agg_by_name, ddof=ddof,
            passes=_fallback_passes(), ctx=self.ctx)
        return _table_from_fallback(
            res, _groupby_output_names(self, by_idx, tuple(aggs)), self.ctx)

    def shuffle(self, refs) -> "Table":
        """Hash-repartition rows over the mesh (reference: Shuffle,
        table.cpp:951-964)."""
        if self.num_shards == 1:
            return self
        return par_ops.shuffle(self, self._resolve_many(refs))

    def hash_partition(self, refs, num_partitions: int) -> Dict[int, "Table"]:
        """Split into ``num_partitions`` tables by key hash, shard-locally
        (reference: HashPartition, table.cpp:358-375)."""
        if num_partitions < 1:
            raise CylonError(Code.Invalid, "num_partitions must be >= 1, got "
                             f"{num_partitions}")
        return par_ops.hash_partition(self, self._resolve_many(refs),
                                      num_partitions)

    # -- scalar aggregates --------------------------------------------------
    def sum(self, ref):
        return self._scalar_agg(ref, agg_mod.ReduceOp.SUM)

    def count(self, ref):
        return self._scalar_agg(ref, agg_mod.ReduceOp.COUNT)

    def min(self, ref):
        return self._scalar_agg(ref, agg_mod.ReduceOp.MIN)

    def max(self, ref):
        return self._scalar_agg(ref, agg_mod.ReduceOp.MAX)

    def _scalar_agg(self, ref, op: agg_mod.ReduceOp) -> torch.Tensor:
        """reference: compute::Sum/Count/Min/Max (compute/aggregates.cpp:
        30-156): a local reduce, then an allreduce over the shards.
        Returns a 0-d tensor on shard 0's device."""
        ci = self._resolve(ref)
        if self.num_shards == 1:
            return agg_mod.scalar_agg(self.shards[0][ci], self.counts[0],
                                      op)[0]
        return par_ops.distributed_scalar_agg(self, ci, op)

    # -- element-wise surface (pycylon table.pyx:1170-2146) -----------------
    def __getitem__(self, key):
        if isinstance(key, (str, int, np.integer)):
            return self.project([key])
        if isinstance(key, (list, tuple)):
            return self.project(list(key))
        if isinstance(key, Table):
            return self.filter(key)
        if isinstance(key, slice):
            return self._row_slice(key)
        raise CylonError(Code.Invalid, f"bad Table key {key!r}")

    def _row_slice(self, sl: slice) -> "Table":
        if self.num_shards != 1:
            raise CylonError(Code.Invalid,
                             "row slicing requires a local (1-shard) table")
        start, stop, step = sl.indices(self.row_count)
        dev = self.counts[0].device
        idx = torch.arange(start, stop, step, dtype=torch.int32, device=dev)
        n = idx.shape[0]
        cap = max(8, n)
        idx = torch.cat([idx, torch.zeros(cap - n, dtype=torch.int32,
                                          device=dev)])
        valid = compact.live_mask(cap, n, dev)
        return self._like([tuple(c.take(idx, valid_mask=valid)
                                 for c in self.shards[0])], [n])

    def __eq__(self, other):  # type: ignore[override]
        return compute.compare(self, other, "eq")

    def __ne__(self, other):  # type: ignore[override]
        return compute.compare(self, other, "ne")

    def __lt__(self, other):
        return compute.compare(self, other, "lt")

    def __gt__(self, other):
        return compute.compare(self, other, "gt")

    def __le__(self, other):
        return compute.compare(self, other, "le")

    def __ge__(self, other):
        return compute.compare(self, other, "ge")

    __hash__ = object.__hash__

    def __or__(self, other):
        return compute.logical_op(self, other, "or")

    def __and__(self, other):
        return compute.logical_op(self, other, "and")

    def __invert__(self):
        return compute.invert(self)

    def __neg__(self):
        return compute.neg(self)

    def __add__(self, other):
        return compute.add(self, other)

    def __sub__(self, other):
        return compute.subtract(self, other)

    def __mul__(self, other):
        return compute.multiply(self, other)

    def __truediv__(self, other):
        return compute.divide(self, other)

    def fillna(self, fill_value) -> "Table":
        return compute.fillna(self, fill_value)

    def where(self, condition, other=None) -> "Table":
        return compute.where(self, condition, other)

    def isnull(self) -> "Table":
        return compute.is_null(self)

    isna = isnull

    def notnull(self) -> "Table":
        return compute.invert(compute.is_null(self))

    notna = notnull

    def dropna(self, axis: int = 0, how: str = "any") -> "Table":
        return compute.drop_na(self, how=how, axis=axis)

    def isin(self, values, skip_null: bool = True) -> "Table":
        return compute.is_in(self, values, skip_null)


class _RowEnv:
    """Column namespace handed to ``select`` predicates: ``env["x"]`` and
    ``env.x`` are a column's data, ``env.validity("x")`` its validity."""

    def __init__(self, cols: Dict[str, Column]):
        self._cols = cols

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._cols[name].data

    def __getattr__(self, name: str) -> torch.Tensor:
        if name.startswith("_"):
            raise AttributeError(name)
        return self._cols[name].data

    def validity(self, name: str) -> torch.Tensor:
        return self._cols[name].validity


class _TableIndexer:
    """loc/iloc row access, one implementation parameterized by kind
    (``cylon_tpu/table.py:1091``; loc: the working analog of the
    reference's stubbed _libs/index.pyx LocIndexr.get_loc; iloc: pandas
    positional semantics).  Positions resolve on the host; the rows are
    gathered on the table's device."""

    def __init__(self, table: Table, kind: str):
        self._t = table
        self._kind = kind

    def __getitem__(self, key) -> Table:
        from .index import iloc_positions, loc_positions

        key, cols = _split_row_col_key(key, self._t.names,
                                       split_always=self._kind == "iloc")
        try:
            if self._kind == "loc":
                pos = loc_positions(self._t.index, key, self._t.row_count)
            else:
                pos = iloc_positions(key, self._t.row_count)
        except KeyError as e:
            raise CylonError(Code.KeyError, str(e))
        except IndexError as e:
            raise CylonError(Code.IndexError, str(e))
        out = self._t.take_rows(pos)
        if cols is not None:
            sub = out.project(cols)
            sub._index = out._index  # project builds a fresh Table
            out = sub
        return out


def _split_row_col_key(key, names, split_always: bool = False):
    """``indexer[rows, cols]`` support (``cylon_tpu/table.py:1122``): a
    2-tuple whose second element selects columns.  For iloc
    (``split_always``) a 2-tuple is ALWAYS (rows, cols) — iloc has no tuple
    labels, and pandas' ``iloc[0, 1]`` means cell access, never rows
    (0, 1).  For loc a tuple is also how multi-index labels spell, so the
    second element only counts as a column selection when it names table
    columns (or is a positional int with non-scalar rows)."""
    if isinstance(key, tuple) and len(key) == 2:
        rows, cols = key
        if split_always:
            if isinstance(cols, (int, np.integer, str)):
                return rows, [cols if isinstance(cols, str) else int(cols)]
            if isinstance(cols, slice):
                return rows, list(names[cols])
            return rows, cols  # lists pass through; project() validates
        if isinstance(cols, str) and cols in names:
            return rows, [cols]
        if isinstance(cols, list) and cols and \
                all(isinstance(c, str) and c in names for c in cols):
            return rows, cols
        if isinstance(cols, (int, np.integer)) and \
                not isinstance(rows, (int, np.integer, str)):
            return rows, [int(cols)]
    return key, None


# ---------------------------------------------------------------------------
# internals
# ---------------------------------------------------------------------------

_HOW_NAMES = {JoinType.INNER: "inner", JoinType.LEFT: "left",
              JoinType.RIGHT: "right", JoinType.FULL_OUTER: "outer"}


def _oneshot_oom_fallback(left: Table, right: Optional[Table],
                          exc: Exception) -> bool:
    """True when a failed one-shot device op should fall back to the
    chunked out-of-core engine: the failure classifies as OutOfMemory (a
    CUDA allocator failure, or an injected one), every involved table is
    one shard (a mesh's recovery is its own), and the knob
    (``CYLON_TPU_ONESHOT_FALLBACK``, default on) allows it
    (``cylon_tpu/table.py:1249``)."""
    if Status.from_exception(exc).code != Code.OutOfMemory:
        return False
    if not config.knob("CYLON_TPU_ONESHOT_FALLBACK"):
        return False
    if left.num_shards != 1 or (right is not None and right.num_shards != 1):
        return False
    # the fallback run rides the chunked engine, so with a durable dir set
    # it is journaled and crash-resumable — record which, so a trace shows
    # whether a later kill would lose the recovery work
    journaled = durable.enabled()
    obs_spans.instant("table.oneshot_fallback", durable=journaled)
    logging.getLogger(__name__).warning(
        "one-shot device program exceeded memory (%s); falling back to the "
        "chunked out-of-core engine%s", type(exc).__name__,
        " (journaled: CYLON_TPU_DURABLE_DIR set)" if journaled else "")
    # the failed attempt's tensors live on in the traceback's frames
    traceback.clear_frames(exc.__traceback__)
    return True


def _fallback_passes() -> int:
    """Initial pass count for the one-shot -> chunked fallback
    (``CYLON_TPU_FALLBACK_PASSES``, default 4, at least 2); the chunked
    engine's own OOM refinement splits further if that is too coarse."""
    return max(2, int(config.knob("CYLON_TPU_FALLBACK_PASSES")))


def _table_from_fallback(res: Dict[str, np.ndarray], expected,
                         ctx: CylonContext) -> Table:
    """Host-column dict from the chunked engine -> a Table on ``ctx``,
    reordered to the one-shot op's output schema when the names agree."""
    if set(res) == set(expected):
        res = {n: res[n] for n in expected}
    return Table.from_numpy(list(res), list(res.values()), ctx=ctx)


def _shard_wise(fn, *tables: Table) -> Table:
    """Run a per-shard operator on every shard in turn: ``fn`` takes each
    table's (columns, count) of one shard and returns (columns, count);
    the result keeps the first table's names.  The counterpart of the
    reference's ``_shard_wise`` (one ``shard_map`` program over the
    mesh)."""
    t0 = tables[0]
    for t in tables[1:]:
        if t.num_shards != t0.num_shards:
            raise CylonError(Code.Invalid, "tables have different shard "
                             f"counts: {t0.num_shards} vs {t.num_shards}")
    shards, counts = [], []
    for s in range(len(t0.shards)):
        args = []
        for t in tables:
            args += [t.shards[s], t.counts[s]]
        cols, n = fn(*args)
        shards.append(cols)
        counts.append(torch.as_tensor(n).to(torch.int32))
    return t0._like(shards, counts)


def _compact_rows(cols: Sequence[Column], mask: torch.Tensor):
    """The rows where ``mask`` holds, front-packed in order, at the
    columns' capacity; (columns, count)."""
    perm, m = compact.compact_indices(mask)
    valid = compact.live_mask(mask.shape[0], m, mask.device)
    return tuple(c.take(perm, valid_mask=valid) for c in cols), m


def _check_schemas(a: Table, b: Table) -> None:
    if len(a.names) != len(b.names):
        raise CylonError(Code.Invalid, "column count mismatch")
    for na, ca, nb, cb in zip(a.names, a.shards[0], b.names, b.shards[0]):
        if ca.dtype.type != cb.dtype.type:
            raise CylonError(Code.Invalid, f"schema mismatch: {na}:"
                             f"{ca.dtype} vs {nb}:{cb.dtype}")


def _local_set_op(a: Table, b: Table, op: str) -> Table:
    """Shard-by-shard set op at capacity ``pow2ceil(cap_a + cap_b)``."""
    _check_schemas(a, b)
    out_cap = pow2ceil(a.shard_capacity + b.shard_capacity)
    return _shard_wise(lambda ca, na, cb, nb: setops_mod.set_op(
        ca, na, cb, nb, op, out_cap), a, b)


def _dist_set_op(a: Table, b: Table, op: str) -> Table:
    """reference: DoDistributedSetOperation (table.cpp:740-801): shuffle
    both tables on all columns, then the local set op."""
    if a.num_shards == 1:
        return _local_set_op(a, b, op)
    _check_schemas(a, b)
    all_cols = tuple(range(len(a.names)))
    return _local_set_op(par_ops.shuffle(a, all_cols),
                         par_ops.shuffle(b, all_cols), op)


def _assemble(per_column: Sequence[Sequence[Column]], counts, names,
              ctx: CylonContext) -> Table:
    """A Table from, per column, this process's per-shard Columns (local
    shard ``i`` on ``ctx.devices[i]``) and their live counts; a string
    column at the width of its widest shard (of every process) on every
    shard."""
    cols = []
    for shard_cols in per_column:
        width = max(c.string_width for c in shard_cols)
        if ctx.group is not None and shard_cols[0].is_string:
            width = int(collectives.process_allgather(
                np.array([width], np.int64), ctx.group).max())
        cols.append([common_mod.pad_width(c, width) for c in shard_cols])
    shards = [tuple(c[s] for c in cols) for s in range(len(counts))]
    counts_t = tuple(torch.tensor(int(c), dtype=torch.int32, device=dev)
                     for c, dev in zip(counts, ctx.devices))
    return Table(tuple(shards), counts_t, tuple(names), ctx)


def _host_column(c: Column, n: int) -> Column:
    """The first ``n`` rows of ``c`` on the host."""
    return Column(c.data[:n].cpu(), c.validity[:n].cpu(),
                  None if c.lengths is None else c.lengths[:n].cpu(), c.dtype)


def _shard_plan(n: int, world: int, capacity: Optional[int] = None):
    """Contiguous chunks of ``ceil(n/world)`` rows at shard capacity
    ``max(8, chunk)``, or ``capacity // world`` when a total ``capacity``
    is given (never below the chunk), as ``cylon_tpu/table.py:1640``."""
    chunk = math.ceil(n / world) if n else 0
    counts = [max(0, min(chunk, n - s * chunk)) for s in range(world)]
    shard_cap = max(8, chunk)
    if capacity:
        shard_cap = max(int(capacity) // world, chunk)
    return chunk, counts, shard_cap


def _per_shard_capacity(counts, world: int, capacity: Optional[int]) -> int:
    """Shard capacity of a read that maps file i to shard i
    (``cylon_tpu/table.py:1505``): ``capacity // world``, which must hold
    the largest file, else ``max(8, largest)``."""
    shard_cap = capacity // world if capacity else max(8, max(counts))
    if shard_cap < max(counts):
        big = counts.index(max(counts))
        raise CylonError(
            Code.Invalid,
            f"capacity {capacity} gives {shard_cap} rows per shard but file "
            f"{big} has {counts[big]} rows")
    return shard_cap


def _table_from_arrow(arrays: Dict[str, object], ctx: CylonContext,
                      capacity: Optional[int],
                      string_width: Optional[int] = None) -> Table:
    """A Table of pyarrow (Chunked)Arrays split into contiguous chunks, one
    per shard (``cylon_tpu/table.py:1430``)."""
    import pyarrow as pa

    sw = string_width or column_mod.DEFAULT_STRING_WIDTH
    vals = [a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a
            for a in arrays.values()]
    n = len(vals[0]) if vals else 0
    chunk, counts, shard_cap = _shard_plan(n, ctx.GetWorldSize(), capacity)
    counts = [counts[s] for s in ctx.shard_ids]
    return _assemble(
        [[column_mod.from_arrow(a.slice(s * chunk, c), capacity=shard_cap,
                                string_width=sw, device=dev)
          for s, c, dev in zip(ctx.shard_ids, counts, ctx.devices)]
         for a in vals], counts, arrays.keys(), ctx)


def _table_from_arrow_tables(atables, ctx: CylonContext,
                             capacity: Optional[int], *, per_shard: bool,
                             string_width: Optional[int] = None) -> Table:
    """Build a Table from host Arrow tables (``cylon_tpu/table.py:1461``).

    per_shard=True: table i becomes shard i (the reference's
    one-file-per-rank FromCSV semantics, table.cpp:810-855); requires
    ``len(atables) == world``.  per_shard=False: the tables' rows,
    concatenated, are split contiguously across shards.
    """
    import pyarrow as pa

    sw = string_width or column_mod.DEFAULT_STRING_WIDTH
    if not atables:
        raise CylonError(Code.Invalid, "no input files")
    names = tuple(atables[0].column_names)
    schema0 = atables[0].schema
    for i, at in enumerate(atables[1:], 1):
        if tuple(at.column_names) != names:
            raise CylonError(Code.Invalid,
                             f"schema mismatch across files: {at.column_names} "
                             f"vs {list(names)}")
        if at.schema != schema0:
            # unify inferred types (int64 in one file, double in another)
            # rather than corrupting buffers downstream
            try:
                unified = pa.unify_schemas([schema0, at.schema],
                                           promote_options="permissive")
                atables = [t.cast(unified) for t in atables]
                schema0 = unified
            except Exception as e:
                raise CylonError(
                    Code.Invalid,
                    f"column type mismatch between file 0 and file {i}: "
                    f"{schema0} vs {at.schema}") from e
    world = ctx.GetWorldSize()
    if not per_shard or world == 1:
        combined = pa.concat_tables(atables) if len(atables) > 1 else atables[0]
        return _table_from_arrow({n: combined.column(n) for n in names}, ctx,
                                 capacity, string_width=sw)
    if len(atables) != world:
        raise CylonError(Code.Invalid,
                         f"{len(atables)} files for a {world}-shard mesh; "
                         "per-shard reads need one file per mesh position")
    counts = [at.num_rows for at in atables]
    shard_cap = _per_shard_capacity(counts, world, capacity)
    mine = [atables[s] for s in ctx.shard_ids]
    return _assemble(
        [[column_mod.from_arrow(at.column(name), capacity=shard_cap,
                                string_width=sw, device=dev)
          for at, dev in zip(mine, ctx.devices)] for name in names],
        [at.num_rows for at in mine], names, ctx)


def _table_from_native_tables(ntables, ctx: CylonContext,
                              capacity: Optional[int], *, per_shard: bool,
                              string_width: Optional[int] = None) -> Table:
    """Build a Table from the native CSV reader's ``(names, cols)``
    outputs, each col a dict of ``data`` / ``validity`` / optional
    ``lengths`` numpy buffers (``cylon_tpu/table.py:1526``): the mirror of
    ``_table_from_arrow_tables``."""
    if not ntables:
        raise CylonError(Code.Invalid, "no input files")
    names = tuple(ntables[0][0])
    ncols = len(names)
    for nm, _ in ntables[1:]:
        if tuple(nm) != names:
            raise CylonError(Code.Invalid,
                             f"schema mismatch across files: {nm} vs "
                             f"{list(names)}")
    # unify numeric dtypes across files (int64 in one, float64 in another)
    for c in range(ncols):
        kinds = {nt[1][c]["data"].dtype.kind if nt[1][c]["data"].ndim == 1
                 else "S" for nt in ntables}
        if "S" in kinds and kinds != {"S"}:
            raise CylonError(Code.Invalid,
                             f"column {names[c]} is string in some files, "
                             "numeric in others")
        if "f" in kinds and "i" in kinds:
            for nt in ntables:
                nt[1][c]["data"] = nt[1][c]["data"].astype(np.float64)
    world = ctx.GetWorldSize()

    def build(col, lo, hi, cap, dev):
        lengths = col.get("lengths")
        return column_mod.from_native_buffers(
            col["data"][lo:hi], col["validity"][lo:hi],
            None if lengths is None else lengths[lo:hi], capacity=cap,
            string_width=string_width, device=dev)

    if per_shard and world > 1:
        if len(ntables) != world:
            raise CylonError(Code.Invalid,
                             f"{len(ntables)} files for a {world}-shard "
                             "mesh; per-shard reads need one file per mesh "
                             "position")
        counts = [len(nt[1][0]["data"]) if nt[1] else 0 for nt in ntables]
        shard_cap = _per_shard_capacity(counts, world, capacity)
        mine = [(ntables[s], counts[s]) for s in ctx.shard_ids]
        return _assemble(
            [[build(nt[1][c], 0, n, shard_cap, dev)
              for (nt, n), dev in zip(mine, ctx.devices)]
             for c in range(ncols)], [n for _, n in mine], names, ctx)
    if len(ntables) == 1:
        cols = ntables[0][1]
    else:
        cols = [_concat_native([nt[1][c] for nt in ntables])
                for c in range(ncols)]
    n = len(cols[0]["data"]) if cols else 0
    chunk, counts, shard_cap = _shard_plan(n, world, capacity)
    counts = [counts[s] for s in ctx.shard_ids]
    return _assemble(
        [[build(col, s * chunk, s * chunk + c, shard_cap, dev)
          for s, c, dev in zip(ctx.shard_ids, counts, ctx.devices)]
         for col in cols], counts, names, ctx)


def _concat_native(parts: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """One native column from several files' parts, string matrices
    padded to the widest."""
    merged: Dict[str, np.ndarray] = {}
    if parts[0]["data"].ndim == 2:
        w = max(p["data"].shape[1] for p in parts)
        merged["data"] = np.concatenate(
            [np.pad(p["data"], ((0, 0), (0, w - p["data"].shape[1])))
             for p in parts])
        merged["lengths"] = np.concatenate([p["lengths"] for p in parts])
    else:
        merged["data"] = np.concatenate([p["data"] for p in parts])
    merged["validity"] = np.concatenate([p["validity"] for p in parts])
    return merged


def cap_round(n: int) -> int:
    """Round a row count up to a 3-bit-mantissa capacity (at most 8 sizes
    per octave; ``cylon_tpu/table.py:1238 _cap_round``)."""
    if n <= 16:
        return 16
    g = 1 << ((n - 1).bit_length() - 3)
    return -(-n // g) * g


def _join_config(left: Table, right: Table, config, on, left_on, right_on,
                 how, algorithm) -> JoinConfig:
    if config is None:
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise CylonError(Code.Invalid,
                             "join requires on= or left_on=/right_on=")
        config = JoinConfig.of(how, algorithm, left_on, right_on)
    cfg = JoinConfig(config.join_type, config.algorithm,
                     left._resolve_many(config.left_on),
                     right._resolve_many(config.right_on),
                     config.left_prefix, config.right_prefix)
    return _check_join_keys(left, right, cfg)


def _check_join_keys(left: Table, right: Table,
                     cfg: JoinConfig) -> JoinConfig:
    """``cfg`` (key positions resolved) when its key columns can join
    (``cylon_tpu/table.py:1181``); `Code.Invalid` otherwise."""
    if len(cfg.left_on) != len(cfg.right_on):
        raise CylonError(Code.Invalid, "left_on/right_on length mismatch")
    for li, ri in zip(cfg.left_on, cfg.right_on):
        lt, rt = left.shards[0][li].dtype, right.shards[0][ri].dtype
        # string keys need only agree on being strings (widths are padded
        # to one); other keys must match exactly unless a side is empty
        kind = dtypes.join_key_mismatch(
            dtypes.is_string_like(lt), dtypes.is_string_like(rt), lt == rt,
            lt != rt and (left.row_count == 0 or right.row_count == 0))
        if kind is not None:
            raise CylonError(Code.Invalid,
                             f"join key type mismatch: {left.names[li]}:{lt} "
                             f"vs {right.names[ri]}:{rt} (cast the keys to a "
                             "common type)")
    return cfg


def _stamp_join_partitioning(out: Table, left: Table, right: Table,
                             cfg: JoinConfig) -> None:
    """Record the shuffled join's output placement as ``_partitioning``
    (``cylon_tpu/table.py:1205``): which side's key names stay valid
    hash alternatives (INNER both, LEFT left, RIGHT right, FULL_OUTER
    neither) is the planner's single rule,
    ``optimizer.join_partition_alternatives``."""
    from .plan.optimizer import join_partition_alternatives

    alts = join_partition_alternatives(
        _HOW_NAMES[cfg.join_type], left.names, right.names,
        [left.names[i] for i in cfg.left_on],
        [right.names[i] for i in cfg.right_on],
        cfg.left_prefix, cfg.right_prefix)
    if alts:
        out._partitioning = ("hash", alts, left.num_shards)


def _join_output_names(left: Table, right: Table,
                       cfg: JoinConfig) -> Tuple[str, ...]:
    """left names ++ right names, prefixing collisions."""
    both = set(left.names) & set(right.names)
    return tuple([cfg.left_prefix + n if n in both else n
                  for n in left.names]
                 + [cfg.right_prefix + n if n in both else n
                    for n in right.names])


def _local_join(left: Table, right: Table, cfg: JoinConfig) -> Table:
    """Shard-by-shard join with the exact two-pass sizing: every shard's
    output count, ``cap_round`` of the largest (over every process), one
    gather per shard at that common capacity."""
    pairs = list(zip(left.shards, left.counts, right.shards, right.counts))
    with obs_spans.span("join.count"):
        counts = [join_mod.join_row_count(a, ca, b, cb, cfg.left_on,
                                          cfg.right_on, cfg.join_type,
                                          cfg.algorithm)
                  for a, ca, b, cb in pairs]
        most = max(int(c) for c in counts)
        if left.ctx.group is not None:  # one capacity on every process
            most = int(collectives.process_allgather(
                np.array([most], np.int64), left.ctx.group).max())
    out_cap = cap_round(max(1, most))
    shards, out_counts = [], []
    with obs_spans.span("join.gather"):
        for a, ca, b, cb in pairs:
            cols, m = join_mod.join_gather(a, ca, b, cb, cfg.left_on,
                                           cfg.right_on, cfg.join_type,
                                           out_cap, cfg.algorithm)
            shards.append(cols)
            out_counts.append(m)
    return left._like(shards, out_counts,
                      _join_output_names(left, right, cfg))


def _local_groupby(t: Table, by_idx: Tuple[int, ...],
                   aggs: Tuple[Tuple[int, AggOp], ...], ddof: int,
                   pipeline: bool = False) -> Table:
    local = (groupby_mod.pipeline_groupby if pipeline
             else groupby_mod.hash_groupby)
    out = _shard_wise(lambda cols, n: local(cols, n, by_idx, aggs, ddof), t)
    return out._like(out.shards, out.counts,
                     _groupby_output_names(t, by_idx, aggs))


def _groupby_output_names(t: Table, by_idx, aggs) -> Tuple[str, ...]:
    return tuple([t.names[i] for i in by_idx]
                 + [f"{AggOp(op).name.lower()}_{t.names[ci]}"
                    for ci, op in aggs])
